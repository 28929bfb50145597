// The benchmark's frozen LZ4 block compressor and xxHash32.
//
// It makes the decode cells' inputs, so they stay the same bytes whatever the
// port's own encoder does. A plain greedy LZ4 block compressor (one 4-byte
// hash probe a position, as liblz4's fast mode), written for this benchmark
// and never changed: changing it changes every decode cell's input.
// Built with g++ (-pthread) at first use into portbench/.cache/ (see gen/frozen.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;   // the last 5 bytes of a block are literals
constexpr int kMfLimit = 12;       // no match starts in the last 12 bytes
constexpr int kHashLog = 16;
constexpr int64_t kMaxOffset = 65535;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

inline uint8_t* put_len(uint8_t* op, int64_t n) {
    while (n >= 255) {
        *op++ = 255;
        n -= 255;
    }
    *op++ = static_cast<uint8_t>(n);
    return op;
}

inline uint8_t* put_sequence(uint8_t* op, const uint8_t* lit, int64_t nlit, int64_t off,
                             int64_t mlen) {
    uint8_t* token = op++;
    int64_t ml = mlen - kMinMatch;
    *token = static_cast<uint8_t>(((nlit < 15 ? nlit : 15) << 4) | (ml < 15 ? ml : 15));
    if (nlit >= 15) op = put_len(op, nlit - 15);
    std::memcpy(op, lit, static_cast<size_t>(nlit));
    op += nlit;
    *op++ = static_cast<uint8_t>(off & 0xFF);
    *op++ = static_cast<uint8_t>(off >> 8);
    if (ml >= 15) op = put_len(op, ml - 15);
    return op;
}

}  // namespace

extern "C" {

// Compress src[start:total) into dst as one LZ4 block; matches may reach
// back to src[0] (a dictionary of `start` bytes, for linked blocks; 0 for an
// independent block) within 65535 bytes. dst holds at least
// total - start + (total - start) / 255 + 16 bytes. Returns the block length.
int64_t pb_compress_block(const uint8_t* src, int64_t start, int64_t total, uint8_t* dst) {
    std::vector<int64_t> table(size_t(1) << kHashLog, -1);
    uint8_t* op = dst;
    int64_t anchor = start;
    const int64_t n = total - start;
    if (n >= kMfLimit + 1) {
        for (int64_t p = (start > kMaxOffset ? start - kMaxOffset : 0); p + 4 <= start; ++p)
            table[hash4(read32(src + p))] = p;
        const int64_t match_start_limit = total - kMfLimit;   // a match starts before this
        const int64_t match_end_limit = total - kLastLiterals;
        int64_t ip = start;
        int64_t misses = 0;
        while (ip < match_start_limit) {
            const uint32_t v = read32(src + ip);
            const uint32_t h = hash4(v);
            const int64_t ref = table[h];
            table[h] = ip;
            if (ref < 0 || ip - ref > kMaxOffset || read32(src + ref) != v) {
                ip += 1 + (misses++ >> 6);
                continue;
            }
            misses = 0;
            int64_t m = ip, r = ref;
            while (m > anchor && r > 0 && src[m - 1] == src[r - 1]) {
                --m;
                --r;
            }
            int64_t len = ip - m + kMinMatch;
            while (m + len < match_end_limit && src[m + len] == src[r + len]) ++len;
            op = put_sequence(op, src + anchor, m - anchor, m - r, len);
            ip = m + len;
            anchor = ip;
            if (ip - 2 >= start && ip - 2 + 4 <= total) table[hash4(read32(src + ip - 2))] = ip - 2;
        }
    }
    const int64_t nlit = total - anchor;
    *op++ = static_cast<uint8_t>((nlit < 15 ? nlit : 15) << 4);
    if (nlit >= 15) op = put_len(op, nlit - 15);
    std::memcpy(op, src + anchor, static_cast<size_t>(nlit));
    op += nlit;
    return op - dst;
}

// Compress n independent blocks src[start[i] : start[i] + len[i]) on up to
// nthreads threads, block i into dst + dst_off[i] (room for its bound);
// out_len[i] gets its length.
void pb_compress_blocks(const uint8_t* src, const int64_t* start, const int64_t* len, int64_t n,
                        uint8_t* dst, const int64_t* dst_off, int64_t* out_len, int nthreads) {
    auto work = [&](int t) {
        for (int64_t i = t; i < n; i += nthreads)
            out_len[i] = pb_compress_block(src + start[i], 0, len[i], dst + dst_off[i]);
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < nthreads; ++t) pool.emplace_back(work, t);
    work(0);
    for (auto& th : pool) th.join();
}

uint32_t pb_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
    const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u, P4 = 668265263u,
                   P5 = 374761393u;
    auto rotl = [](uint32_t x, int r) { return (x << r) | (x >> (32 - r)); };
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* limit = end - 16;
        do {
            v1 = rotl(v1 + read32(p) * P2, 13) * P1;
            v2 = rotl(v2 + read32(p + 4) * P2, 13) * P1;
            v3 = rotl(v3 + read32(p + 8) * P2, 13) * P1;
            v4 = rotl(v4 + read32(p + 12) * P2, 13) * P1;
            p += 16;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    } else {
        h = seed + P5;
    }
    h += static_cast<uint32_t>(len);
    while (p + 4 <= end) {
        h = rotl(h + read32(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl(h + (*p) * P5, 11) * P1;
        ++p;
    }
    h ^= h >> 15;
    h *= P2;
    h ^= h >> 13;
    h *= P3;
    h ^= h >> 16;
    return h;
}

}  // extern "C"
