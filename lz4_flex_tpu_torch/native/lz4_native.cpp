// Native host runtime for the TPU-native LZ4 framework.
//
// Plays the role the reference implementation's Rust hot loops play on the
// host side (capability parity with lz4_flex src/block/{compress,decompress*}.rs):
// a greedy hash-table block encoder, a token-walk block decoder, xxHash32, and
// a sequence-table parser that feeds the TPU decode kernels. All functions are
// exposed through a C ABI consumed via ctypes.
//
// Attribution: tlz4_compress_block below intentionally mirrors the canonical
// greedy LZ4 match-search structure — skip-accelerated probe loop, hash-table
// insert/probe order, backward extension, the cur-2 re-insert — as found in
// upstream lz4 C and in the reference (lz4_flex src/block/compress.rs:318-489,
// src/block/hashtable.rs), including the standard hash constants. It exists as
// the host-side ORACLE and fallback that the TPU encode paths are verified
// against, so structural fidelity to the canonical algorithm is the point; the
// TPU-native encoders (ops/encode.py: exact sort-based candidate search,
// jump-graph greedy, device emission) are original designs. Everything else in
// this file (token-walk decoders, the ring-plan builder, the hybrid walk) is
// implemented from the public LZ4 block format spec
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdio>
#include <sys/mman.h>
#include <cstdlib>
#include <chrono>

#define TLZ4_API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Format constants (see lz4_flex_tpu/spec/constants.py)
// ---------------------------------------------------------------------------
constexpr size_t WINDOW_SIZE = 64 * 1024;
constexpr size_t MFLIMIT = 12;
constexpr size_t END_OFFSET = 6;
constexpr size_t LZ4_MIN_LENGTH = 13;
constexpr size_t MAX_DISTANCE = 65535;
constexpr size_t MINMATCH = 4;
constexpr size_t TABLE_SIZE = 4096;
constexpr unsigned STEP_SHIFT = 5;

inline uint16_t load16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

// 4-byte Knuth multiplicative hash -> 12-bit table slot.
inline size_t hash4_at(const uint8_t* p) {
    return ((load32(p) * 2654435761u) >> 16) >> 4;
}
// 5-byte hash -> 12-bit table slot (used whenever positions may exceed u16).
inline size_t hash5_at(const uint8_t* p) {
    return (((load64(p) << 24) * 889523592379ULL) >> 48) >> 4;
}
inline size_t hash_at(const uint8_t* p, int use_hash5) {
    return use_hash5 ? hash5_at(p) : hash4_at(p);
}

// Number of leading equal bytes between a and b, at most `limit`.
inline size_t common_prefix(const uint8_t* a, const uint8_t* b, size_t limit) {
    size_t n = 0;
    while (n + 8 <= limit) {
        uint64_t diff = load64(a + n) ^ load64(b + n);
        if (diff) return n + (__builtin_ctzll(diff) >> 3);
        n += 8;
    }
    while (n < limit && a[n] == b[n]) n++;
    return n;
}

struct ByteWriter {
    uint8_t* out;
    size_t pos;
    size_t cap;
    inline void byte(uint8_t b) { out[pos++] = b; }
    inline void u16le(uint16_t v) { store16(out + pos, v); pos += 2; }
    // LSIC length extension: 0xFF bytes followed by the remainder.
    inline void lsic(size_t n) {
        while (n >= 0xFF) { out[pos++] = 0xFF; n -= 0xFF; }
        out[pos++] = (uint8_t)n;
    }
};

inline void emit_last_literals(ByteWriter& w, const uint8_t* input, size_t start, size_t len) {
    size_t lit = len - start;
    w.byte(lit >= 0xF ? 0xF0 : (uint8_t)(lit << 4));
    if (lit >= 0xF) w.lsic(lit - 0xF);
    std::memcpy(w.out + w.pos, input + start, lit);
    w.pos += lit;
}

} // namespace

// ---------------------------------------------------------------------------
// Compression
// ---------------------------------------------------------------------------

TLZ4_API int64_t tlz4_compress_bound(int64_t n) {
    return 16 + 4 + (n * 110) / 100;
}

// Seed a hash table from a dictionary with a 3-byte stride.
TLZ4_API void tlz4_init_dict_table(uint64_t* table, const uint8_t* dict,
                                   size_t dict_len, int use_hash5) {
    for (size_t i = 0; i + 8 <= dict_len; i += 3) {
        table[hash_at(dict + i, use_hash5)] = i;
    }
}

// Greedy LZ4 block encode of input[input_pos..input_len).
//
// input[..input_pos) is a same-buffer prefix available for lookback; ext_dict
// logically precedes input; stream_offset is the logical stream position of
// input[0] (>= ext_dict_len). `table` holds 4096 logical stream positions and
// may be carried across calls (linked blocks). Returns bytes written or -1 if
// out_cap < tlz4_compress_bound(input_len - input_pos).
TLZ4_API int64_t tlz4_compress_block(
    const uint8_t* input, size_t input_len, size_t input_pos,
    uint8_t* out, size_t out_cap,
    const uint8_t* ext_dict, size_t ext_dict_len,
    uint64_t stream_offset,
    uint64_t* table, int use_hash5)
{
    if (out_cap < (size_t)tlz4_compress_bound((int64_t)(input_len - input_pos))) return -1;
    ByteWriter w{out, 0, out_cap};

    if (input_len - input_pos < LZ4_MIN_LENGTH) {
        emit_last_literals(w, input, input_pos, input_len);
        return (int64_t)w.pos;
    }

    const uint64_t ext_dict_stream_offset = stream_offset - ext_dict_len;
    const size_t end_pos_check = input_len - MFLIMIT;
    size_t literal_start = input_pos;
    size_t cur = input_pos;

    if (cur == 0 && stream_offset == 0) {
        // A block with no history cannot start with a match.
        table[hash_at(input, use_hash5)] = 0;
        cur = 1;
    }

    for (;;) {
        size_t non_match_count = 1u << STEP_SHIFT;
        size_t next_cur = cur;
        const uint8_t* source;
        size_t cand;
        uint16_t offset;

        // Probe loop with skip acceleration.
        for (;;) {
            size_t step = non_match_count >> STEP_SHIFT;
            non_match_count++;
            cur = next_cur;
            next_cur += step;
            if (cur > end_pos_check) {
                emit_last_literals(w, input, literal_start, input_len);
                return (int64_t)w.pos;
            }
            size_t h = hash_at(input + cur, use_hash5);
            uint64_t candidate = table[h];
            table[h] = cur + stream_offset;
            if (stream_offset + cur - candidate > MAX_DISTANCE) continue;
            if (candidate >= stream_offset) {
                offset = (uint16_t)(stream_offset + cur - candidate);
                cand = (size_t)(candidate - stream_offset);
                source = input;
            } else if (ext_dict_len != 0) {
                if (candidate < ext_dict_stream_offset) continue; // history lost
                offset = (uint16_t)(stream_offset + cur - candidate);
                cand = (size_t)(candidate - ext_dict_stream_offset);
                source = ext_dict;
            } else {
                continue;
            }
            if (load32(source + cand) == load32(input + cur)) break;
        }

        // Extend the match backwards over pending literals.
        while (cand > 0 && cur > literal_start && input[cur - 1] == source[cand - 1]) {
            cur--; cand--;
        }

        size_t lit_len = cur - literal_start;
        cur += MINMATCH;
        cand += MINMATCH;
        size_t source_len = (source == input) ? input_len : ext_dict_len;
        size_t max_in = input_len - END_OFFSET - cur; // cur <= len-8 here
        size_t max_cand = source_len - cand;
        size_t dup_len = common_prefix(input + cur, source + cand,
                                       max_in < max_cand ? max_in : max_cand);
        cur += dup_len;
        {
            size_t h = hash_at(input + cur - 2, use_hash5);
            table[h] = cur - 2 + stream_offset;
        }

        uint8_t token = (lit_len >= 0xF ? 0xF0 : (uint8_t)(lit_len << 4))
                      | (dup_len >= 0xF ? 0xF : (uint8_t)dup_len);
        w.byte(token);
        if (lit_len >= 0xF) w.lsic(lit_len - 0xF);
        std::memcpy(w.out + w.pos, input + literal_start, lit_len);
        w.pos += lit_len;
        w.u16le(offset);
        if (dup_len >= 0xF) w.lsic(dup_len - 0xF);
        literal_start = cur;
    }
}

// ---------------------------------------------------------------------------
// Decompression
// ---------------------------------------------------------------------------

// Error codes (mirror the DecompressError taxonomy).
enum : int64_t {
    TLZ4_ERR_OUTPUT_TOO_SMALL      = -1,
    TLZ4_ERR_LITERAL_OOB           = -2,
    TLZ4_ERR_EXPECTED_ANOTHER_BYTE = -3,
    TLZ4_ERR_OFFSET_ZERO           = -4,
    TLZ4_ERR_OFFSET_OOB            = -5,
    TLZ4_ERR_VERIFY_MISMATCH       = -6,
};

// Copy `len` bytes from out[dpos-offset..] to out[dpos..], allowing overlap
// with LZ4 semantics (source re-reads bytes this copy produced).
static inline void overlap_copy(uint8_t* out, size_t dpos, size_t offset, size_t len) {
    uint8_t* dst = out + dpos;
    const uint8_t* src = dst - offset;
    if (offset == 1) {
        std::memset(dst, src[0], len);
        return;
    }
    // Doubling runs: each memcpy of `run` bytes is non-overlapping
    // (dst - src == run) and doubles the usable source period.
    size_t run = offset;
    while (len > run) {
        std::memcpy(dst, src, run);
        dst += run;
        len -= run;
        run *= 2;
    }
    std::memcpy(dst, src, len);
}

// Match that starts in the external dictionary (offset > out_pos) and may
// cross into out. Returns new out_pos or a negative error code.
static inline int64_t dict_match_copy(
    uint8_t* out, size_t out_pos, size_t out_cap,
    const uint8_t* ext_dict, size_t ext_dict_len,
    size_t offset, size_t match_len, uint64_t* expected_out)
{
    size_t back = offset - out_pos;
    if (back > ext_dict_len) return TLZ4_ERR_OFFSET_OOB;
    if (match_len > out_cap - out_pos) {
        *expected_out = out_pos + match_len;
        return TLZ4_ERR_OUTPUT_TOO_SMALL;
    }
    size_t dict_off = ext_dict_len - back;
    size_t take = back < match_len ? back : match_len;
    std::memcpy(out + out_pos, ext_dict + dict_off, take);
    out_pos += take;
    match_len -= take;
    if (match_len > 0) {
        // Remainder continues from the start of out (offset == out_pos here).
        overlap_copy(out, out_pos, offset, match_len);
        out_pos += match_len;
    }
    return (int64_t)out_pos;
}

// Token-walk decode of one LZ4 block.
//
// out[..out_pos) is already-produced output (linked-block prefix) that matches
// may reference; ext_dict logically precedes it. Returns bytes appended, or a
// negative error code. For TLZ4_ERR_OUTPUT_TOO_SMALL, *expected_out gets the
// required size.
TLZ4_API int64_t tlz4_decompress_block(
    const uint8_t* input, size_t input_len,
    uint8_t* out, size_t out_pos, size_t out_cap,
    const uint8_t* ext_dict, size_t ext_dict_len,
    uint64_t* expected_out)
{
    size_t ip = 0;
    const size_t start_pos = out_pos;
    // Fast path is valid while we can wild-copy 16 literal bytes / 18+16 match
    // bytes and still re-read the offset word.
    const size_t in_fast = input_len >= 18 ? input_len - 18 : 0;
    const size_t out_fast = out_cap >= 34 ? out_cap - 34 : 0;

    for (;;) {
        if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        uint8_t token = input[ip++];
        size_t lit_len = token >> 4;
        size_t match_len = token & 0xF;

        if (lit_len <= 14 && match_len <= 14 && ip <= in_fast && out_pos < out_fast) {
            // Hot path: short literal run + short match, far from both ends.
            std::memcpy(out + out_pos, input + ip, 16);
            out_pos += lit_len;
            ip += lit_len;
            size_t offset = load16(input + ip);
            ip += 2;
            match_len += MINMATCH;
            if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
            if (offset <= out_pos) {
                if (offset >= 18) {
                    std::memcpy(out + out_pos, out + out_pos - offset, 18);
                    out_pos += match_len;
                    continue;
                }
                overlap_copy(out, out_pos, offset, match_len);
                out_pos += match_len;
                continue;
            }
            int64_t r = dict_match_copy(out, out_pos, out_cap, ext_dict, ext_dict_len,
                                        offset, match_len, expected_out);
            if (r < 0) return r;
            out_pos = (size_t)r;
            continue;
        }

        // Cold path: LSIC extensions and end-of-buffer care.
        if (lit_len == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                lit_len += b;
                if (b != 0xFF) break;
            }
        }
        if (lit_len > input_len - ip) return TLZ4_ERR_LITERAL_OOB;
        if (lit_len > out_cap - out_pos) {
            *expected_out = out_pos + lit_len;
            return TLZ4_ERR_OUTPUT_TOO_SMALL;
        }
        std::memcpy(out + out_pos, input + ip, lit_len);
        out_pos += lit_len;
        ip += lit_len;

        if (ip >= input_len) break; // final literal-only sequence

        {
            if (input_len - ip < 2) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
            size_t offset = load16(input + ip);
            ip += 2;
            if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
            match_len = (token & 0xF);
            if (match_len == 0xF) {
                for (;;) {
                    if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                    uint8_t b = input[ip++];
                    match_len += b;
                    if (b != 0xFF) break;
                }
            }
            match_len += MINMATCH;
            if (match_len > out_cap - out_pos) {
                *expected_out = out_pos + match_len;
                return TLZ4_ERR_OUTPUT_TOO_SMALL;
            }
            if (offset <= out_pos) {
                if (offset >= match_len) {
                    std::memmove(out + out_pos, out + out_pos - offset, match_len);
                } else {
                    overlap_copy(out, out_pos, offset, match_len);
                }
                out_pos += match_len;
                continue;
            }
            int64_t r = dict_match_copy(out, out_pos, out_cap, ext_dict, ext_dict_len,
                                        offset, match_len, expected_out);
            if (r < 0) return r;
            out_pos = (size_t)r;
        }
    }
    return (int64_t)(out_pos - start_pos);
}

// Size-only token walk: returns the decoded size of one block (or a
// negative error). The cheap form of tlz4_parse_sequences for callers that
// only need total_out (ring-plan staging, batched dispatch) — it reads
// only token and LSIC bytes (~n/13 of the stream) and skips literal runs,
// so it costs ~0.1 ms where the full parse costs ~1.5 (measured, 2 MiB of
// payloads). Validation is structural only; the plan build re-walks and
// validates positions.
TLZ4_API int64_t tlz4_measure_block(const uint8_t* input, size_t input_len)
{
    size_t ip = 0;
    int64_t out = 0;
    if (input_len == 0) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
    for (;;) {
        if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        uint8_t token = input[ip++];
        size_t lit_len = token >> 4;
        if (lit_len == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                lit_len += b;
                if (b != 0xFF) break;
            }
        }
        if (lit_len > input_len - ip) return TLZ4_ERR_LITERAL_OOB;
        out += (int64_t)lit_len;
        ip += lit_len;
        if (ip >= input_len) break; // final literal-only sequence
        if (input_len - ip < 2) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        size_t offset = load16(input + ip);
        ip += 2;
        if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
        size_t match_len = token & 0xF;
        if (match_len == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                match_len += b;
                if (b != 0xFF) break;
            }
        }
        out += (int64_t)(match_len + MINMATCH);
    }
    return out;
}

// Verify decode(input, ext_dict) == ref WITHOUT materializing the output:
// one token-walk pass comparing literal bytes against ref and each match's
// source span against its target span inside ref. Sound because a verified
// output prefix equals ref byte-for-byte, so the decoder's self-referential
// reads (out[op-offset+i], which may include bytes this same match wrote)
// reduce by induction to ref[op-offset+i] == ref[op+i] — exactly what the
// memcmp checks, overlap included. This is the collision guard for the
// device encoders' fingerprinted LCP stage (ops/encode.py: a fingerprint
// collision can only emit an overlong match, which lands here as a byte
// mismatch). ~2 sequential reads per output byte, zero writes — an order of
// magnitude cheaper than decode-then-compare, and the reference's
// always-valid-output contract (/root/reference/src/block/compress.rs:318)
// holds for every device encode path at this reduced cost.
TLZ4_API int64_t tlz4_verify_block(
    const uint8_t* input, size_t input_len,
    const uint8_t* ref, size_t ref_len,
    const uint8_t* ext_dict, size_t ext_dict_len)
{
    size_t ip = 0, op = 0;
    if (input_len == 0) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
    for (;;) {
        if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        uint8_t token = input[ip++];
        size_t lit_len = token >> 4;
        if (lit_len == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                lit_len += b;
                if (b != 0xFF) break;
            }
        }
        if (lit_len > input_len - ip) return TLZ4_ERR_LITERAL_OOB;
        if (lit_len > ref_len - op) return TLZ4_ERR_VERIFY_MISMATCH;
        if (std::memcmp(input + ip, ref + op, lit_len) != 0)
            return TLZ4_ERR_VERIFY_MISMATCH;
        op += lit_len;
        ip += lit_len;

        if (ip >= input_len) break; // final literal-only sequence

        if (input_len - ip < 2) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        size_t offset = load16(input + ip);
        ip += 2;
        if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
        size_t match_len = token & 0xF;
        if (match_len == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                match_len += b;
                if (b != 0xFF) break;
            }
        }
        match_len += MINMATCH;
        if (match_len > ref_len - op) return TLZ4_ERR_VERIFY_MISMATCH;
        if (offset <= op) {
            if (std::memcmp(ref + op - offset, ref + op, match_len) != 0)
                return TLZ4_ERR_VERIFY_MISMATCH;
            op += match_len;
        } else {
            size_t back = offset - op;
            if (back > ext_dict_len) return TLZ4_ERR_OFFSET_OOB;
            size_t take = back < match_len ? back : match_len;
            if (std::memcmp(ext_dict + ext_dict_len - back, ref + op, take) != 0)
                return TLZ4_ERR_VERIFY_MISMATCH;
            op += take;
            match_len -= take;
            if (match_len) {
                // remainder continues from the start of out (= ref[0..])
                if (std::memcmp(ref, ref + op, match_len) != 0)
                    return TLZ4_ERR_VERIFY_MISMATCH;
                op += match_len;
            }
        }
    }
    return op == ref_len ? (int64_t)op : TLZ4_ERR_VERIFY_MISMATCH;
}

// ---------------------------------------------------------------------------
// Sequence-table parser (host side of the TPU decode pipeline)
// ---------------------------------------------------------------------------

// Parse a block into fixed-width sequence records for device expansion:
// sequence i copies lit_len[i] literals from input[lit_start[i]..], then a
// match of match_len[i] bytes at distance match_off[i] (0 for the final
// literal-only record). out_off[i] is the uncompressed position where the
// sequence's output begins. Returns the record count, or a negative error.
// *total_out receives the total uncompressed size.
TLZ4_API int64_t tlz4_parse_sequences(
    const uint8_t* input, size_t input_len,
    int32_t* lit_start, int32_t* lit_len,
    int32_t* match_off, int32_t* match_len, int32_t* out_off,
    int64_t max_seqs, int64_t* total_out)
{
    size_t ip = 0;
    int64_t nseq = 0;
    int64_t opos = 0;
    for (;;) {
        if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        uint8_t token = input[ip++];
        size_t ll = token >> 4;
        if (ll == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                ll += b;
                if (b != 0xFF) break;
            }
        }
        if (ll > input_len - ip) return TLZ4_ERR_LITERAL_OOB;
        if (nseq >= max_seqs) return TLZ4_ERR_OUTPUT_TOO_SMALL;
        lit_start[nseq] = (int32_t)ip;
        lit_len[nseq] = (int32_t)ll;
        out_off[nseq] = (int32_t)opos;
        ip += ll;
        opos += (int64_t)ll;

        if (ip >= input_len) {
            match_off[nseq] = 0;
            match_len[nseq] = 0;
            nseq++;
            break;
        }
        if (input_len - ip < 2) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
        size_t offset = load16(input + ip);
        ip += 2;
        if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
        size_t ml = token & 0xF;
        if (ml == 0xF) {
            for (;;) {
                if (ip >= input_len) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                uint8_t b = input[ip++];
                ml += b;
                if (b != 0xFF) break;
            }
        }
        ml += MINMATCH;
        match_off[nseq] = (int32_t)offset;
        match_len[nseq] = (int32_t)ml;
        nseq++;
        opos += (int64_t)ml;
    }
    *total_out = opos;
    return nseq;
}

// ---------------------------------------------------------------------------
// xxHash32
// ---------------------------------------------------------------------------

namespace {
constexpr uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                   P4 = 668265263u, P5 = 374761393u;
inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
inline uint32_t xxh_round(uint32_t acc, uint32_t lane) {
    return rotl32(acc + lane * P2, 13) * P1;
}
inline uint32_t xxh_finalize(uint32_t h, const uint8_t* p, size_t n) {
    while (n >= 4) { h = rotl32(h + load32(p) * P3, 17) * P4; p += 4; n -= 4; }
    while (n > 0)  { h = rotl32(h + (*p) * P5, 11) * P1; p++; n--; }
    h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
    return h;
}
} // namespace

TLZ4_API uint32_t tlz4_xxh32(const uint8_t* data, size_t len, uint32_t seed) {
    const uint8_t* p = data;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* end = data + (len & ~(size_t)15);
        do {
            v1 = xxh_round(v1, load32(p));      v2 = xxh_round(v2, load32(p + 4));
            v3 = xxh_round(v3, load32(p + 8));  v4 = xxh_round(v4, load32(p + 12));
            p += 16;
        } while (p != end);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    return xxh_finalize(h, p, len & 15);
}

// Streaming state layout: [v1, v2, v3, v4, total_lo, total_hi, memsize, mem x4]
TLZ4_API void tlz4_xxh32_reset(uint32_t* s, uint32_t seed) {
    s[0] = seed + P1 + P2; s[1] = seed + P2; s[2] = seed; s[3] = seed - P1;
    s[4] = s[5] = s[6] = 0;
    std::memset(s + 7, 0, 16);
}

TLZ4_API void tlz4_xxh32_update(uint32_t* s, const uint8_t* data, size_t len) {
    uint64_t total = ((uint64_t)s[5] << 32 | s[4]) + len;
    s[4] = (uint32_t)total; s[5] = (uint32_t)(total >> 32);
    uint8_t* mem = (uint8_t*)(s + 7);
    size_t memsize = s[6];
    if (memsize + len < 16) {
        std::memcpy(mem + memsize, data, len);
        s[6] = (uint32_t)(memsize + len);
        return;
    }
    if (memsize) {
        size_t fill = 16 - memsize;
        std::memcpy(mem + memsize, data, fill);
        s[0] = xxh_round(s[0], load32(mem));      s[1] = xxh_round(s[1], load32(mem + 4));
        s[2] = xxh_round(s[2], load32(mem + 8));  s[3] = xxh_round(s[3], load32(mem + 12));
        data += fill; len -= fill;
    }
    uint32_t v1 = s[0], v2 = s[1], v3 = s[2], v4 = s[3];
    while (len >= 16) {
        v1 = xxh_round(v1, load32(data));      v2 = xxh_round(v2, load32(data + 4));
        v3 = xxh_round(v3, load32(data + 8));  v4 = xxh_round(v4, load32(data + 12));
        data += 16; len -= 16;
    }
    s[0] = v1; s[1] = v2; s[2] = v3; s[3] = v4;
    std::memcpy(mem, data, len);
    s[6] = (uint32_t)len;
}

TLZ4_API uint32_t tlz4_xxh32_digest(const uint32_t* s) {
    uint64_t total = (uint64_t)s[5] << 32 | s[4];
    uint32_t h;
    if (total >= 16) {
        h = rotl32(s[0], 1) + rotl32(s[1], 7) + rotl32(s[2], 12) + rotl32(s[3], 18);
    } else {
        h = s[2] /* == seed */ + P5;
    }
    h += (uint32_t)total;
    return xxh_finalize(h, (const uint8_t*)(s + 7), s[6]);
}

// ---------------------------------------------------------------------------
// Ring-plan builder for the Pallas ring decoder (ops/ringdecode.py)
// ---------------------------------------------------------------------------
//
// Splits a block's — or a whole multi-block frame body's — sequences (the
// same walk as tlz4_parse_sequences, reference token loop
// /root/reference/src/block/decompress.rs:201-444) into per-(tile,
// output-row, plane) fragment records that the TPU kernel fires as one-hot
// MXU row pulls over a single VMEM table. Output is processed in tiles of
// `tile_rows` 128-byte rows. The kernel's table per tile t is:
//
//   rows [0, WR)            ring: output rows [t*TR - WR, t*TR)
//   rows [WR, WR+TR)        the tile being decoded (updated in place)
//   rows [WR+TR, WR+TR+2*LW) literal window: comp rows
//                            [litblk[t]*LW, litblk[t]*LW + 2*LW)
//
// Kernel semantics per record (table-local byte address S):
//
//   out lane l (lo <= l < lo+len) of the record's row = table[S + (l+ph) % P]
//
// P < 128 implements self-overlapping (RLE) matches with no record
// splitting (reference overlap handling:
// /root/reference/src/block/decompress.rs:286-315, fastcpy_unsafe.rs:64-90).
// Literal records read the literal-window region; match records read the
// ring/tile region.
//
// Plane packing is depth-grouped: depth(record) = 0 for literals and for
// matches whose sources all precede the tile, else 1 + max depth over
// in-tile source bytes. Planes are ordered by depth, so the kernel fires
// plane j = 0 .. nslots[t]-1 IN ORDER with in-place table updates and needs
// no other schedule: every record's sources are strictly shallower, hence
// already final when it fires. Plane count per tile = sum over d of the
// max per-row record count at depth d.
//
// Packing:  plane_src  = S | ph << 18                    (S < 2^18, ph < 128)
//           plane_meta = lo | (len-1) << 7 | (P-1) << 14 | 1 << 21
//                                                        (meta 0 == empty)
//
// The builder runs in two passes. Pass 1 (serial) walks every block's token
// stream into a global sequence table, validating offsets against the block
// mode: linked blocks may reach any earlier frame output (the 64 KiB
// MAX_DISTANCE keeps them inside the kernel ring by construction),
// independent blocks only their own output
// (/root/reference/src/frame/decompress.rs:282-306); stored blocks become
// literal-only pseudo-sequences. Pass 2 builds tiles CONCURRENTLY: the
// per-byte depth recurrence and the sparse piece index read only sources
// at/after the tile start (earlier sources resolve to ring records), so
// tiles share nothing and a small thread pool scales the build with cores.
//
// The lazy per-piece origin chase performs tile-local partial chain
// resolution so typical depths collapse to 0-2; deep fragmented pieces fall
// back to raw ring records with the depth machinery.
//
// Returns nseq, a parse error (TLZ4_ERR_*), or a TLZ4_PLAN_* overflow code
// when the static plan shape cannot hold the input (caller falls back to
// the XLA expansion kernels).

#include <vector>
#include <deque>
#include <algorithm>
#include <atomic>
#include <thread>
#include <mutex>
#include <functional>
#include <climits>
#include <unistd.h>
#include <sys/syscall.h>
#include <linux/futex.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#define TLZ4_PLAN_OVERFLOW (-100)
#define TLZ4_PLAN_OVF_SLOT (-102)
#define TLZ4_PLAN_OVF_LITSPAN (-103)
#define TLZ4_PLAN_OVF_DEPTH   (-104)

// The per-piece emit path runs ~2M calls per 10 MB plan; at -O3 g++ still
// outlines ring_emit_plain/ring_emit_match/ring_push (gprof: ~36% of the
// single-thread build in call-crossed frames), so the hot chain is forced
// inline.
#define TLZ4_HOT __attribute__((always_inline))

namespace {
constexpr int32_t RING_MAX_DEPTH = 250;  // depth[] is uint8

// Persistent worker pool. A plan build runs three parallel phases (walks,
// assembly, tiles) and pipelined decode builds one plan per buffer;
// spawning + joining an 8-thread std::thread pool costs ~0.4 ms per phase
// on the virtualized dev host (~1.2 ms/plan of pure overhead). Workers are
// detached and parked on a FUTEX for the process lifetime — NOT a
// std::condition_variable: this image's glibc (2.36) carries the notorious
// pthread_cond lost-wakeup bug (BZ 25847, fixed in 2.41), reproduced here
// hanging a caller in a predicate-true cv wait after ~50k run() cycles.
// The raw futex has no such window: FUTEX_WAIT compares the generation
// word against the expected value inside the kernel, so a wake between the
// user-space check and the sleep turns the sleep into an immediate return.
// One job runs at a time (job_mu): concurrent builder calls' phases
// serialize, which on a 4-core host beats oversubscribing each other
// anyway. Work functions must be internally work-stealing (they receive no
// lane id); surplus workers simply find the work queue drained and finish.
struct WorkPool {
    std::mutex job_mu;  // serializes run() callers
    std::atomic<uint32_t> gen{0};  // job generation; the futex word
    std::atomic<int> active{0};    // workers still inside the current job
    std::atomic<int> lanes{0};     // job tickets left (bounds participation)
    const std::function<void()>* job = nullptr;
    int nworkers = 0;
    pid_t owner = 0;

    static void futex_wait(std::atomic<uint32_t>* w, uint32_t expect) {
        syscall(SYS_futex, (uint32_t*)w, FUTEX_WAIT_PRIVATE, expect,
                nullptr, nullptr, 0);
    }
    static void futex_wake_all(std::atomic<uint32_t>* w) {
        syscall(SYS_futex, (uint32_t*)w, FUTEX_WAKE_PRIVATE, INT_MAX,
                nullptr, nullptr, 0);
    }

    // `seen` is the generation at spawn time, read by the spawner under
    // job_mu (gen only changes inside run(), which also holds job_mu).
    // A worker can never lag a full generation: run() returns only after
    // every worker decremented `active`, so every worker runs every job.
    void worker(uint32_t seen) {
        for (;;) {
            uint32_t g;
            while ((g = gen.load(std::memory_order_acquire)) == seen)
                futex_wait(&gen, seen);
            seen = g;
            // Ticket gate: the futex wake reaches EVERY parked worker, but a
            // job that asked for nth lanes must not run on more — beyond the
            // core count the extra lanes only thrash (measured +2 ms on the
            // 10 MB plan at 8 lanes on 4 cores). Surplus workers skip the
            // job; they still decrement active so run() can join.
            if (lanes.fetch_sub(1, std::memory_order_acq_rel) > 0)
                (*job)();  // job write is ordered before the gen bump
            active.fetch_sub(1, std::memory_order_release);
        }
    }

    // Run fn on up to `nth` lanes: min(nth-1, grown pool) detached workers
    // plus the calling thread. Returns after every participant finished.
    // The caller spin-yields on `active` instead of sleeping: it just did
    // its own share of the job, so the worker tails are microseconds away.
    void run(int nth, const std::function<void()>& fn) {
        if (nth <= 1) { fn(); return; }
        std::lock_guard<std::mutex> jl(job_mu);
        if (owner != getpid()) {  // post-fork child: parent's threads gone
            nworkers = 0;
            owner = getpid();
            active.store(0, std::memory_order_relaxed);
        }
        while (nworkers < nth - 1) {
            std::thread(&WorkPool::worker, this,
                        gen.load(std::memory_order_relaxed)).detach();
            nworkers++;
        }
        job = &fn;
        lanes.store(nth - 1, std::memory_order_relaxed);
        active.store(nworkers, std::memory_order_relaxed);
        gen.fetch_add(1, std::memory_order_release);
        futex_wake_all(&gen);
        fn();
        while (active.load(std::memory_order_acquire) != 0)
            std::this_thread::yield();
        job = nullptr;
    }
};
WorkPool g_pool;

// NOTE: cell-granular (32 B) depth tracking was tried and REVERTED: the
// conservative depth inflation cascades (cells mixing independent pieces
// push depths past resolve_min_depth, triggering expensive origin-run
// resolution and +16-50% fires) and ate the ~8 ms/10MB scan+memset saving
// at every resolve_min_depth tried. Depth must stay byte-exact; the
// per-byte ops below are SIMD/inline-optimized instead.

// TLZ4_SKIP={origin,scan,set} ablation flags: skip per-byte fill stages to
// attribute emit cost (output is WRONG under `scan`/`set`; `origin` now just
// disables deep-piece resolution, which stays CORRECT — deep pieces emit raw
// records with the depth machinery).
bool skip_origin = false, skip_scan = false, skip_set = false;
// finer ablation gates (timing attribution only, output WRONG under all):
// lit = literal-image copies, idx = piece-index pushes, mat = the
// materialization memcpys themselves (depth checks still run)
bool skip_lit = false, skip_idx = false, skip_mat = false;
// Packer selection: the dense reserved-fire packer wins on big tiles
// (TILE_ROWS >= 512); the legacy soft-boundary packer is cheaper at 256.
// Set per call from tile_rows (TLZ4_DENSE_PACK=0/1 overrides for A/B).
bool dense_pack = false;
// skip_pack: drop ring_pack_tile; skip_push: drop record buffering too
bool skip_pack = false, skip_push = false;
// TLZ4_HARD_GROUPS=1: pad every depth group to a whole fire (pre-soft
// layout) — A/B and debugging
bool hard_groups = false;
// TLZ4_DETERMINISTIC=1: zero-fill match spans in the literal image so plans
// are byte-identical across pool generations (debug/diffing only — decoded
// output is exact either way)
bool deterministic_fill = false;
// TLZ4_NO_MAT=1: disable the known-source materialization fast paths
// (A/B: materialization trades host memcpy time for kernel fires)
bool no_mat = false;

// TLZ4_PLAN_PROF per-stage accumulators (ns / record counts).
bool prof_on = false;
std::atomic<int64_t> prof_emit_ns{0}, prof_pack_ns{0}, prof_recs{0};
std::atomic<int64_t> prof_deep_tiles{0}, prof_deep_pieces{0};
std::atomic<int64_t> prof_chase_nodes{0}, prof_chase_aborts{0};
std::atomic<int64_t> prof_gfires[18];   // fires per group (17+ lumped)
std::atomic<int64_t> prof_gslots[18];   // used record slots per group

// max of depth[lo, hi) — branch-free SSE on every span length: short spans
// (the avg ~6 B common case) use ONE masked 16-byte overlap load (bytes
// past hi are masked to 0, neutral for max; the depth scratch carries 64
// bytes of tail slack so the overread stays in-bounds), long spans loop
// 16-byte chunks.
#if defined(__SSE2__)
alignas(16) static const uint8_t kSpanMask[16][16] = {
#define M0 0
#define M1 0xFF
#define ROW(n) {n>0?M1:M0,n>1?M1:M0,n>2?M1:M0,n>3?M1:M0,n>4?M1:M0,n>5?M1:M0,\
n>6?M1:M0,n>7?M1:M0,n>8?M1:M0,n>9?M1:M0,n>10?M1:M0,n>11?M1:M0,n>12?M1:M0,\
n>13?M1:M0,n>14?M1:M0,n>15?M1:M0}
    ROW(0), ROW(1), ROW(2), ROW(3), ROW(4), ROW(5), ROW(6), ROW(7),
    ROW(8), ROW(9), ROW(10), ROW(11), ROW(12), ROW(13), ROW(14), ROW(15),
#undef ROW
#undef M0
#undef M1
};

static inline uint8_t hmax_epu8(__m128i acc) {
    acc = _mm_max_epu8(acc, _mm_srli_si128(acc, 8));
    acc = _mm_max_epu8(acc, _mm_srli_si128(acc, 4));
    acc = _mm_max_epu8(acc, _mm_srli_si128(acc, 2));
    acc = _mm_max_epu8(acc, _mm_srli_si128(acc, 1));
    return (uint8_t)_mm_cvtsi128_si32(acc);
}
#endif

static inline uint8_t depth_range_max(const uint8_t* dp, int64_t lo,
                                      int64_t hi) {
#if defined(__SSE2__)
    int64_t len = hi - lo;
    if (len < 16) {
        __m128i v = _mm_loadu_si128((const __m128i*)(dp + lo));
        v = _mm_and_si128(v, _mm_load_si128((const __m128i*)kSpanMask[len]));
        return hmax_epu8(v);
    }
    __m128i acc = _mm_loadu_si128((const __m128i*)(dp + lo));
    lo += 16;
    while (lo + 16 <= hi) {
        acc = _mm_max_epu8(acc, _mm_loadu_si128((const __m128i*)(dp + lo)));
        lo += 16;
    }
    if (lo < hi)  // overlap-load the tail (hi-16 >= original lo here)
        acc = _mm_max_epu8(acc,
                           _mm_loadu_si128((const __m128i*)(dp + hi - 16)));
    return hmax_epu8(acc);
#else
    uint8_t m = 0;
    for (int64_t s = lo; s < hi; s++) m = dp[s] > m ? dp[s] : m;
    return m;
#endif
}

// (The per-byte int32 origin map and its affine iota/chase fills — ~7 ms
// of the 10 MB plan wall, 4 B written per output byte — were replaced in
// round 4 by the LAZY per-piece chase below: deep pieces (~2.6% of records
// on text) resolve by recursing through a per-tile sparse piece index
// instead of reading a pre-materialized origin byte-map.)

// depth[p0, p0+len) = d — inline small stores (avg len ~6; memset call
// overhead dominated the TLZ4_SKIP=set ablation). The len<8 fast path
// writes a full 8-byte splat: bytes past p0+len belong to later pieces of
// the SAME tile (output order), which overwrite them before any scan reads
// them (scans only read already-emitted positions). The buffer is the
// per-worker TILE-LOCAL depth scratch (tile_rows*128 + 64 slack bytes), so
// the splat can always run — the slack absorbs the tile-end spill.
static inline void depth_fill(uint8_t* dp, int64_t p0, int64_t len,
                              uint8_t d) {
    uint64_t splat = 0x0101010101010101ULL * (uint64_t)d;
    if (len <= 8) {
        std::memcpy(dp + p0, &splat, 8);
        return;
    }
    if (len <= 16) {
        std::memcpy(dp + p0, &splat, 8);
        std::memcpy(dp + p0 + len - 8, &splat, 8);
        return;
    }
    std::memset(dp + p0, d, (size_t)len);
}

// Group-segregated record streams: ring_push writes each record ONCE, in
// its final packed field form, into the SoA chunk list of its
// (depth-group, plain/periodic) stream; ring_pack_tile then lays groups
// into fire rows with bulk sequential copies. This replaces the previous
// buffer-all-records vector + count pass + per-record 3-array scatter
// (~45% of the tiles-phase wall on the 10 MB text corpus).
constexpr int RCHUNK = 512;  // records per chunk (3 x 2 KiB SoA payload)
struct RecChunk {
    RecChunk* next;
    int32_t n;
    int32_t v0[RCHUNK], v1[RCHUNK], v2[RCHUNK];
};
struct GroupStream {
    RecChunk* head = nullptr;
    RecChunk* tail = nullptr;
    int64_t count = 0;
};
// Per-worker chunk recycler: chunks persist across tiles and calls (the
// pool keeps workers alive), so steady state allocates nothing.
struct RecArena {
    std::vector<RecChunk*> all;
    size_t used = 0;
    ~RecArena() { for (RecChunk* c : all) delete c; }
    RecChunk* grab() {
        if (used == all.size()) all.push_back(new RecChunk);
        RecChunk* c = all[used++];
        c->n = 0;
        c->next = nullptr;
        return c;
    }
    void reset() { used = 0; }
};

// 20-byte sequence record: the parse walk + assembly move ~2 of these per
// 26 comp bytes, so size is bandwidth (32 -> 20 B measurably cut the parse
// phase). int32 positions bound one ring plan to <2 GiB of comp/output —
// inputs beyond that return TLZ4_PLAN_OVERFLOW up front (the 2 GiB plan
// would need ~10 GiB of record arrays anyway; callers fall back).
struct RingSeq {
    int32_t lit_start;   // literal run start in the (concatenated) comp buf
    int32_t out_off;     // global output position of the literal run
    int32_t lit_len, match_len;
    uint16_t match_off;  // wire-format offset <= 65535
    uint16_t _pad;
};

struct RingShared {
    int32_t tile_rows, window_rows, ntiles;
    int32_t rb, nfmax;   // records per fire, max fires per tile
    int32_t resolve_min_depth, resolve_runs;
    int64_t expected_out;
    const uint8_t* input;  // concatenated compressed stream (literal source)
    int64_t input_len;     // its length (wild-copy overread guard)
    int32_t* f0; int32_t* f1; int32_t* f2;  // (ntiles, nfmax, rb) records
    int32_t* nf_tot;  // per-tile fire counts (match fires only)
    int32_t* fper;    // (ntiles, (nfmax+31)/32) bitmask: fire has a P<128
                      // (periodic) record -> the kernel's slow (lane+ph)%P
                      // path; unset fires take the &127 fast path
    uint8_t* lit_init;  // (ntiles*tile_rows*128) literal image: every
                        // literal byte (and every match byte the resolver
                        // telescopes to a comp position) is memcpy'd here
                        // host-side; the kernel seeds each tile from it and
                        // only match fires run on device
};

// Builder state for exactly one tile: output range [ts, te).
struct RingTile {
    const RingShared* g;
    int32_t t;
    int64_t ts, te, ring_base;  // ring_base = ts - WR*128
    uint8_t* dloc;  // per-worker TILE-LOCAL depth scratch: dloc[x] is the
                    // fire depth of global output position ts + x. Every
                    // depth read clamps its range to [ts, te) (sources
                    // before the tile contribute through the ring, not
                    // depth), so 32 KiB + 64 B of slack per worker replaces
                    // the former global expected_out-sized scratch — the
                    // buffer stays L2-resident across tiles instead of
                    // streaming ~10 MB of DRAM per 10 MB plan.
    int64_t deep_pieces = 0;    // pieces that entered the resolution branch
    int64_t nrec = 0;
    int64_t tbase = 0;   // this tile's flat base in the field arrays
    int32_t maxd = 0;    // max match depth pushed so far
    int32_t row_mask;    // tile_rows - 1 when a power of two, else 0
    RecArena* arena;
    // stream id 2*group + periodic, group = 1+d matches (literals bypass)
    std::vector<GroupStream>* gs;
    // Sparse piece index for the lazy origin chase, PACKED one entry per
    // int64: high 32 bits = output position p, low 32 = value v (one
    // push_back instead of two parallel vectors — the seq loop pushes ~2
    // entries per sequence). Entry i covers output positions [p_i, p_{i+1})
    // (last entry to te). v >= 0 is a literal fragment whose byte at x is
    // input[v + (x - p_i)]; v < 0 is a match piece with offset -v (byte at
    // x copies x + v). Entries are appended in output order by the seq
    // loop, and every in-tile byte below the emit cursor is covered.
    // rowidx[r] is the index of the first entry at output row >= r (filled
    // through filled_row), bounding each chase lookup to one row's entries.
    std::vector<int64_t>* pidx;
    std::vector<int32_t>* rowidx;
    int32_t filled_row = -1;
};

static inline int32_t idx_pos(int64_t e) { return (int32_t)(e >> 32); }
static inline int32_t idx_val(int64_t e) { return (int32_t)e; }

TLZ4_HOT inline void idx_push(RingTile& c, int32_t p, int32_t v) {
    if (skip_idx) return;
    int32_t rp = (int32_t)(((int64_t)p - c.ts) >> 7);
    int32_t n = (int32_t)c.pidx->size();
    for (int32_t r = c.filled_row + 1; r <= rp; r++) (*c.rowidx)[r] = n;
    if (rp > c.filled_row) c.filled_row = rp;
    c.pidx->push_back(((int64_t)p << 32) | (uint32_t)v);
}

// Lazy chase: resolve a source span into <= cap affine runs over comp
// positions (literal origins) or pre-tile ring positions, by recursing
// through the piece index — the sparse replacement for reading a
// pre-materialized per-byte origin map. Node/run budgets bound the work on
// pathological chains (budget exhaustion falls back to a raw record with
// the depth machinery, exactly like an unusable eager resolution did).
struct LazyRuns {
    int64_t start[64];  // run source start: comp pos (kind 0) / output pos
    int32_t len[64];    //                   of a ring byte (kind 1)
    uint8_t kind[64];
    int32_t n = 0, cap = 16;
    int32_t nodes = 0, node_budget = 0;
    bool ok = true;
};

static inline void lazy_push_run(LazyRuns& R, uint8_t kind, int64_t start,
                                 int64_t len) {
    if (R.n && R.kind[R.n - 1] == kind &&
        R.start[R.n - 1] + R.len[R.n - 1] == start) {
        R.len[R.n - 1] += (int32_t)len;
        return;
    }
    if (R.n >= R.cap) { R.ok = false; return; }
    R.start[R.n] = start;
    R.len[R.n] = (int32_t)len;
    R.kind[R.n] = kind;
    R.n++;
}

static void lazy_chase(const RingTile& c, int64_t lo, int64_t hi,
                       LazyRuns& R) {
    if (!R.ok) return;
    if (++R.nodes > R.node_budget) { R.ok = false; return; }
    if (lo < c.ts) {  // pre-tile prefix: a ring run (kernel window rows)
        if (lo < c.ring_base) { R.ok = false; return; }  // left the ring
        int64_t rhi = hi < c.ts ? hi : c.ts;
        lazy_push_run(R, 1, lo, rhi - lo);
        if (!R.ok || rhi >= hi) return;
        lo = rhi;
    }
    const std::vector<int64_t>& pidx = *c.pidx;
    // last entry with pos <= lo (coverage guarantees pos[0] == ts <= lo):
    // the row index bounds the search to one output row's entries.
    size_t n = pidx.size();
    int32_t r = (int32_t)((lo - c.ts) >> 7);
    const std::vector<int32_t>& ri = *c.rowidx;
    size_t a = r <= c.filled_row ? (size_t)(ri[r] > 0 ? ri[r] - 1 : 0) : n - 1;
    size_t b = r < c.filled_row ? (size_t)ri[r + 1] : n;
    while (a < b) {
        size_t m = (a + b) / 2;
        if ((int64_t)idx_pos(pidx[m]) <= lo) a = m + 1; else b = m;
    }
    size_t i = a - 1;
    while (lo < hi) {
        if (++R.nodes > R.node_budget) { R.ok = false; return; }
        int64_t e_end = (i + 1 < n) ? (int64_t)idx_pos(pidx[i + 1]) : c.te;
        int64_t seg_hi = hi < e_end ? hi : e_end;
        int32_t v = idx_val(pidx[i]);
        if (v >= 0) {
            lazy_push_run(R, 0, (int64_t)v + (lo - idx_pos(pidx[i])),
                          seg_hi - lo);
        } else {
            lazy_chase(c, lo + v, seg_hi + v, R);  // v = -offset
        }
        if (!R.ok) return;
        lo = seg_hi;
        i++;
    }
}

// splat[p, pe) = v (int32), 4-wide. (NT stamping was tried for round 5 and
// measured a 2.4 ms LOSS on the 10 MB text plan: the pad runs are short and
// interleave with the NT record copies, so the partial write-combining
// buffers flush line-by-line instead of streaming.)
static inline void stamp_i32(int32_t* o, int64_t p, int64_t pe, int32_t v) {
#if defined(__SSE2__)
    const __m128i vec = _mm_set1_epi32(v);
    for (; p + 4 <= pe; p += 4) _mm_storeu_si128((__m128i*)(o + p), vec);
#endif
    for (; p < pe; p++) o[p] = v;
}

// Record-field copy, optionally with NON-TEMPORAL stores: the packed
// (ntiles, NF, RB) arrays (~11-30 MB per 10 MB plan) are written once here
// and never re-read on the host (they upload to the device). On small-L3
// hosts streaming them past the cache keeps the working set (depth, lit
// image, piece index) resident (measured ~1 ms/10 MB win on a 4-core 8 MB
// L3 box); on large-L3 hosts (e.g. 260 MB Xeon) the same NT stores force
// DRAM round-trips the cache would have absorbed (measured ~1.3 ms LOSS).
// tlz4_build_ring_plan2 decides per call from the plan size vs L3 size.
static bool use_nt_stores = true;

static inline void stream_copy_i32(int32_t* dst, const int32_t* src,
                                   int64_t n) {
#if defined(__SSE2__)
    if (use_nt_stores) {
        int64_t k = 0;
        // head: align dst to 16
        while (k < n && (((uintptr_t)(dst + k)) & 15)) {
            dst[k] = src[k];
            k++;
        }
        for (; k + 4 <= n; k += 4)
            _mm_stream_si128((__m128i*)(dst + k),
                             _mm_loadu_si128((const __m128i*)(src + k)));
        for (; k < n; k++) dst[k] = src[k];
        return;
    }
#endif
    std::memcpy(dst, src, (size_t)n * 4);
}

// Compact batched-fire packing for one finished tile: the record stream is
// matches by depth asc (literals never reach the kernel — they live in the
// lit_init image). Record k of the stream lands at field arrays
// [t, k / RB, k % RB]: fire j = k / RB consumes contiguous row j. Group
// 1+d = matches of depth d. Periodic records (P < 128 — wrapped
// self-overlap matches) sit in each group's tail partition so mostly the
// fires overlapping that tail pay the kernel's (lane+ph)%P vector-division
// path; plain fires take &127 (measured 1.27 us/fire cheaper —
// experiments/fire_ablate3.py). Order within a depth group is free: each
// output lane has exactly one writer per tile.
//
// Groups use SOFT fire boundaries: records append consecutively across
// depth groups, and a fire only pads early when the candidate record's
// read rows alias a tile row already written by records in the open fire.
// Safety: a fire reads the table once before its writes, so the only
// intra-fire hazard is a record sourcing bytes written by the same fire.
// Byte depths are unique per byte, so a group-d record's sources
// (depth < d) can never be bytes written by same-or-lower groups in the
// fire (depth >= d... the aliasing candidate set is exactly the records
// already appended, whose write depths are <= d, and only writes at depth
// == the source byte's depth could collide) — the row-granular check
// against the open fire's write-row set is a conservative superset of that
// hazard. This recovers most of the ~25% fire padding that hard per-group
// rounding cost (measured 7497 -> ~6030 fires on the 10 MB text corpus).
// TLZ4_HARD_GROUPS=1 restores hard boundaries for A/B.
//
// PENDING-DEFER (round 5): a conflicting record no longer pads the fire
// out — it is pushed to a per-tile pending list and the scan keeps
// filling the open fire with the group's remaining records (order within
// a depth group is free: each output lane has exactly one writer per
// tile, and a group-d record can never source bytes written at depth d).
// Pending records drain into the next FRESH fire (right after any fire
// close their conflict set Wfz is empty, so the drain cannot conflict);
// the group-end flush closes the fire iff pending is non-empty — the
// same pad the old code paid on the FIRST conflict now happens at most
// once per (group, fire) and only after the fire filled with everything
// conflict-free. Deferring past the group boundary would be unsound: a
// group-(d+1) record may read rows a pending group-d record writes, and
// the hazard scan only checks the open fire, not the pending set.
// Measured on the 10 MB text corpus: 5385 -> ~4100 fires, same records.
int ring_pack_tile(RingTile& c) {
    const RingShared& g = *c.g;
    const int64_t RB = g.rb;
    const int64_t cap = RB * g.nfmax;
    if (c.nrec == 0) {
        // fires beyond nf_tot never execute, so the record slots can stay
        // uninitialized (np.empty garbage is never read by the kernel)
        g.nf_tot[c.t] = 0;
        return 0;
    }
    const int32_t nfw = (g.nfmax + 31) / 32;
    const int64_t tbase = (int64_t)c.t * cap;
    const size_t nstreams = c.gs->size();

    if (!hard_groups && !dense_pack) {
        // ---- legacy soft-boundary packer (production at TILE_ROWS=256):
        // identical fire counts to the dense packer there (the depth chain
        // binds, not padding) at ~3 ms-CPU less bookkeeping. The dense
        // reserved-fire packer below takes over at TILE_ROWS >= 512, where
        // per-group flushes would multiply across the bigger tile's
        // groups (measured 2872 vs ~4000 fires on 10 MB text).
        // ---- match groups: soft boundaries ----
        int64_t k = 0;
        // Two write-row sets per open fire: W collects every append; Wfz
        // (frozen) holds only writes from groups STRICTLY BELOW the current
        // one — candidates are checked against Wfz alone, because a group-d
        // record's sources (bytes of depth < d) can never be bytes written
        // by same-group records (each byte has exactly one depth), so
        // same-group row sharing is provably safe and must not pad.
        const int32_t WR = g.window_rows, TR = g.tile_rows;
        uint64_t W[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        uint64_t Wfz[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        bool fire_per = false;
        // Per-tile local profiling counters: a per-RECORD atomic fetch_add
        // here measured 2x the whole plan-build wall (1.5 M contended
        // atomics across 8 threads) — profiling must not distort what it
        // measures. Flushed once per tile below.
        int64_t lslots[18] = {0};
        auto close_fire = [&](int64_t upto) {  // pad [k, upto), flag, reset
            if (upto > k) {
                // Only f2's row sentinel is load-bearing for a pad slot:
                // row == tile_rows makes the kernel's lane mask (row < TR)
                // AND the scatter one-hot (rowsTR == row) both reject the
                // record, so garbage f0/f1 never reaches the output —
                // pulls land on some row and are discarded. Full stamping
                // only under TLZ4_DETERMINISTIC (byte-identical plans for
                // diffing across pool generations / thread counts).
                if (deterministic_fill) {
                    stamp_i32(g.f0, tbase + k, tbase + upto, 0);
                    stamp_i32(g.f1, tbase + k, tbase + upto, 127 << 7);
                }
                stamp_i32(g.f2, tbase + k, tbase + upto, g.tile_rows << 7);
            }
            if (fire_per) {
                int64_t f = (upto - 1) / RB;
                g.fper[(int64_t)c.t * nfw + (f >> 5)] |= 1 << (f & 31);
            }
            std::memset(W, 0, sizeof(W));
            std::memset(Wfz, 0, sizeof(Wfz));
            fire_per = false;
            k = upto;
        };
        bool wfz_any = false;  // Wfz all-zero => no conflict possible
        // Pending-defer buffers (plain / periodic), per-worker persistent.
        static thread_local std::vector<int32_t> pd0[2], pd1[2], pd2[2];
        pd0[0].clear(); pd1[0].clear(); pd2[0].clear();
        pd0[1].clear(); pd1[1].clear(); pd2[1].clear();
        int32_t cur_gi = 1;
        bool ovf = false;
        // Drain the pending lists into the (fresh) open fire. Only called
        // right after a close_fire, so Wfz is empty and nothing conflicts.
        auto drain_pending = [&]() {
            for (int pp = 0; pp < 2; pp++) {
                int32_t n = (int32_t)pd0[pp].size();
                int32_t i = 0;
                while (i < n) {
                    int32_t room = (int32_t)(RB - (k % RB));
                    int32_t m = n - i < room ? n - i : room;
                    if (k + m > cap) { ovf = true; return; }
                    stream_copy_i32(g.f0 + tbase + k, pd0[pp].data() + i, m);
                    stream_copy_i32(g.f1 + tbase + k, pd1[pp].data() + i, m);
                    stream_copy_i32(g.f2 + tbase + k, pd2[pp].data() + i, m);
                    for (int32_t q = i; q < i + m; q++) {
                        int32_t wrow = (pd2[pp][q] >> 7) & 511;
                        W[wrow >> 6] |= 1ull << (wrow & 63);
                    }
                    fire_per |= pp == 1;
                    lslots[cur_gi < 17 ? cur_gi : 17] += m;
                    k += m;
                    i += m;
                    if (!(k % RB)) close_fire(k);  // Wfz stays empty
                }
                pd0[pp].clear(); pd1[pp].clear(); pd2[pp].clear();
            }
        };
        for (int32_t gi = 1; (size_t)2 * gi < nstreams && !ovf; gi++) {
            cur_gi = gi;
            std::memcpy(Wfz, W, sizeof(W));  // freeze prior groups' writes
            wfz_any = (Wfz[0] | Wfz[1] | Wfz[2] | Wfz[3] | Wfz[4] | Wfz[5] |
                       Wfz[6] | Wfz[7]) != 0;
            for (int pass = 0; pass < 2 && !ovf; pass++) {
                size_t sid = 2 * (size_t)gi + pass;
                if (sid >= nstreams) break;
                const bool per = pass == 1;  // streams segregate periodic
                for (RecChunk* ch = (*c.gs)[sid].head; ch && !ovf;
                     ch = ch->next) {
                    int32_t i = 0;
                    while (i < ch->n) {
                        // span = up to the next fire boundary / chunk end
                        int32_t room = (int32_t)(RB - (k % RB));
                        int32_t lim = ch->n - i < room ? ch->n : i + room;
                        // first conflicting record in [i, lim): a read row
                        // written by an EARLIER group in the open fire
                        // (periodic records pull rows r0 and r0+1); Wfz is
                        // constant within the span, so scan then bulk-copy
                        int32_t j = i;
                        if (wfz_any) {
                            for (; j < lim; j++) {
                                int32_t r0 = (ch->v0[j] >> 7) - WR;
                                bool hit = (uint32_t)r0 < (uint32_t)TR &&
                                           ((Wfz[r0 >> 6] >> (r0 & 63)) & 1);
                                if (per && !hit) {
                                    int32_t r1 = r0 + 1;
                                    hit = (uint32_t)r1 < (uint32_t)TR &&
                                          ((Wfz[r1 >> 6] >> (r1 & 63)) & 1);
                                }
                                if (hit) break;
                            }
                        } else {
                            j = lim;
                        }
                        if (j > i) {
                            int32_t m = j - i;
                            if (k + m > cap) return TLZ4_PLAN_OVF_SLOT;
                            stream_copy_i32(g.f0 + tbase + k, ch->v0 + i, m);
                            stream_copy_i32(g.f1 + tbase + k, ch->v1 + i, m);
                            stream_copy_i32(g.f2 + tbase + k, ch->v2 + i, m);
                            for (int32_t q = i; q < j; q++) {
                                int32_t wrow = (ch->v2[q] >> 7) & 511;
                                W[wrow >> 6] |= 1ull << (wrow & 63);
                            }
                            fire_per |= per;
                            lslots[gi < 17 ? gi : 17] += m;
                            k += m;
                            if (!(k % RB)) {
                                close_fire(k);
                                wfz_any = false;  // fresh fire: Wfz cleared
                                drain_pending();
                                if (ovf) break;
                            }
                            i = j;
                        }
                        if (j < lim) {  // conflict at j: defer the record
                            pd0[per].push_back(ch->v0[j]);
                            pd1[per].push_back(ch->v1[j]);
                            pd2[per].push_back(ch->v2[j]);
                            i = j + 1;
                        }
                        if (k >= cap && i < ch->n) return TLZ4_PLAN_OVF_SLOT;
                    }
                }
            }
            // Group-end flush: pending records conflict with the open
            // fire's earlier-group writes by construction, and the NEXT
            // group may read rows they write — close and drain before
            // advancing.
            if (!ovf &&
                (!pd0[0].empty() || !pd0[1].empty())) {
                if (k % RB) close_fire(((k + RB - 1) / RB) * RB);
                drain_pending();
            }
        }
        if (ovf) return TLZ4_PLAN_OVF_SLOT;
        if (k % RB) close_fire(((k + RB - 1) / RB) * RB);
        if (k > cap) return TLZ4_PLAN_OVF_SLOT;
        g.nf_tot[c.t] = (int32_t)(k / RB);
        if (prof_on) {
            for (int i = 0; i < 18; i++)
                if (lslots[i])
                    prof_gslots[i].fetch_add(lslots[i],
                                             std::memory_order_relaxed);
        }
        return 0;
    }


    if (!hard_groups) {
        // ---- dense packing with reserved-fire deferral (round 5) ----
        // The former scheme (soft boundaries + pending-defer) still closed
        // a fire at every (group, pending) flush, leaving the plan at ~50%
        // fire fill (5334 fires for 685K records on the 10 MB text corpus
        // = 2x the 2678-fire minimum). This packer closes a fire ONLY when
        // it is full: per tile row it tracks the highest fire index that
        // wrote the row at a strictly-lower depth group (lastw, folded
        // from a per-group staging array at group advance so same-group
        // writes never constrain — a depth-d record's sources are bytes
        // of depth < d and byte depths are unique), and a record whose
        // read rows were lower-group-written in the open fire defers with
        // an exact RESERVED fire index (max lastw of its read rows + 1),
        // draining the moment that fire opens. Reservations are exact:
        // the fire opens empty and drains before the scan refills it, so
        // later readers constrained against the reservation stay sound; a
        // drain that would spill past its reserved fire (>RB same-fire
        // reservations — unobserved in practice) bails the tile to the
        // hard-groups packer below. Record order across groups is free in
        // exactly the hazard-graph sense: fire f executes all reads
        // before its writes, and a higher-group write never constrains a
        // lower-group reader (distinct byte depths). Measured: 5334 ->
        // ~2900 fires, kernel time scales with fires.
        const int32_t WR = g.window_rows, TR = g.tile_rows;
        static thread_local std::vector<int32_t> lastw_v, stage_v;
        if ((int32_t)lastw_v.size() < TR) {
            lastw_v.resize(TR);
            stage_v.resize(TR);
        }
        int32_t* lastw = lastw_v.data();
        int32_t* stage = stage_v.data();
        std::memset(lastw, 0xFF, (size_t)TR * 4);  // -1
        std::memset(stage, 0xFF, (size_t)TR * 4);
        int32_t gmax = -1, stagemax = -1;  // max(lastw[]), max(stage[])
        struct Pend {
            int32_t v0, v1, v2, minfire;
            uint8_t per;
        };
        static thread_local std::vector<Pend> pend;
        pend.clear();
        size_t pcur = 0;  // consumed prefix of pend
        int64_t k = 0;
        int64_t fcur = 0;  // open fire index == k / RB
        bool fire_per = false;
        int64_t lslots[18] = {0};
        int32_t cur_gi = 1;
        bool bail = false;  // reservation spill -> hard-groups fallback
        bool ovf = false;

        auto place = [&](int32_t v0, int32_t v1, int32_t v2, bool per) {
            g.f0[tbase + k] = v0;
            g.f1[tbase + k] = v1;
            g.f2[tbase + k] = v2;
            int32_t w = (v2 >> 7) & 511;
            if (stage[w] < (int32_t)fcur) stage[w] = (int32_t)fcur;
            if ((int32_t)fcur > stagemax) stagemax = (int32_t)fcur;
            fire_per |= per;
            lslots[cur_gi < 17 ? cur_gi : 17]++;
            k++;
        };
        // Advance to the next fire: flag periodic, drain reservations for
        // the newly opened fire (which may fill it and cascade).
        auto open_next_fire = [&]() {
            if (fire_per) {
                g.fper[(int64_t)c.t * nfw + (fcur >> 5)] |=
                    1 << (fcur & 31);
                fire_per = false;
            }
            fcur++;
            while (pcur < pend.size() && !bail && !ovf) {
                // drain every reservation for fcur (pend is scanned in
                // order; consumed entries null out via minfire = -1)
                bool any = false, future = false;
                for (size_t i = pcur; i < pend.size(); i++) {
                    Pend& p = pend[i];
                    if (p.minfire < 0) continue;
                    if (p.minfire > (int32_t)fcur) { future = true; continue; }
                    if (p.minfire < (int32_t)fcur) { bail = true; return; }
                    if (k >= cap) { ovf = true; return; }
                    if (k / RB != fcur) { bail = true; return; }  // spill
                    place(p.v0, p.v1, p.v2, p.per != 0);
                    p.minfire = -1;
                    any = true;
                    if (!(k % RB)) break;  // fire filled mid-drain
                }
                while (pcur < pend.size() && pend[pcur].minfire < 0) pcur++;
                if (!(k % RB) && k && (any || !future)) {
                    if (pcur < pend.size()) {
                        // filled exactly: advance and keep draining
                        if (fire_per) {
                            g.fper[(int64_t)c.t * nfw + (fcur >> 5)] |=
                                1 << (fcur & 31);
                            fire_per = false;
                        }
                        fcur++;
                        continue;
                    }
                }
                break;
            }
        };
        auto close_fire = [&]() {  // pad the open fire to its boundary
            int64_t upto = ((k + RB - 1) / RB) * RB;
            if (upto > cap) { ovf = true; return; }
            if (upto > k) {
                if (deterministic_fill) {
                    stamp_i32(g.f0, tbase + k, tbase + upto, 0);
                    stamp_i32(g.f1, tbase + k, tbase + upto, 127 << 7);
                }
                stamp_i32(g.f2, tbase + k, tbase + upto, g.tile_rows << 7);
                k = upto;
            }
            open_next_fire();
        };

        for (int32_t gi = 1; (size_t)2 * gi < nstreams && !ovf && !bail;
             gi++) {
            cur_gi = gi;
            // group advance: same-group stage writes become lower-group
            // constraints for this group's readers
            if (stagemax >= 0) {
                for (int32_t r = 0; r < TR; r++)
                    if (stage[r] > lastw[r]) lastw[r] = stage[r];
                if (stagemax > gmax) gmax = stagemax;
            }
            for (int pass = 0; pass < 2 && !ovf && !bail; pass++) {
                size_t sid = 2 * (size_t)gi + pass;
                if (sid >= nstreams) break;
                const bool per = pass == 1;
                for (RecChunk* ch = (*c.gs)[sid].head; ch && !ovf && !bail;
                     ch = ch->next) {
                    int32_t i = 0;
                    while (i < ch->n && !ovf && !bail) {
                        int32_t room = (int32_t)(RB - (k % RB));
                        int32_t lim = ch->n - i < room ? ch->n : i + room;
                        int32_t j = i;
                        int32_t defer_mf = -1;
                        if (gmax < (int32_t)fcur) {
                            // no row's lower-group write reaches the open
                            // fire: the whole span places without checks
                            j = lim;
                        } else {
                            for (; j < lim; j++) {
                                int32_t r0 = (ch->v0[j] >> 7) - WR;
                                int32_t mf = 0;
                                if ((uint32_t)r0 < (uint32_t)TR)
                                    mf = lastw[r0] + 1;
                                if (per) {
                                    int32_t r1 = r0 + 1;
                                    if ((uint32_t)r1 < (uint32_t)TR &&
                                        lastw[r1] + 1 > mf)
                                        mf = lastw[r1] + 1;
                                }
                                if (mf > (int32_t)fcur) {
                                    if (mf >= g.nfmax) { ovf = true; break; }
                                    defer_mf = mf;
                                    break;
                                }
                            }
                            if (ovf) break;
                        }
                        if (j > i) {
                            // bulk-copy the conflict-free prefix [i, j)
                            int32_t m = j - i;
                            if (k + m > cap) { ovf = true; break; }
                            stream_copy_i32(g.f0 + tbase + k, ch->v0 + i, m);
                            stream_copy_i32(g.f1 + tbase + k, ch->v1 + i, m);
                            stream_copy_i32(g.f2 + tbase + k, ch->v2 + i, m);
                            for (int32_t q = i; q < j; q++) {
                                int32_t w = (ch->v2[q] >> 7) & 511;
                                if (stage[w] < (int32_t)fcur)
                                    stage[w] = (int32_t)fcur;
                            }
                            if ((int32_t)fcur > stagemax)
                                stagemax = (int32_t)fcur;
                            fire_per |= per;
                            lslots[gi < 17 ? gi : 17] += m;
                            k += m;
                            i = j;
                            if (!(k % RB)) open_next_fire();
                        }
                        if (defer_mf >= 0 && !ovf && !bail) {
                            // defer record j with an exact reservation; its
                            // write constrains later groups' readers from
                            // the reserved fire onward
                            pend.push_back({ch->v0[j], ch->v1[j], ch->v2[j],
                                            defer_mf, (uint8_t)pass});
                            int32_t w = (ch->v2[j] >> 7) & 511;
                            if (stage[w] < defer_mf) stage[w] = defer_mf;
                            if (defer_mf > stagemax) stagemax = defer_mf;
                            i = j + 1;
                        }
                    }
                }
            }
        }
        // tile end: keep closing fires until every reservation drained
        while (!ovf && !bail && pcur < pend.size()) close_fire();
        if (!ovf && !bail) {
            if (k % RB) {
                int64_t upto = ((k + RB - 1) / RB) * RB;
                if (upto > cap) {
                    ovf = true;
                } else {
                    if (deterministic_fill) {
                        stamp_i32(g.f0, tbase + k, tbase + upto, 0);
                        stamp_i32(g.f1, tbase + k, tbase + upto, 127 << 7);
                    }
                    stamp_i32(g.f2, tbase + k, tbase + upto,
                              g.tile_rows << 7);
                    if (fire_per)
                        g.fper[(int64_t)c.t * nfw + (fcur >> 5)] |=
                            1 << (fcur & 31);
                    k = upto;
                }
            } else if (fire_per && k) {
                // boundary-exact tile end: open_next_fire already flagged
                // all full fires; nothing open remains
            }
        }
        if (ovf) return TLZ4_PLAN_OVF_SLOT;
        if (!bail) {
            if (k > cap) return TLZ4_PLAN_OVF_SLOT;
            g.nf_tot[c.t] = (int32_t)(k / RB);
            if (prof_on) {
                for (int i = 0; i < 18; i++)
                    if (lslots[i])
                        prof_gslots[i].fetch_add(lslots[i],
                                                 std::memory_order_relaxed);
            }
            return 0;
        }
        // reservation spill: reset this tile's fper words and repack with
        // hard group boundaries (always sound, more pads)
        std::memset(g.fper + (int64_t)c.t * nfw, 0, (size_t)nfw * 4);
    }

    int64_t base = 0;
    for (int32_t gi = 1; (size_t)2 * gi < nstreams; gi++) {
        GroupStream* sp = &(*c.gs)[2 * (size_t)gi];
        GroupStream* sq = (size_t)(2 * gi + 1) < nstreams
                              ? &(*c.gs)[2 * (size_t)gi + 1]
                              : nullptr;
        int64_t nper = sq ? sq->count : 0;
        int64_t cnt = sp->count + nper;
        if (!cnt) continue;
        int64_t gend = ((base + cnt + RB - 1) / RB) * RB;
        if (gend > cap) return TLZ4_PLAN_OVF_SLOT;
        // bulk sequential copies: plain chunks from the group base, then
        // the periodic tail partition
        int64_t k = tbase + base;
        for (int pass = 0; pass < 2; pass++) {
            GroupStream* s = pass ? sq : sp;
            if (!s) continue;
            for (RecChunk* ch = s->head; ch; ch = ch->next) {
                std::memcpy(g.f0 + k, ch->v0, (size_t)ch->n * 4);
                std::memcpy(g.f1 + k, ch->v1, (size_t)ch->n * 4);
                std::memcpy(g.f2 + k, ch->v2, (size_t)ch->n * 4);
                k += ch->n;
            }
        }
        if (nper) {
            int64_t flo = (base + cnt - nper) / RB;
            int64_t fhi = (base + cnt - 1) / RB;
            for (int64_t f = flo; f <= fhi; f++)
                g.fper[(int64_t)c.t * nfw + (f >> 5)] |= 1 << (f & 31);
        }
        // The arrays arrive uninitialized (np.empty — zeroing them per
        // call costs more than the build itself) and fires beyond nf_tot
        // never execute, so only the pad slots inside each group's
        // fire-rounded span need sentinel stamping. f2's row sentinel
        // (row = tile_rows) alone makes the kernel reject the record (see
        // close_fire above); f0/f1 stamping only under TLZ4_DETERMINISTIC.
        if (deterministic_fill) {
            stamp_i32(g.f0, tbase + base + cnt, tbase + gend, 0);
            stamp_i32(g.f1, tbase + base + cnt, tbase + gend, 127 << 7);
        }
        stamp_i32(g.f2, tbase + base + cnt, tbase + gend, g.tile_rows << 7);
        if (prof_on) {
            int gx = gi < 17 ? gi : 17;
            prof_gfires[gx].fetch_add((gend - base) / RB,
                                      std::memory_order_relaxed);
            prof_gslots[gx].fetch_add(cnt, std::memory_order_relaxed);
        }
        base = gend;
    }
    g.nf_tot[c.t] = (int32_t)(base / RB);
    return 0;
}

TLZ4_HOT inline int32_t ring_row(const RingTile& c, int64_t p0) {
    // tile_rows is 256 in production; the pow2 mask avoids a per-record
    // integer division (tile_rows is a runtime value the compiler can't
    // strength-reduce)
    return c.row_mask ? (int32_t)((p0 >> 7) & c.row_mask)
                      : (int32_t)((p0 >> 7) % c.g->tile_rows);
}

TLZ4_HOT inline void ring_push(RingTile& c, int64_t p0, int32_t len, int64_t S,
                      int32_t P, int32_t ph, int32_t d) {
    if (skip_push) return;
    int32_t v0 = (int32_t)S;
    int32_t v1 = ph | ((P - 1) << 7) | ((int32_t)(p0 & 127) << 14);
    int32_t v2 = (len - 1) | (ring_row(c, p0) << 7);
    c.nrec++;
    size_t sid = 2 * (size_t)(d + 1) + (P != 128 ? 1 : 0);
    if (sid >= c.gs->size()) c.gs->resize(sid + 2);
    GroupStream& s = (*c.gs)[sid];
    RecChunk* ch = s.tail;
    if (!ch || ch->n == RCHUNK) {
        ch = c.arena->grab();
        if (s.tail) s.tail->next = ch;
        else s.head = ch;
        s.tail = ch;
    }
    int32_t k = ch->n++;
    ch->v0[k] = v0;
    ch->v1[k] = v1;
    ch->v2[k] = v2;
    s.count++;
    if (d > c.maxd) c.maxd = d;
}

// Literal bytes never become records: they are memcpy'd into the tile's
// slice of the lit_init image (output-position addressed), which the kernel
// loads as the tile's initial state before any match fire runs. Depth 0
// comes from the tile's pre-zero memset (ring_build_tile), so no depth
// bookkeeping either. This removes the literal fire group from the kernel
// (~40% of fires on the 10 MB text corpus) and the literal-window overflow
// class from the plan (any comp position is reachable by memcpy).
TLZ4_HOT inline int ring_emit_lit_frag(RingTile& c, int64_t p, int64_t pe,
                                       int64_t csrc) {
    // Wild 16-byte copy for the common short run (avg ~6 B on text):
    // variable-length memcpy dispatch costs more than the copy. Overrun
    // bytes land in the SAME seq's match span (written later or record-
    // covered garbage), so they are harmless — unless the run ends within
    // 16 B of the tile end (the next tile belongs to a concurrent worker)
    // or the source is within 16 B of the comp buffer end.
    int64_t len = pe - p;
    if (skip_lit) return 0;
    if (len <= 16 && pe + 16 <= c.te && csrc + 16 <= c.g->input_len) {
        std::memcpy(c.g->lit_init + p, c.g->input + csrc, 16);
        return 0;
    }
    std::memcpy(c.g->lit_init + p, c.g->input + csrc, (size_t)len);
    return 0;
}

inline int ring_emit_lit(RingTile& c, int64_t p0, int32_t len, int64_t csrc) {
    if (len <= 16 && p0 + 16 <= c.te && csrc + 16 <= c.g->input_len) {
        std::memcpy(c.g->lit_init + p0, c.g->input + csrc, 16);
        return 0;
    }
    std::memcpy(c.g->lit_init + p0, c.g->input + csrc, (size_t)len);
    return 0;
}

// Match record: dst lanes [lo, lo+len) of p0's row read ring byte
// S_out + ((l+ph) mod P), S_out in OUTPUT space (converted to table-local
// here). Distinct sources [src_lo, src_hi) drive the depth.
//
// DEPTH CONVENTION (round 4): every record carries depth >= 1, so a
// depth-0 byte means "final in the literal image" (literal, resolved run,
// or host-materialized match bytes). That makes knownness testable with
// the same SIMD range-max the group ordering already uses — the
// materialization fast paths below hinge on it.
TLZ4_HOT inline int ring_emit_match(RingTile& c, int64_t p0, int32_t len, int64_t S_out,
                           int32_t P, int32_t ph, int64_t src_lo,
                           int64_t src_hi, int32_t d_pre = -1) {
    const RingShared& g = *c.g;
    int64_t S_local = S_out - c.ring_base;
    if (S_local < 0 ||
        S_local >= (((int64_t)g.window_rows + g.tile_rows) << 7))
        return TLZ4_PLAN_OVERFLOW;
    int32_t d = d_pre;  // caller already scanned the identical source range
    if (d < 0) {
        int64_t lo_s = src_lo < c.ts ? c.ts : src_lo;
        d = 0;
        if (lo_s < src_hi && !skip_scan)
            d = (int32_t)depth_range_max(c.dloc, lo_s - c.ts, src_hi - c.ts) +
                1;
    }
    if (d < 1) d = 1;  // ring-only sources: no ordering constraint, but the
                       // written bytes are NOT final in the literal image
    if (d > RING_MAX_DEPTH) return TLZ4_PLAN_OVF_DEPTH;
    if (!skip_set) depth_fill(c.dloc, p0 - c.ts, len, (uint8_t)d);
    ring_push(c, p0, len, S_local, P, ph, d);
    return 0;
}

// Plain (non-periodic) piece: lane l reads s0 + (l - lo). Splits at source
// row boundaries with row-aligned S (same single-pull contract as
// ring_emit_lit above); s0 >= ring_base + 1 for any valid offset, and
// ring_base is row-aligned, so S never undershoots the ring.
TLZ4_HOT inline int ring_emit_plain(RingTile& c, int64_t p0, int32_t span, int64_t s0,
                           int32_t d_pre = -1) {
    const RingShared& gg = *c.g;
    // Known-source materialization: when the whole source span is in-tile
    // and depth-0 (final bytes in the literal image — literals, resolved
    // runs, or earlier materializations), the host copies the bytes
    // directly and emits NOTHING. Literal-rooted match chains collapse
    // into memcpys level by level (each materialization keeps depth 0, so
    // readers of these bytes materialize too); only ring-rooted content
    // still becomes kernel records. Non-wrapping pieces only (callers
    // guarantee span <= off here), so the copy is overlap-free.
    if (s0 >= c.ts && !skip_scan && !skip_origin && !no_mat) {
        int32_t dmax =
            d_pre >= 0
                ? d_pre - 1
                : (int32_t)depth_range_max(c.dloc, s0 - c.ts,
                                           s0 + span - c.ts);
        if (dmax == 0) {
            // wild 16-byte copy for the common short span: overrun bytes
            // land in later pieces of the SAME tile (output order), which
            // overwrite them; guards keep both ends inside the tile
            if (!skip_mat) {
                if (span <= 16 && p0 + 16 <= c.te && s0 + 16 <= c.te)
                    std::memcpy(gg.lit_init + p0, gg.lit_init + s0, 16);
                else
                    std::memcpy(gg.lit_init + p0, gg.lit_init + s0,
                                (size_t)span);
            }
            return 0;
        }
    }
    int64_t k = 0;
    while (k < span) {
        int64_t s = s0 + k;
        int64_t run = span - k;
        int64_t room = 128 - (s & 127);
        if (run > room) run = room;
        int64_t pk = p0 + k;
        int32_t ph = (int32_t)((s - (pk & 127)) & 127);
        int64_t S = s & ~(int64_t)127;
        if (int rc_ = ring_emit_match(c, pk, (int32_t)run, S, 128, ph, s,
                                      s + run, d_pre))
            return rc_;
        k += run;
    }
    return 0;
}

// Emit one match row-piece [p0, p0+span) using the lazy origin chase:
// shallow pieces (raw depth < resolve_min_depth) emit one cheap raw record;
// deep pieces whose origins form <= resolve_runs affine runs staying inside
// the ring/window emit depth-0/1 resolved records (host-side partial chain
// resolution); fragmented deep pieces fall back to raw with the depth
// machinery (periodic for off<=128 self-overlap).
inline int ring_emit_piece(RingTile& c, int64_t p0, int32_t span, int64_t m0,
                           int64_t off) {
    const RingShared& g = *c.g;
    int64_t rel = p0 - m0;
    int32_t d_raw;
    const uint8_t* dp = c.dloc;
    const int64_t ts = c.ts;
    if (skip_scan) {
        d_raw = 1;
    } else if (off <= 128 && rel + span > off) {
        int64_t A = m0 - off;
        if (A < c.ring_base) A += ((c.ring_base - A + off - 1) / off) * off;
        int64_t lo_s = A < ts ? ts : A;
        d_raw = lo_s < A + off
                    ? (int32_t)depth_range_max(dp, lo_s - ts, A + off - ts) + 1
                    : 0;
    } else {
        // non-wrapping (span <= off by piece construction when off > 128):
        // distinct sources are [p0-off, p0-off+span)
        int64_t s0 = p0 - off;
        int64_t lo_s = s0 < ts ? ts : s0;
        d_raw =
            lo_s < s0 + span
                ? (int32_t)depth_range_max(dp, lo_s - ts, s0 + span - ts) + 1
                : 0;
    }
    if (d_raw >= g.resolve_min_depth && !skip_origin) {
        c.deep_pieces++;
        // Lazy chase: recurse the piece's source span through the sparse
        // piece index until every byte telescopes to a comp position or a
        // pre-tile ring byte; usable when it fits the run budget and the
        // node budget (pathological chains — e.g. long off<=2 RLE — abort
        // and take the raw path, same as an unusable eager resolution).
        LazyRuns R;
        R.cap = g.resolve_runs < 64 ? g.resolve_runs : 64;
        R.node_budget = 8 * R.cap + 64;
        lazy_chase(c, p0 - off, p0 - off + span, R);
        if (prof_on) {
            prof_chase_nodes.fetch_add(R.nodes, std::memory_order_relaxed);
            if (!R.ok)
                prof_chase_aborts.fetch_add(1, std::memory_order_relaxed);
        }
        if (R.ok) {
            // Memoize: append the resolved mapping as index entries so later
            // chases through this span terminate in one step instead of
            // re-walking the chain (repetitive content chases the same hot
            // regions over and over — measured 27% of a single-threaded
            // build without the memo). A closing entry restores the raw
            // match mapping for the piece's tail positions; ring runs
            // memoize as synthetic offset entries (their offset may exceed
            // 65535 — it is an affine map, not a wire-format offset).
            int64_t p = p0;
            for (int32_t i = 0; i < R.n; i++) {
                int rc_;
                if (R.kind[i] == 0) {
                    idx_push(c, (int32_t)p, (int32_t)R.start[i]);
                    rc_ = ring_emit_lit(c, p, R.len[i], R.start[i]);
                } else {
                    idx_push(c, (int32_t)p, (int32_t)-(p - R.start[i]));
                    rc_ = ring_emit_plain(c, p, R.len[i], R.start[i]);
                }
                if (rc_) return rc_;
                p += R.len[i];
            }
            if (p < c.te) idx_push(c, (int32_t)p, (int32_t)-off);
            return 0;
        }
    }
    // raw forms (d_raw already covers the identical source ranges)
    if (off <= 128 && rel + span > off) {
        int64_t A = m0 - off;
        if (A < c.ring_base) A += ((c.ring_base - A + off - 1) / off) * off;
        // Known-window fast path: the period window is in-tile and already
        // final in the literal image — tile it across the piece directly.
        if (!skip_origin && !skip_scan && !no_mat && A >= c.ts &&
            d_raw == 1) {
            int64_t ph0 = (p0 - A) % off;
            for (int32_t k = 0; k < span;) {
                int32_t run = (int32_t)(off - ph0);
                if (run > span - k) run = span - k;
                std::memcpy(g.lit_init + p0 + k, g.lit_init + A + ph0,
                            (size_t)run);
                k += run;
                ph0 = 0;
            }
            return 0;
        }
        // Periodic pattern materialization: when the period window's bytes
        // all chase to comp positions, the host builds the <=128-byte
        // pattern and tiles it across the piece in the literal image —
        // emitting NO record. This removes the kernel's %P vector-division
        // path (and its per-fire branch) from every tile whose periodic
        // content originates in literals, letting those tiles take the
        // branch-free fire loop. out[p] == window[(p - A) mod off] because
        // A is period-aligned to the match source.
        if (!skip_origin && A >= c.ts) {
            LazyRuns R;
            R.cap = 32;
            R.node_budget = 160;
            lazy_chase(c, A, A + off, R);
            if (R.ok) {
                bool all_comp = true;
                for (int32_t i = 0; i < R.n; i++)
                    all_comp &= R.kind[i] == 0;
                if (all_comp) {
                    uint8_t pat[128];
                    int32_t w = 0;
                    for (int32_t i = 0; i < R.n; i++) {
                        std::memcpy(pat + w, g.input + R.start[i],
                                    (size_t)R.len[i]);
                        w += R.len[i];
                    }
                    int64_t ph0 = (p0 - A) % off;
                    for (int32_t k = 0; k < span;) {
                        int32_t run = (int32_t)(off - ph0);
                        if (run > span - k) run = span - k;
                        std::memcpy(g.lit_init + p0 + k, pat + ph0,
                                    (size_t)run);
                        k += run;
                        ph0 = 0;
                    }
                    return 0;  // bytes are final: depth stays 0, no record
                }
            }
        }
        // periodic raw record anchored at the period-aligned window
        int32_t lo = (int32_t)(p0 & 127);
        int32_t ph = (int32_t)(((rel - lo) % off + off) % off);
        return ring_emit_match(c, p0, span, A, (int32_t)off, ph, A, A + off,
                               d_raw);
    }
    if (rel + span > off && off > 128) {
        // self-overlap wrap: <= 2 plain records on period-aligned copies
        int64_t relm = rel % off;
        int64_t first = off - relm;
        if (first > span) first = span;
        int64_t s0 = m0 - off + relm;
        if (s0 < c.ring_base) s0 += ((c.ring_base - s0 + off - 1) / off) * off;
        if (int rc_ = ring_emit_plain(c, p0, (int32_t)first, s0)) return rc_;
        if (first < span) {
            int64_t p2 = p0 + first;
            int64_t s2 = m0 - off;
            if (s2 < c.ring_base)
                s2 += ((c.ring_base - s2 + off - 1) / off) * off;
            if (int rc_ = ring_emit_plain(c, p2, (int32_t)(span - first), s2))
                return rc_;
        }
        return 0;
    }
    return ring_emit_plain(c, p0, span, p0 - off, d_raw);
}

// Pass 1: serial token walk over every block into a global sequence table.
// `blk_store[b]` marks stored (uncompressed) blocks, which become
// literal-only pseudo-sequences. `independent` restricts match reach to the
// block's own output (the reference decodes independent-mode blocks with no
// dictionary, /root/reference/src/frame/decompress.rs:294-306).
// Parse -> tile-build overlap: the parser publishes (seq count, output
// position) as it walks; tile workers wait until the watermark passes their
// tile's end before building. `seqs` is reserved for the worst case up
// front (every sequence consumes >= 3 comp bytes except one 1-byte final
// per block), so push_back never reallocates while workers read.
struct RingWatermark {
    std::atomic<int64_t> n{0};     // published sequence count
    std::atomic<int64_t> opos{0};  // output position covered by those seqs
    std::atomic<int32_t> done{0};  // parser finished (any outcome)
};

// An adopted span of one speculative walk's sequence buffer, consumed IN
// PLACE by tile workers. The former assembly pass copied ~16 MB of RingSeq
// per 10 MB plan just to rebase out_off and validate positions; the rebase
// is now done at read time (out_off + delta) and each sequence is
// validated by the tile that owns its start position.
struct SeqView {
    const RingSeq* s;   // first adopted sequence
    int64_t n;          // adopted count
    int64_t delta;      // local out_off + delta == global out_off
    int64_t obase;      // independent-mode floor for offset validation
    int64_t gout0;      // global out_off of s[0] (search key)
    uint8_t validated;  // serial parse already validated positions
};

int64_t ring_parse_blocks(
    const uint8_t* input, size_t input_len,
    const int64_t* blk_off, const int64_t* blk_len, const uint8_t* blk_store,
    int32_t nblocks, int32_t independent, int64_t expected_out,
    std::vector<RingSeq>& seqs, int64_t* total_out,
    RingWatermark* wm = nullptr)
{
    int64_t opos = 0;
    int64_t nseq = 0;
    int64_t published = 0;
    auto publish = [&]() {
        wm->n.store(nseq, std::memory_order_release);
        wm->opos.store(opos, std::memory_order_release);
        published = nseq;
    };
    for (int32_t b = 0; b < nblocks; b++) {
        if (blk_off[b] < 0 || blk_len[b] < 0 ||
            (uint64_t)(blk_off[b] + blk_len[b]) > input_len)
            return TLZ4_ERR_LITERAL_OOB;
        size_t ip = (size_t)blk_off[b];
        const size_t end = ip + (size_t)blk_len[b];
        if (blk_store && blk_store[b]) {
            if (blk_len[b] == 0) continue;
            if (opos + blk_len[b] > expected_out) {
                *total_out = opos + blk_len[b];
                return TLZ4_ERR_OUTPUT_TOO_SMALL;
            }
            seqs.push_back({(int32_t)ip, (int32_t)opos,
                            (int32_t)blk_len[b], 0, 0, 0});
            opos += blk_len[b];
            nseq++;
            if (wm) publish();
            continue;
        }
        const int64_t obase = independent ? opos : 0;
        for (;;) {
            if (ip >= end) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
            uint8_t token = input[ip++];
            size_t ll = token >> 4;
            if (ll == 0xF) {
                for (;;) {
                    if (ip >= end) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                    uint8_t x = input[ip++];
                    ll += x;
                    if (x != 0xFF) break;
                }
            }
            if (ll > end - ip) return TLZ4_ERR_LITERAL_OOB;
            if (opos + (int64_t)ll > expected_out) {
                *total_out = opos + (int64_t)ll;
                return TLZ4_ERR_OUTPUT_TOO_SMALL;
            }
            RingSeq q;
            q.lit_start = (int32_t)ip;
            q.out_off = (int32_t)opos;
            q.lit_len = (int32_t)ll;
            ip += ll;
            opos += (int64_t)ll;
            if (ip >= end) {
                q.match_len = 0;
                q.match_off = 0;
                seqs.push_back(q);
                nseq++;
                if (wm) publish();
                break;
            }
            if (end - ip < 2) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
            size_t offset = load16(input + ip);
            ip += 2;
            if (offset == 0) return TLZ4_ERR_OFFSET_ZERO;
            size_t ml = token & 0xF;
            if (ml == 0xF) {
                for (;;) {
                    if (ip >= end) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
                    uint8_t x = input[ip++];
                    ml += x;
                    if (x != 0xFF) break;
                }
            }
            ml += MINMATCH;
            if (opos - (int64_t)offset < obase) return TLZ4_ERR_OFFSET_OOB;
            if (opos + (int64_t)ml > expected_out) {
                *total_out = opos + (int64_t)ml;
                return TLZ4_ERR_OUTPUT_TOO_SMALL;
            }
            q.match_off = (uint16_t)offset;
            q.match_len = (int32_t)ml;
            seqs.push_back(q);
            nseq++;
            opos += (int64_t)ml;
            if (wm && nseq - published >= 256) publish();
        }
    }
    *total_out = opos;
    return nseq;
}

// ---------------------------------------------------------------------------
// Parallel parse: block-level parallelism for frame bodies, SPECULATIVE
// segment splitting for big raw blocks. A speculative walk starts at an
// arbitrary byte offset; LZ4 token chains re-synchronize in practice (a
// mis-aligned walk consumes garbage tokens until its cursor coincides with
// a true token boundary, after which it IS the true walk). The serial
// stitch adopts each segment's walk from the exact position where the
// authoritative chain enters it — found by binary search over the walk's
// recorded token starts — and re-walks the segment serially when the chain
// never merged (correct for adversarial input, just slower). Position-
// dependent validation (offset lower bounds, output-size overflow) moves to
// the parallel assembly pass; structural validation (LSIC truncation,
// literal overruns, zero offsets) stays in the walks and only surfaces when
// the authoritative chain actually reaches the failure point.
// ---------------------------------------------------------------------------

struct alignas(128) ParseItem {  // two lines: keep workers' hot vector
                                 // headers (size/ptr updated every push)
                                 // off each other's cache lines
    int32_t blk = 0;
    uint8_t stored = 0;
    int64_t ip0 = 0, seg_end = 0;  // walk [ip0, first token start >= seg_end)
    std::vector<RingSeq> seqs;     // out_off = walk-local opos (starts at 0)
    int64_t end_ip = -1;  // first token start >= seg_end; -2 = hit block end
    int64_t out_total = 0;
    int64_t err = 0;  // structural parse error (real only if chain-adopted)
};

// Token start of sequence q, relative to ip0 — RECONSTRUCTED from the
// sequence record instead of stored per-seq (the former tok vector cost a
// push_back + 4 B of traffic per sequence in every speculative walk):
// lit_start - 1 (token byte) - LSIC extension byte count.
static inline int32_t tok_rel_of(const RingSeq& q, int64_t ip0) {
    int32_t ext = q.lit_len < 15 ? 0 : (q.lit_len - 15) / 255 + 1;
    return (int32_t)((int64_t)q.lit_start - ip0) - 1 - ext;
}

// Walk one segment. When `spec` is given (stitch repair), the walk stops as
// soon as its cursor lands on one of spec's recorded token starts — the two
// walks have merged and spec's tail is the true chain from there —
// reporting the merge index in *merge_k (-1 = walked to segment end without
// merging).
void parse_segment(const uint8_t* input, int64_t blk_end, ParseItem& it,
                   const ParseItem* spec = nullptr,
                   int64_t* merge_k = nullptr) {
    it.seqs.clear();
    it.end_ip = -1;
    it.out_total = 0;
    it.err = 0;
    size_t spec_cur = 0;
    if (merge_k) *merge_k = -1;
    if (it.stored) {
        if (blk_end > it.ip0)
            it.seqs.push_back(
                {(int32_t)it.ip0, 0, (int32_t)(blk_end - it.ip0), 0, 0, 0});
        it.out_total = blk_end - it.ip0;
        it.end_ip = -2;
        return;
    }
    int64_t ip = it.ip0;
    int64_t opos = 0;
    const bool last = it.seg_end >= blk_end;
    for (;;) {
        if (!last && ip >= it.seg_end) {
            it.end_ip = ip;
            break;
        }
        if (ip >= blk_end) {  // a block must end inside a literal-only seq
            it.err = TLZ4_ERR_EXPECTED_ANOTHER_BYTE;
            break;
        }
        if (spec) {  // monotone cursor: O(1) amortized merge detection
            int32_t rel = (int32_t)(ip - spec->ip0);
            const size_t sn = spec->seqs.size();
            while (spec_cur < sn &&
                   tok_rel_of(spec->seqs[spec_cur], spec->ip0) < rel)
                spec_cur++;
            if (spec_cur < sn &&
                tok_rel_of(spec->seqs[spec_cur], spec->ip0) == rel) {
                *merge_k = (int64_t)spec_cur;
                it.end_ip = ip;
                break;
            }
        }
        uint8_t token = input[ip++];
        int64_t ll = token >> 4;
        if (ll == 0xF) {
            for (;;) {
                if (ip >= blk_end) { it.err = TLZ4_ERR_EXPECTED_ANOTHER_BYTE; goto done; }
                uint8_t x = input[ip++];
                ll += x;
                if (x != 0xFF) break;
            }
        }
        if (ll > blk_end - ip) { it.err = TLZ4_ERR_LITERAL_OOB; break; }
        {
            RingSeq q;
            q.lit_start = (int32_t)ip;
            q.out_off = (int32_t)opos;
            q.lit_len = (int32_t)ll;
            ip += ll;
            opos += ll;
            if (ip >= blk_end) {
                q.match_len = 0;
                q.match_off = 0;
                it.seqs.push_back(q);
                it.end_ip = -2;
                break;
            }
            if (blk_end - ip < 2) { it.err = TLZ4_ERR_EXPECTED_ANOTHER_BYTE; break; }
            int64_t offset = load16(input + ip);
            ip += 2;
            if (offset == 0) { it.err = TLZ4_ERR_OFFSET_ZERO; break; }
            int64_t ml = token & 0xF;
            if (ml == 0xF) {
                for (;;) {
                    if (ip >= blk_end) { it.err = TLZ4_ERR_EXPECTED_ANOTHER_BYTE; goto done; }
                    uint8_t x = input[ip++];
                    ml += x;
                    if (x != 0xFF) break;
                }
            }
            ml += (int64_t)MINMATCH;
            q.match_off = (uint16_t)offset;
            q.match_len = (int32_t)ml;
            it.seqs.push_back(q);
            opos += ml;
        }
    }
done:
    it.out_total = opos;
}

// Pooled flat sequence buffer for the parallel parse (the assembly pass
// overwrites every slot, so value-initializing a std::vector per call would
// be a pure memset tax).
struct SeqBuf {
    RingSeq* p = nullptr;
    size_t cap = 0;
    ~SeqBuf() { std::free(p); }
    RingSeq* ensure(size_t n) {
        if (n > cap) {
            std::free(p);
            cap = (n + (1 << 16) - 1) & ~(size_t)((1 << 16) - 1);
            p = (RingSeq*)std::malloc(cap * sizeof(RingSeq));
        }
        return p;
    }
};

// Returns nseq (>=0: *views_out/*total_out valid) or a TLZ4_ERR_* code.
// The returned views alias thread_local walk buffers (items_tls /
// rewalks_tls) that stay valid until this thread's next parse call.
int64_t ring_parse_parallel(
    const uint8_t* input, size_t input_len,
    const int64_t* blk_off, const int64_t* blk_len, const uint8_t* blk_store,
    int32_t nblocks, int32_t independent, int64_t expected_out,
    const SeqView** views_out, size_t* nviews_out, int64_t* total_out,
    int32_t nth)
{
    static thread_local std::vector<ParseItem> items_tls;
    static thread_local std::deque<ParseItem> rewalks_tls;
    static thread_local std::vector<SeqView> views_tls;
    constexpr int64_t MIN_SEG = 256 * 1024;

    for (int32_t b = 0; b < nblocks; b++)
        if (blk_off[b] < 0 || blk_len[b] < 0 ||
            (uint64_t)(blk_off[b] + blk_len[b]) > input_len)
            return TLZ4_ERR_LITERAL_OOB;

    // Build (block, segment) items.
    std::vector<ParseItem>& items = items_tls;
    size_t ni = 0;
    auto item_at = [&](size_t i) -> ParseItem& {
        if (items.size() <= i) items.resize(i + 1);
        return items[i];
    };
    std::vector<std::pair<size_t, size_t>> blk_items(nblocks);
    for (int32_t b = 0; b < nblocks; b++) {
        size_t i0 = ni;
        if (blk_store && blk_store[b]) {
            if (blk_len[b] > 0) {
                ParseItem& it = item_at(ni++);
                it.blk = b; it.stored = 1;
                it.ip0 = blk_off[b];
                it.seg_end = blk_off[b] + blk_len[b];
            }
        } else {
            // Oversplit 4x past the lane count: segment walk speed varies
            // with content (LSIC density, literal run lengths), so equal-
            // byte segments finish unevenly — finer segments let the
            // work-stealing loop rebalance (measured walk 6.6 -> ~3 ms on
            // the 10 MB text corpus, 4 cores).
            int64_t W = blk_len[b] / MIN_SEG;
            if (W < 1) W = 1;
            if (W > 4 * nth) W = 4 * nth;
            int64_t seg = blk_len[b] / W;
            for (int64_t w = 0; w < W; w++) {
                ParseItem& it = item_at(ni++);
                it.blk = b; it.stored = 0;
                it.ip0 = blk_off[b] + w * seg;
                it.seg_end =
                    (w + 1 == W) ? blk_off[b] + blk_len[b]
                                 : blk_off[b] + (w + 1) * seg;
            }
        }
        blk_items[b] = {i0, ni};
    }

    // Parallel walks.
    auto pp0 = std::chrono::steady_clock::now();
    {
        std::atomic<size_t> next{0};
        auto pwork = [&]() {
            for (;;) {
                size_t i = next.fetch_add(1);
                if (i >= ni) break;
                ParseItem& it = items[i];
                parse_segment(input, blk_off[it.blk] + blk_len[it.blk], it);
            }
        };
        size_t pool_n = ni < (size_t)nth ? ni : (size_t)nth;
        g_pool.run((int)pool_n, pwork);
    }

    auto pp1 = std::chrono::steady_clock::now();
    // Serial stitch: chain the authoritative walk through the segments,
    // emitting one SeqView per adopted span (consumed in place by tiles).
    std::vector<SeqView>& views = views_tls;
    views.clear();
    std::deque<ParseItem>& rewalks = rewalks_tls;
    rewalks.clear();
    int64_t G = 0, gseq = 0;
    for (int32_t b = 0; b < nblocks; b++) {
        const int64_t obase = independent ? G : 0;
        auto [i0, i1] = blk_items[b];
        if (i0 == i1) continue;  // empty stored block
        const int64_t bend = blk_off[b] + blk_len[b];
        int64_t L = blk_off[b];
        bool done = false;
        for (size_t i = i0; i < i1 && !done; i++) {
            const ParseItem* it = &items[i];
            if (it->end_ip != -2 && L >= it->seg_end) continue;  // swallowed
            int64_t k = -1;
            if (L == it->ip0) {
                k = 0;
            } else if (L > it->ip0 && !it->stored && !it->seqs.empty()) {
                int32_t rel = (int32_t)(L - it->ip0);
                const int64_t ip0 = it->ip0;
                auto lo = std::lower_bound(
                    it->seqs.begin(), it->seqs.end(), rel,
                    [ip0](const RingSeq& q, int32_t r) {
                        return tok_rel_of(q, ip0) < r;
                    });
                if (lo != it->seqs.end() && tok_rel_of(*lo, ip0) == rel)
                    k = lo - it->seqs.begin();
            }
            if (k < 0) {
                // Chain enters off this walk's token set: repair-walk from
                // L, stopping as soon as the cursor lands on one of the
                // speculative walk's token starts (the walks merged — its
                // tail is authoritative from there).
                rewalks.emplace_back();
                ParseItem& rw = rewalks.back();
                rw.blk = b; rw.stored = 0;
                rw.ip0 = L;
                rw.seg_end = it->seg_end;
                int64_t mk = -1;
                parse_segment(input, bend, rw, it, &mk);
                if (rw.err) return rw.err;  // repair IS the true chain
                if (!rw.seqs.empty()) {
                    views.push_back({rw.seqs.data(),
                                     (int64_t)rw.seqs.size(), G, obase, G,
                                     0});
                    gseq += (int64_t)rw.seqs.size();
                }
                G += rw.out_total;
                if (rw.end_ip == -2) { done = true; break; }
                if (mk < 0) {  // walked the whole segment without merging
                    L = rw.end_ip;
                    continue;
                }
                k = mk;  // merged mid-segment: adopt the speculative tail
            }
            if (it->err) return it->err;  // chain-confirmed structural error
            int64_t local0 =
                k < (int64_t)it->seqs.size() ? it->seqs[k].out_off : it->out_total;
            if ((int64_t)it->seqs.size() > k) {
                views.push_back({it->seqs.data() + k,
                                 (int64_t)it->seqs.size() - k, G - local0,
                                 obase, G, 0});
                gseq += (int64_t)it->seqs.size() - k;
            }
            G += it->out_total - local0;
            if (it->end_ip == -2) done = true;
            else L = it->end_ip;
        }
        if (!done) return TLZ4_ERR_EXPECTED_ANOTHER_BYTE;  // unreachable
    }
    *total_out = G;
    if (prof_on) {
        auto pp2 = std::chrono::steady_clock::now();
        std::fprintf(
            stderr,
            "[tlz4 pparse] %zu items: walk %.1f ms  stitch %.1f ms "
            "(%zu rewalks, %zu views)\n",
            ni, std::chrono::duration<double, std::milli>(pp1 - pp0).count(),
            std::chrono::duration<double, std::milli>(pp2 - pp1).count(),
            rewalks.size(), views.size());
    }
    *views_out = views.data();
    *nviews_out = views.size();
    return gseq;
}

// Pass 2, one tile: record emission (+ lazy origin chases) for [ts, te).
// Reads g.depth and the piece index only inside the tile, so tiles are
// independent.
int ring_build_tile(const RingShared& g, const SeqView* views,
                    size_t nviews, const RingWatermark* wm, int32_t t,
                    int64_t* err_total) {
    auto tt0 = std::chrono::steady_clock::now();
    // Per-worker reusable stream state: chunk arena and stream headers
    // persist across tiles and calls (the pool keeps workers alive), so
    // the steady state allocates nothing.
    static thread_local RecArena arena_tls;
    static thread_local std::vector<GroupStream> gs_tls;
    static thread_local std::vector<int64_t> pidx_tls;
    static thread_local std::vector<int32_t> rowidx_tls;
    static thread_local std::vector<uint8_t> depth_tls;
    RingTile c;
    c.g = &g;
    c.t = t;
    arena_tls.reset();
    gs_tls.clear();
    pidx_tls.clear();
    if ((int32_t)rowidx_tls.size() < g.tile_rows + 1)
        rowidx_tls.resize(g.tile_rows + 1);
    c.arena = &arena_tls;
    c.gs = &gs_tls;
    c.pidx = &pidx_tls;
    c.rowidx = &rowidx_tls;
    c.filled_row = -1;
    c.tbase = (int64_t)t * g.rb * g.nfmax;
    c.row_mask = (g.tile_rows & (g.tile_rows - 1)) == 0 ? g.tile_rows - 1 : 0;
    c.ts = ((int64_t)t * g.tile_rows) << 7;
    c.te = c.ts + (((int64_t)g.tile_rows) << 7);
    // Per-worker tile-local depth scratch (32 KiB + 64 B SIMD-overread
    // slack), pre-zeroed so the dominant depth value (0: literal bytes,
    // pre-tile-source and resolved matches) needs no per-span fills — only
    // nonzero depths write. The buffer persists across tiles and calls
    // (L2-resident), replacing the former global expected_out-sized scratch
    // that streamed ~1 byte of DRAM per output byte.
    const size_t dsz = ((size_t)g.tile_rows << 7) + 64;
    if (depth_tls.size() < dsz) depth_tls.resize(dsz);
    c.dloc = depth_tls.data();
    if (!skip_set) std::memset(c.dloc, 0, dsz);
    // Match-covered lit_init bytes are zeroed span-by-span in the seq loop
    // below (cheaper than a whole-tile pre-memset: literal bytes get
    // written exactly once); only the beyond-output tail needs zeroing
    // here so plans stay byte-deterministic across pool generations.
    if (c.te > g.expected_out) {
        int64_t z0 = g.expected_out > c.ts ? g.expected_out : c.ts;
        std::memset(g.lit_init + z0, 0, (size_t)(c.te - z0));
    }
    c.ring_base = c.ts - (((int64_t)g.window_rows) << 7);

    // Wait for the parser to pass this tile's end before reading seqs.
    if (wm) {
        int64_t te_eff = c.te < g.expected_out ? c.te : g.expected_out;
        // Sleep, don't spin: oversubscribed waiters yielding in a tight
        // loop starve the serial parser on small hosts (measured 15 ms ->
        // 113 ms parse with 8 spinning waiters on 4 cores).
        while (wm->opos.load(std::memory_order_acquire) < te_eff &&
               !wm->done.load(std::memory_order_acquire))
            std::this_thread::sleep_for(std::chrono::microseconds(50));
        if (wm->opos.load(std::memory_order_acquire) < te_eff)
            return 0;  // parse failed/short: the whole result is discarded
    }

    // locate (view, seq): last sequence with global out_off <= ts
    size_t vlo = 0, vhi = nviews;
    while (vlo < vhi) {
        size_t mid = (vlo + vhi) / 2;
        if (views[mid].gout0 <= c.ts) vlo = mid + 1; else vhi = mid;
    }
    size_t vi = vlo > 0 ? vlo - 1 : 0;
    size_t i = 0;
    if (vi < nviews) {
        const SeqView& V0 = views[vi];
        size_t lo = 0, hi = (size_t)V0.n;
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (V0.s[mid].out_off + V0.delta <= c.ts) lo = mid + 1;
            else hi = mid;
        }
        i = lo > 0 ? lo - 1 : 0;
    }

    for (; vi < nviews; vi++, i = 0)
    for (const SeqView& V = views[vi]; i < (size_t)V.n; i++) {
        const RingSeq& q = V.s[i];
        const int64_t oo = q.out_off + V.delta;
        if (oo >= c.te) goto seqs_done;
        // Deferred positional validation, run by the owning tile (the
        // first tile at or after the sequence's start position).
        if (!V.validated && oo >= c.ts) {
            int64_t oafter = oo + q.lit_len;
            if (oafter > g.expected_out) {
                *err_total = oafter;
                return TLZ4_ERR_OUTPUT_TOO_SMALL;
            }
            if (q.match_len > 0) {
                if (oafter - q.match_off < V.obase)
                    return TLZ4_ERR_OFFSET_OOB;
                if (oafter + q.match_len > g.expected_out) {
                    *err_total = oafter + q.match_len;
                    return TLZ4_ERR_OUTPUT_TOO_SMALL;
                }
            }
        }
        // literal fragment [oo, oo+ll) from comp [lit_start, ...)
        int64_t l1 = oo + q.lit_len;
        int64_t p = oo < c.ts ? c.ts : oo;
        int64_t pe = l1 < c.te ? l1 : c.te;
        if (p < pe) {
            int64_t csrc = q.lit_start + (p - oo);
            idx_push(c, (int32_t)p, (int32_t)csrc);
            if (int rc_ = ring_emit_lit_frag(c, p, pe, csrc)) return rc_;
        }
        if (q.match_len <= 0) continue;
        // match fragment [m0, m0+ml)
        const int64_t m0 = l1;
        const int64_t off = (int64_t)q.match_off;
        int64_t mp = m0 < c.ts ? c.ts : m0;
        int64_t me = m0 + q.match_len < c.te ? m0 + q.match_len : c.te;
        if (mp >= me) continue;
        // Match spans in the literal image stay UNINITIALIZED (pooled
        // np.empty garbage): every match byte is covered by exactly one
        // fire record or by a resolved-literal memcpy, so the kernel's
        // in-place overwrites make the decoded output exact regardless.
        // TLZ4_DETERMINISTIC=1 restores the zero fill (byte-identical
        // lit_init images across pool generations, for plan diffing).
        if (deterministic_fill)
            std::memset(g.lit_init + mp, 0, (size_t)(me - mp));
        // Index the match for the lazy chase (one entry per match, not per
        // row-piece: fewer entries, fewer recursion splits).
        idx_push(c, (int32_t)mp, (int32_t)-off);
        int64_t pp = mp, rem = me - mp;
        while (rem > 0) {
            int32_t span = (int32_t)(128 - (pp & 127));
            if (span > rem) span = (int32_t)rem;
            if (int rc_ = ring_emit_piece(c, pp, span, m0, off)) return rc_;
            pp += span; rem -= span;
        }
    }
seqs_done:
    if (skip_pack) { g.nf_tot[t] = 0; return 0; }
    if (prof_on) {
        auto tp = std::chrono::steady_clock::now();
        prof_emit_ns.fetch_add(
            std::chrono::duration_cast<std::chrono::nanoseconds>(tp - tt0)
                .count(),
            std::memory_order_relaxed);
        int rc = ring_pack_tile(c);
        prof_pack_ns.fetch_add(
            std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - tp)
                .count(),
            std::memory_order_relaxed);
        prof_recs.fetch_add(c.nrec, std::memory_order_relaxed);
        if (c.deep_pieces) {
            prof_deep_tiles.fetch_add(1, std::memory_order_relaxed);
            prof_deep_pieces.fetch_add(c.deep_pieces,
                                       std::memory_order_relaxed);
        }
        return rc;
    }
    return ring_pack_tile(c);
}
}  // namespace

TLZ4_API int64_t tlz4_build_ring_plan2(
    const uint8_t* input, size_t input_len,
    const int64_t* blk_off, const int64_t* blk_len, const uint8_t* blk_store,
    int32_t nblocks, int32_t independent, int64_t expected_out,
    int32_t tile_rows, int32_t window_rows, int32_t rb, int32_t nfmax,
    int32_t ntiles, int32_t resolve_min_depth, int32_t resolve_runs,
    int32_t nthreads,
    int32_t* f0, int32_t* f1, int32_t* f2,
    int32_t* nf_tot, int32_t* fper, uint8_t* lit_init,
    int64_t* total_out)
{
    // int32 positions throughout the plan (RingSeq, piece index, record
    // fields): one plan is bounded to <2 GiB of comp and output — callers
    // fall back on the overflow code (such a plan would need ~10 GiB of
    // record arrays regardless; the frame layer batches long streams).
    if (input_len >= (size_t)INT32_MAX || expected_out >= (int64_t)INT32_MAX)
        return TLZ4_PLAN_OVERFLOW;
#ifdef MADV_HUGEPAGE
    // Ask for transparent hugepages on the big pooled buffers (the record
    // fields and the literal image are tens of MB, touched with ~random
    // per-record stores — 4 KiB TLB entries miss constantly). Repeated
    // madvise on the same (pooled, persistent) ranges is cheap; failures
    // are advisory and ignored.
    {
        auto thp = [](const void* p, size_t len) {
            uintptr_t a = (uintptr_t)p & ~(uintptr_t)4095;
            size_t l = ((uintptr_t)p + len + 4095 & ~(uintptr_t)4095) - a;
            madvise((void*)a, l, MADV_HUGEPAGE);
        };
        size_t recs = (size_t)ntiles * nfmax * rb * 4;
        thp(f0, recs);
        thp(f1, recs);
        thp(f2, recs);
        thp(lit_init, (size_t)ntiles * tile_rows * 128);
    }
#endif
    const bool prof = std::getenv("TLZ4_PLAN_PROF") != nullptr;
    prof_on = prof;
    if (const char* sk = std::getenv("TLZ4_SKIP")) {
        skip_origin = std::strstr(sk, "origin") != nullptr;
        skip_scan = std::strstr(sk, "scan") != nullptr;
        skip_set = std::strstr(sk, "set") != nullptr;
        skip_pack = std::strstr(sk, "pack") != nullptr;
        skip_push = std::strstr(sk, "push") != nullptr;
        skip_lit = std::strstr(sk, "lit") != nullptr;
        skip_idx = std::strstr(sk, "idx") != nullptr;
        skip_mat = std::strstr(sk, "mat") != nullptr;
    } else {
        skip_origin = skip_scan = skip_set = false;
        skip_pack = skip_push = false;
        skip_lit = skip_idx = skip_mat = false;
    }
    {
        hard_groups = std::getenv("TLZ4_HARD_GROUPS") != nullptr;
        const char* dp = std::getenv("TLZ4_DENSE_PACK");
        dense_pack = dp ? dp[0] != '0' : tile_rows >= 512;
        deterministic_fill = std::getenv("TLZ4_DETERMINISTIC") != nullptr;
        no_mat = std::getenv("TLZ4_NO_MAT") != nullptr;
        // NT record stores iff the packed field arrays wouldn't comfortably
        // fit the last-level cache (see stream_copy_i32). TLZ4_NT=0/1
        // overrides for A/B.
        static const long l3 = [] {
            long v = 0;
#ifdef _SC_LEVEL3_CACHE_SIZE
            v = sysconf(_SC_LEVEL3_CACHE_SIZE);
#endif
            return v > 0 ? v : 8L << 20;  // unknown: assume small
        }();
        int64_t plan_bytes = (int64_t)ntiles * nfmax * rb * 12;
        use_nt_stores = plan_bytes * 2 > l3;
        if (const char* nt = std::getenv("TLZ4_NT"))
            use_nt_stores = nt[0] != '0';
    }
    if (prof) {
        prof_emit_ns.store(0); prof_pack_ns.store(0); prof_recs.store(0);
        prof_deep_tiles.store(0); prof_deep_pieces.store(0);
        prof_chase_nodes.store(0); prof_chase_aborts.store(0);
        for (auto& a : prof_gfires) a.store(0);
        for (auto& a : prof_gslots) a.store(0);
    }
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto t0 = now();
    // Worst-case capacity so push_back never reallocates while tile workers
    // read concurrently: every non-final sequence consumes >= 3 comp bytes
    // (token + 2-byte offset), plus one short final sequence per block.
    // thread_local + clear(): capacity (and its faulted-in pages) persists
    // across calls — fresh per-call vectors cost a page-fault storm.
    // CAREFUL: lambdas do NOT capture thread_local statics — each worker
    // would silently resolve `seqs` to its own empty instance (observed
    // segfault). Workers must go through this caller-thread reference.
    static thread_local std::vector<RingSeq> seqs_tls;

    RingShared g{tile_rows, window_rows, ntiles, rb, nfmax,
                 resolve_min_depth, resolve_runs, expected_out, input,
                 (int64_t)input_len, f0, f1, f2, nf_tot, fper, lit_init};
    RingWatermark wm;
    std::atomic<int32_t> next{0};
    std::atomic<int32_t> err{0};  // stop flag; details ordered by tile below
    const SeqView* views = nullptr;
    size_t nviews = 0;
    // First error in TILE order wins (deterministic across thread counts:
    // tile order == stream order for the deferred positional checks).
    std::mutex err_mu;
    int32_t err_tile = INT32_MAX;
    int64_t err_code = 0, err_tot = 0;
    auto work = [&]() {
        for (;;) {
            int32_t t = next.fetch_add(1);
            if (t >= ntiles || err.load(std::memory_order_relaxed)) break;
            int64_t etot = 0;
            if (int rc = ring_build_tile(g, views, nviews, &wm, t, &etot)) {
                std::lock_guard<std::mutex> el(err_mu);
                if (t < err_tile) {
                    err_tile = t;
                    err_code = rc;
                    err_tot = etot;
                }
                err.store(1, std::memory_order_relaxed);
            }
        }
    };
    // Lane count == core count: the build is CPU-bound (the 260 MB-L3 dev
    // Xeon holds the whole working set; 46 GB/s of 4-thread copy bandwidth
    // vs ~70 MB of plan traffic), so oversubscription only adds context
    // switches — 2x lanes measured +2 ms on the 10 MB plan.
    int32_t nth = nthreads > 0 ? nthreads
                               : (int32_t)std::thread::hardware_concurrency();
    if (nth < 1) nth = 1;

    // Parse: parallel (block items + speculative segments) for big inputs,
    // the serial walk otherwise (thread-spawn overhead beats the win below
    // ~1 MB). The phases (parse -> tiles) stay sequential ON PURPOSE:
    // overlapping them was measured a net LOSS on a small host — tile
    // workers saturate the memory bus and stretch the bandwidth-sensitive
    // parse 15 -> ~107 ms wall. The watermark machinery stays (workers
    // built against it are correct either way) with done pre-published, so
    // ring_build_tile never waits.
    int64_t nseq;
    static thread_local SeqView serial_view;
    const bool par = nth > 1 && input_len <= (size_t)INT32_MAX &&
                     (input_len >= (1u << 20) || nblocks >= 4) &&
                     !std::getenv("TLZ4_SERIAL_PARSE");
    if (par) {
        nseq = ring_parse_parallel(
            input, input_len, blk_off, blk_len, blk_store, nblocks,
            independent, expected_out, &views, &nviews, total_out, nth);
    } else {
        std::vector<RingSeq>& seqs = seqs_tls;
        seqs.clear();
        // Worst-case capacity so push_back never reallocates while workers
        // read: every non-final sequence consumes >= 3 comp bytes, plus one
        // short final sequence per block. thread_local + clear(): capacity
        // (and its faulted-in pages) persists across calls.
        seqs.reserve(input_len / 3 + (size_t)nblocks + 8);
        nseq = ring_parse_blocks(
            input, input_len, blk_off, blk_len, blk_store, nblocks,
            independent, expected_out, seqs, total_out, &wm);
        // one pre-validated view over the whole serial table
        serial_view = {seqs.data(), nseq > 0 ? nseq : 0, 0, 0, 0, 1};
        views = &serial_view;
        nviews = 1;
    }
    auto t1 = now();
    if (nseq < 0) return nseq;
    if (*total_out != expected_out) return nseq;  // caller raises size error
    wm.n.store(nseq, std::memory_order_release);
    wm.opos.store(*total_out, std::memory_order_release);
    wm.done.store(1, std::memory_order_release);

    if (nth > ntiles) nth = ntiles;
    g_pool.run(nth, work);
    if (err_code) {
        if (err_code == TLZ4_ERR_OUTPUT_TOO_SMALL) *total_out = err_tot;
        return err_code;
    }
    if (prof) {
        auto t2 = now();
        std::fprintf(
            stderr,
            "[tlz4 plan] parse %.1f ms  total %.1f ms (%d threads)  "
            "emit %.1f ms-cpu  pack %.1f ms-cpu  %lld recs  "
            "deep tiles %lld/%d pieces %lld nodes %lld aborts %lld\n",
            std::chrono::duration<double, std::milli>(t1 - t0).count(),
            std::chrono::duration<double, std::milli>(t2 - t0).count(), nth,
            prof_emit_ns.load() / 1e6, prof_pack_ns.load() / 1e6,
            (long long)prof_recs.load(), (long long)prof_deep_tiles.load(),
            ntiles, (long long)prof_deep_pieces.load(),
            (long long)prof_chase_nodes.load(),
            (long long)prof_chase_aborts.load());
        std::fprintf(stderr, "[tlz4 plan] group (fires, kslots):");
        for (int i = 0; i < 18; i++)
            if (prof_gfires[i].load())
                std::fprintf(stderr, " g%d(%lld, %lld)", i,
                             (long long)prof_gfires[i].load(),
                             (long long)(prof_gslots[i].load() / 1000));
        std::fprintf(stderr, "\n");
    }
    return nseq;
}

// ---------------------------------------------------------------------------
// Hybrid encoder: host greedy walk over device-found match candidates
// ---------------------------------------------------------------------------
//
// The TPU finds, for every position, the 4 closest previous occurrences of
// its 4-byte word (exact, via lexicographic sort — ops/encode.py
// candidates_core); this walk turns them into a spec-valid LZ4 block the
// same way the reference's compress_internal turns hash-table probes into
// one (/root/reference/src/block/compress.rs:318-489): exact forward
// extension, one-step lazy deferral, backward extension over the pending
// literal run, LSIC emission, MFLIMIT/END_OFFSET end rules. Every candidate
// is re-verified with exact byte compares, so device output is never
// correctness-critical — garbage candidates only cost ratio.
//
// G is the stream: ext_dict ++ data, data starting at dict_len. Candidate
// rows cover chunks of G (the device kernel's fixed compile shape):
// chunk r spans G[gstart[r], gstart[r]+...) with its data region starting
// at gstart[r]+dvec[r]; the data regions partition [dict_len, g_len).
// d12/d34 pack per-position back-distances (d1 | d2<<16, d3 | d4<<16),
// closest first, 0 = none.

namespace {
// Exact match length of G[p..] vs G[c..], capped at `limit` bytes.
// Reads stay under p+limit, so callers capping limit at n-5 never overread.
inline int64_t hybrid_match_len(const uint8_t* G, int64_t p, int64_t c,
                                int64_t limit) {
    int64_t l = 0;
    while (l + 8 <= limit) {
        uint64_t x = load64(G + p + l) ^ load64(G + c + l);
        if (x) return l + (int64_t)(__builtin_ctzll(x) >> 3);
        l += 8;
    }
    while (l < limit && G[p + l] == G[c + l]) l++;
    return l;
}

struct HybridCands {
    const uint32_t* d12;
    const uint32_t* d34;
    const int64_t* gstart;
    const int32_t* dvec;
    int32_t nrows;
    int64_t pad;
};

// Best candidate at global position p (row = chunk containing p):
// longest exact match, ties to the closest. Returns length (0 if < MINMATCH).
inline int64_t hybrid_best(const HybridCands& C, const uint8_t* G, int64_t p,
                           int64_t n, int32_t row, uint32_t* best_delta) {
    int64_t plocal = p - C.gstart[row];
    uint32_t a = C.d12[(int64_t)row * C.pad + plocal];
    uint32_t b = C.d34[(int64_t)row * C.pad + plocal];
    uint32_t deltas[4] = {a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16};
    int64_t limit = n - 5 - p;
    int64_t best = 0;
    uint32_t bd = 0;
    for (int j = 0; j < 4; j++) {
        uint32_t d = deltas[j];
        if (!d || (int64_t)d > p) continue;
        int64_t l = hybrid_match_len(G, p, p - (int64_t)d, limit);
        if (l > best) { best = l; bd = d; }
    }
    if (best < (int64_t)MINMATCH) return 0;
    *best_delta = bd;
    return best;
}
}  // namespace

TLZ4_API int64_t tlz4_compress_with_candidates(
    const uint8_t* G, int64_t g_len, int64_t dict_len,
    const uint32_t* d12, const uint32_t* d34,
    const int64_t* gstart, const int32_t* dvec, int32_t nrows, int64_t pad,
    uint8_t* out, int64_t out_cap)
{
    HybridCands C{d12, d34, gstart, dvec, nrows, pad};
    const int64_t n = g_len;
    int64_t op = 0;
    int64_t lit_start = dict_len;
    int64_t p = dict_len;
    int32_t row = 0;

    auto data_end = [&](int32_t r) -> int64_t {
        return r + 1 < nrows ? gstart[r + 1] + dvec[r + 1] : n;
    };
    auto write_lsic = [&](int64_t v) {
        while (v >= 255) { out[op++] = 255; v -= 255; }
        out[op++] = (uint8_t)v;
    };

    if (n - dict_len < (int64_t)LZ4_MIN_LENGTH) p = n;  // all-literal tiny block
    while (p + (int64_t)MFLIMIT <= n) {
        while (row + 1 < nrows && p >= data_end(row)) row++;
        uint32_t bd;
        int64_t l = hybrid_best(C, G, p, n, row, &bd);
        if (!l) { p++; continue; }
        if (p + (int64_t)MFLIMIT + 1 <= n) {
            // one-step lazy deferral: a strictly longer match at p+1 wins
            int32_t row2 = row;
            while (row2 + 1 < nrows && p + 1 >= data_end(row2)) row2++;
            uint32_t bd2;
            int64_t l2 = hybrid_best(C, G, p + 1, n, row2, &bd2);
            if (l2 > l) { p++; continue; }
        }
        // backward extension over the pending literal run
        int64_t c = p - (int64_t)bd;
        int64_t b = 0;
        while (p - b > lit_start && c - b > 0 && G[p - b - 1] == G[c - b - 1])
            b++;
        int64_t ll = (p - b) - lit_start;
        int64_t mlc = l + b - (int64_t)MINMATCH;
        if (op + 1 + ll / 255 + 1 + ll + 2 + mlc / 255 + 1 > out_cap)
            return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4
                              | (mlc < 15 ? mlc : 15));
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
        store16(out + op, (uint16_t)bd);
        op += 2;
        if (mlc >= 15) write_lsic(mlc - 15);
        p += l;
        lit_start = p;
    }
    // literal-only last sequence (spec end rule)
    {
        int64_t ll = n - lit_start;
        if (op + 1 + ll / 255 + 1 + ll > out_cap) return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4);
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
    }
    return op;
}

// Streaming variant: one 2:1 max-pooled u16 best-delta plane per chunk row
// (device-selected best-of-4 with capped exact scoring — ops/encode.py
// best_plane_core; plane[i] covers row-local positions 2i and 2i+1), the
// walk resumable per row so row i's walk overlaps row i+1's device->host
// transfer. state = {p, lit_start, op}; emits sequences whose cursor starts
// in [state->p, row_limit), final_row==1 appends the spec last-literals run.
// Every plane value is re-verified against G with exact byte compares, so
// stale/garbage plane slots (row padding, the pooled neighbor's delta, lazy
// probe past the data region) are ratio-only, never correctness.
// Chunk-parallel hybrid walk (round 5): one SELF-CONTAINED walk per
// ~508 KiB chunk — the chunk's dictionary is simply the preceding 64 KiB
// of the stream (G is the whole stream, offsets reach back freely), so
// chunks need no carried state and walk on independent host threads
// (4 cores ~= 4x the serial walk; PERF.md round-5 #4). Differences from
// the serial resumable walk: matches cap at the chunk limit (one
// truncated match per ~508 KiB — ratio noise), and a non-final chunk
// leaves its trailing literal run PENDING (*lit_tail) instead of
// emitting it: a literal-only sequence is only legal at block end, so
// tlz4_hybrid_stitch merges each pending run into the next chunk's first
// sequence header at assembly. Reference analog: one sequential pass
// (/root/reference/src/block/compress.rs:318-489); the chunking is the
// TPU build's data-parallel decomposition of it.
TLZ4_API int64_t tlz4_hybrid_walk_chunk(
    const uint8_t* G, int64_t g_len,
    const uint16_t* plane, int64_t row_gstart, int64_t chunk_start,
    int64_t chunk_limit, int64_t plane_len, int32_t pool_shift,
    uint8_t* out, int64_t out_cap, int32_t final_chunk,
    int64_t* lit_tail)
{
    const int64_t n = g_len;
    int64_t p = chunk_start;
    int64_t lit_start = chunk_start;
    int64_t op = 0;

    auto write_lsic = [&](int64_t v) {
        while (v >= 255) { out[op++] = 255; v -= 255; }
        out[op++] = (uint8_t)v;
    };
    auto probe = [&](int64_t q, uint32_t* d_out) -> int64_t {
        int64_t pl = (q - row_gstart) >> pool_shift;
        if (q < row_gstart || pl >= plane_len) return 0;
        uint32_t d = plane[pl];
        if (!d || (int64_t)d > q) return 0;
        int64_t cap = n - 5 - q;
        if (!final_chunk && chunk_limit - q < cap) cap = chunk_limit - q;
        int64_t l = hybrid_match_len(G, q, q - (int64_t)d, cap);
        if (l < (int64_t)MINMATCH) return 0;
        *d_out = d;
        return l;
    };

    while (p + (int64_t)MFLIMIT <= n && p < chunk_limit) {
        uint32_t bd;
        int64_t l = probe(p, &bd);
        if (!l) { p++; continue; }
        if (p + (int64_t)MFLIMIT + 1 <= n && p + 1 < chunk_limit) {
            uint32_t bd2;
            int64_t l2 = probe(p + 1, &bd2);
            if (l2 > l) { p++; continue; }
        }
        int64_t c = p - (int64_t)bd;
        int64_t b = 0;
        while (p - b > lit_start && c - b > 0 && G[p - b - 1] == G[c - b - 1])
            b++;
        int64_t ll = (p - b) - lit_start;
        int64_t mlc = l + b - (int64_t)MINMATCH;
        if (op + 1 + ll / 255 + 1 + ll + 2 + mlc / 255 + 1 > out_cap)
            return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4
                              | (mlc < 15 ? mlc : 15));
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
        store16(out + op, (uint16_t)bd);
        op += 2;
        if (mlc >= 15) write_lsic(mlc - 15);
        p += l;
        lit_start = p;
    }
    if (final_chunk) {
        int64_t ll = n - lit_start;
        if (op + 1 + ll / 255 + 1 + ll > out_cap) return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4);
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
        lit_start = n;
    }
    *lit_tail = lit_start;
    return op;
}

// Assemble chunk-parallel walk outputs into one spec-valid block: chunk
// wires concatenate verbatim except that each pending literal tail from
// chunk i merges into chunk i+1's first sequence (token/LSIC rewritten to
// lit_len + pending, pending bytes copied from G before the original
// literal run). Chunks whose walk found no match contribute no wire and
// extend the pending run.
TLZ4_API int64_t tlz4_hybrid_stitch(
    const uint8_t* G, int64_t g_len,
    const uint8_t* wires, const int64_t* wire_off, const int64_t* wire_len,
    const int64_t* chunk_start, const int64_t* lit_tail, int32_t nchunks,
    uint8_t* out, int64_t out_cap)
{
    (void)g_len;
    int64_t op = 0;
    int64_t pend = -1;  // pending literal run start in G (exclusive end =
                        // next chunk's start — runs are contiguous)
    auto write_lsic = [&](int64_t v) {
        while (v >= 255) { out[op++] = 255; v -= 255; }
        out[op++] = (uint8_t)v;
    };
    for (int32_t i = 0; i < nchunks; i++) {
        const uint8_t* w = wires + wire_off[i];
        int64_t wl = wire_len[i];
        if (wl == 0) {
            // matchless chunk: all of it is literal, pending extends
            // (lit_tail[i] == chunk_start[i] here)
            if (pend < 0) pend = chunk_start[i];
            continue;
        }
        if (pend >= 0) {
            int64_t extra = chunk_start[i] - pend;
            // parse the first sequence's token + LSIC
            int64_t ip = 0;
            uint8_t tok = w[ip++];
            int64_t ll = tok >> 4;
            if (ll == 15) {
                for (;;) {
                    uint8_t x = w[ip++];
                    ll += x;
                    if (x != 0xFF) break;
                }
            }
            int64_t nll = ll + extra;
            if (op + 1 + nll / 255 + 1 + extra + (wl - ip) > out_cap)
                return -1;
            out[op++] = (uint8_t)((nll < 15 ? nll : 15) << 4 | (tok & 0xF));
            if (nll >= 15) write_lsic(nll - 15);
            std::memcpy(out + op, G + pend, (size_t)extra);
            op += extra;
            std::memcpy(out + op, w + ip, (size_t)(wl - ip));
            op += wl - ip;
            pend = -1;
        } else {
            if (op + wl > out_cap) return -1;
            std::memcpy(out + op, w, (size_t)wl);
            op += wl;
        }
        if (i < nchunks - 1) pend = lit_tail[i];
        // zero-length pending (match ended exactly at the chunk limit) is
        // handled by the merge path with extra == 0
    }
    return op;
}

TLZ4_API int64_t tlz4_hybrid_walk_row(
    const uint8_t* G, int64_t g_len,
    const uint16_t* plane, int64_t row_gstart, int64_t row_limit,
    int64_t plane_len, int32_t pool_shift, int64_t* state, uint8_t* out,
    int64_t out_cap, int32_t final_row)
{
    const int64_t n = g_len;
    int64_t p = state[0];
    int64_t lit_start = state[1];
    int64_t op = state[2];

    auto write_lsic = [&](int64_t v) {
        while (v >= 255) { out[op++] = 255; v -= 255; }
        out[op++] = (uint8_t)v;
    };
    auto probe = [&](int64_t q, uint32_t* d_out) -> int64_t {
        int64_t pl = (q - row_gstart) >> pool_shift;
        if (q < row_gstart || pl >= plane_len) return 0;
        uint32_t d = plane[pl];
        if (!d || (int64_t)d > q) return 0;
        int64_t l = hybrid_match_len(G, q, q - (int64_t)d, n - 5 - q);
        if (l < (int64_t)MINMATCH) return 0;
        *d_out = d;
        return l;
    };

    while (p + (int64_t)MFLIMIT <= n && p < row_limit) {
        uint32_t bd;
        int64_t l = probe(p, &bd);
        if (!l) { p++; continue; }
        if (p + (int64_t)MFLIMIT + 1 <= n) {
            uint32_t bd2;
            int64_t l2 = probe(p + 1, &bd2);
            if (l2 > l) { p++; continue; }
        }
        int64_t c = p - (int64_t)bd;
        int64_t b = 0;
        while (p - b > lit_start && c - b > 0 && G[p - b - 1] == G[c - b - 1])
            b++;
        int64_t ll = (p - b) - lit_start;
        int64_t mlc = l + b - (int64_t)MINMATCH;
        if (op + 1 + ll / 255 + 1 + ll + 2 + mlc / 255 + 1 > out_cap)
            return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4
                              | (mlc < 15 ? mlc : 15));
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
        store16(out + op, (uint16_t)bd);
        op += 2;
        if (mlc >= 15) write_lsic(mlc - 15);
        p += l;
        lit_start = p;
    }
    if (final_row) {
        int64_t ll = n - lit_start;
        if (op + 1 + ll / 255 + 1 + ll > out_cap) return -1;
        out[op++] = (uint8_t)((ll < 15 ? ll : 15) << 4);
        if (ll >= 15) write_lsic(ll - 15);
        std::memcpy(out + op, G + lit_start, (size_t)ll);
        op += ll;
        lit_start = n;
        p = n;
    }
    state[0] = p;
    state[1] = lit_start;
    state[2] = op;
    return op;
}
