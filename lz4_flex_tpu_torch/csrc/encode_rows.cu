// The all-device encode for NVIDIA Hopper (sm_90a), C interface: a batch of
// independent rows, each a dictionary followed by a block and zero padding,
// each encoded into one raw LZ4 block, with each block's length.
//
// It replaces no Pallas kernel. It is the JAX package's `jnp` program
// `encode_chunk_core` (lz4_flex_tpu/ops/encode.py:427, under `vmap` in
// `_encode_batch`), which the port first ran as ~1,700 torch ops a group of
// rows (ops/encode.py:encode_chunk_core_reference: `match_core`, then
// `emit_core`). For every row it returns what those ops return, byte for
// byte, fingerprint collisions included, in this order:
//
//   1. the candidates: the 4 closest previous positions whose 4-byte word is
//      the same, over the whole row, dictionary included; the j-th closest in
//      the torch ops' stable sort is the j-th previous occurrence, so the
//      nearest previous occurrence followed j times is the same set;
//   2. the fingerprints H[k] of the 2^k bytes at each position: exact for
//      k <= 2 (byte, u16, u32), above that `_mix` of two halves in uint32;
//   3. each candidate's match length by binary lifting over H, levels from
//      `levels` down to 0, capped at lim = n - 5 - pos; the longest wins and
//      ties keep the closer candidate;
//   4. eligibility: d <= pos <= n - 13, lim >= 4, pos - cand <= 65535;
//   5. the lazy step: a match is dropped when the next position holds a
//      strictly longer one;
//   6. the greedy chain from d (a match jumps its length, a literal one
//      byte), by pointer doubling, as the torch ops mark it;
//   7. each match's literal run starts at max(d, the previous match's end);
//   8. the backward extension of at most 16 bytes, capped at
//      min(pos - literal start, cand);
//   9. a trailing literal-only sequence from the last match's end to n;
//  10. the emission: token, literal-length LSIC, literals, little-endian
//      offset, match-length LSIC. Bytes from the total to comp_pad are 0.
//
// What bounds it. The work's bytes are small (a 64 KiB block read once, its
// payload written once: under 3 us for 32 rows at 3.35 TB/s); what takes the
// time is the algorithm's serial structure and its gathers, which the
// design works around:
//  * A cluster of up to 4 CTAs of 1,024 threads a row (the most at which
//    every row of the launch is resident at once: 3 for 32 rows on 132 SMs),
//    every phase parallel over the row's positions and spread over the
//    cluster, with a cluster barrier between phases: no grid-wide barrier,
//    so one launch a group. The lifting's gathers are bound by each SM's
//    bandwidth to L2, so more SMs a row is what shortens them.
//  * The candidates need each position's nearest previous equal word. Each
//    CTA sweeps its segment of the row in tiles of 1,024 positions: a tile
//    is sorted by (word, position) in registers and shared memory (a bitonic
//    sort, shuffles for strides under 32), so a position's previous
//    occurrence inside the tile is its left neighbour; the CTA's
//    open-addressing hash table, keyed by the exact word, carries each
//    word's last position from tile to tile (read by a word's first element
//    and written by its last). A position whose word is new to its segment
//    then looks it up in the tables of the segments before it.
//  * The fingerprint planes are built one level a pass, each level from the
//    one below, only where a lifting step can read them (spans that end by
//    n - 5). The lifting interleaves the four candidates of a position so
//    their gathers overlap; a candidate that cannot be valid costs nothing.
//  * The greedy chain is pointer doubling over the row's jump table, as the
//    torch ops do it, in bit_length(n - d + 1) passes instead of a walk of
//    thousands of dependent loads.
//  * The first CTA compacts the match table by a block scan over contiguous
//    ranges of positions (count and running end) and finds the payload
//    offsets by another over the sequences; then every warp of the cluster
//    writes sequences' bytes, a lane a byte.
// The kernel allocates nothing and makes no host read. Its scratch comes
// from the caller; it writes every byte of its outputs. A row's d and n are
// clamped to 0 <= d <= n <= width (the torch ops take no such rows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRanks = 4;    // CTAs a row at most: one cluster
constexpr int kThreads = 1024;  // threads a CTA, and the positions of a tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kC1 = 0x85EBCA6Bu, kC2 = 0xC2B2AE35u, kC3 = 0x9E3779B1u;
constexpr unsigned long long kNoKey = ~0ull;  // sorts after every (word, position) key

// `_mix` of ops/encode.py in native uint32.
__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b)
{
    a *= kC1;
    a ^= a >> 16;
    b *= kC2;
    b ^= b >> 16;
    const uint32_t h = (a + b) * kC3;
    return h ^ (h >> 15);
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* __restrict__ p, int a)
{
    return (uint32_t)__ldg(p + a) | ((uint32_t)__ldg(p + a + 1) << 8) |
           ((uint32_t)__ldg(p + a + 2) << 16) | ((uint32_t)__ldg(p + a + 3) << 24);
}

// The exact equality of the 2^k bytes at a and b, by fingerprint: bytes for
// k <= 2, the plane of level k above.
__device__ __forceinline__ bool same_span(const uint8_t* __restrict__ src,
                                          const uint32_t* __restrict__ planes, long long stride,
                                          int k, int a, int b)
{
    if (k == 0)
        return __ldg(src + a) == __ldg(src + b);
    if (k == 1)
        return __ldg(src + a) == __ldg(src + b) && __ldg(src + a + 1) == __ldg(src + b + 1);
    if (k == 2)
        return word_at(src, a) == word_at(src, b);
    const uint32_t* h = planes + (k - 3) * stride;
    return h[a] == h[b];
}

// The per-row hash table: slot = word << 32 | (last position + 1); 0 is an
// empty slot. Within a tile one thread reads and one writes each word.
__device__ __forceinline__ unsigned home_slot(uint32_t w, int bits)
{
    return (w * 2654435761u) >> (32 - bits);
}

// The last position of ``w`` before this tile (-1 if none), inserting the
// word when it is new.
__device__ int table_last(unsigned long long* table, int bits, uint32_t w)
{
    const unsigned mask = (1u << bits) - 1;
    const unsigned long long mine = ((unsigned long long)w << 32) | 0xffffffffull;
    for (unsigned s = home_slot(w, bits);; s = (s + 1) & mask) {
        unsigned long long cur = table[s];
        if (cur == 0) {
            cur = atomicCAS(table + s, 0ull, mine);
            if (cur == 0)
                return -1;
        }
        if ((uint32_t)(cur >> 32) == w)
            return (int)(uint32_t)cur - 1;
    }
}

// The last position of ``w`` in a finished table, -1 if it holds none.
__device__ int table_find(const unsigned long long* table, int bits, uint32_t w)
{
    const unsigned mask = (1u << bits) - 1;
    for (unsigned s = home_slot(w, bits);; s = (s + 1) & mask) {
        const unsigned long long cur = table[s];
        if (cur == 0)
            return -1;
        if ((uint32_t)(cur >> 32) == w)
            return (int)(uint32_t)cur - 1;
    }
}

__device__ void table_set(unsigned long long* table, int bits, uint32_t w, int pos)
{
    const unsigned mask = (1u << bits) - 1;
    for (unsigned s = home_slot(w, bits);; s = (s + 1) & mask) {
        if ((uint32_t)(table[s] >> 32) == w) {
            table[s] = ((unsigned long long)w << 32) | (unsigned)(pos + 1);
            return;
        }
    }
}

struct Pair {
    int sum;
    int max;
};

// Exclusive scan over the CTA's threads in thread order: the sum of the
// threads' ``s`` before this one and the max of their ``m`` (0 if none).
// ``total`` gets the whole CTA's sum and max. Every thread must call it.
__device__ Pair block_scan(int s, int m, Pair* total, int* sh)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int is = s, im = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int ts = __shfl_up_sync(kAll, is, o), tm = __shfl_up_sync(kAll, im, o);
        if (lane >= o) {
            is += ts;
            im = max(im, tm);
        }
    }
    int pm = __shfl_up_sync(kAll, im, 1);
    if (lane == 0)
        pm = 0;
    if (lane == 31) {
        sh[warp] = is;
        sh[kWarps + warp] = im;
    }
    __syncthreads();
    if (warp == 0) {
        int ws = sh[lane], wm = sh[kWarps + lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int ts = __shfl_up_sync(kAll, ws, o), tm = __shfl_up_sync(kAll, wm, o);
            if (lane >= o) {
                ws += ts;
                wm = max(wm, tm);
            }
        }
        sh[lane] = ws;
        sh[kWarps + lane] = wm;
    }
    __syncthreads();
    const Pair out{(warp ? sh[warp - 1] : 0) + is - s, max(warp ? sh[kWarps + warp - 1] : 0, pm)};
    *total = Pair{sh[kWarps - 1], sh[2 * kWarps - 1]};
    __syncthreads();
    return out;
}

__device__ __forceinline__ int lsic_bytes(int v)
{
    return v >= 15 ? (v - 15) / 255 + 1 : 0;
}

__device__ __forceinline__ int seq_bytes(int ll, int mlc, bool has_match)
{
    return 1 + lsic_bytes(ll) + ll + (has_match ? 2 + lsic_bytes(mlc) : 0);
}

// Byte ``delta`` of a sequence, as `emit_core` computes it.
__device__ __forceinline__ uint8_t seq_byte(int delta, int ll, int ls, int off, int mlc,
                                            bool has_match, const uint8_t* __restrict__ lit)
{
    const int t1 = 1 + lsic_bytes(ll);
    const int t2 = t1 + ll;
    if (delta == 0)
        return (uint8_t)((min(ll, 15) << 4) | (has_match ? min(mlc, 15) : 0));
    if (delta < t1)
        return (uint8_t)min(ll - 15 - 255 * (delta - 1), 255);
    if (delta < t2)
        return __ldg(lit + ls + delta - t1);
    if (delta == t2)
        return (uint8_t)(off & 0xFF);
    if (delta == t2 + 1)
        return (uint8_t)((off >> 8) & 0xFF);
    return (uint8_t)min(mlc - 15 - 255 * (delta - t2 - 2), 255);
}

struct Args {
    const uint8_t* rows;  // (B, width): dictionary ++ data, the match source
    const uint8_t* lits;  // (B, width): the words' bytes, the literal source
    const int* dlen;
    const int* tlen;
    int width, levels, comp_pad, nseq_pad;
    int* scratch;  // (B, row_ints)
    long long row_ints;
    unsigned long long* tables;  // (B, ranks, 2^table_bits)
    int table_bits;
    uint8_t* out;  // (B, comp_pad)
    int* total;    // (B,)
};

__global__ void __launch_bounds__(kThreads, 1) encode_rows_kernel(const Args a)
{
    __shared__ unsigned long long sk[2][kThreads];
    __shared__ int sh[2 * kWarps];
    cg::cluster_group cluster = cg::this_cluster();
    // Each phase's positions spread over the cluster's CTAs: ``gt`` is a
    // thread's index in the cluster, ``span`` the cluster's threads.
    const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int b = blockIdx.x / ranks, tid = threadIdx.x;
    const int gt = rank * kThreads + tid, span = ranks * kThreads;
    const int lane = tid & 31, warp = tid >> 5;
    const int width = a.width;
    const uint8_t* __restrict__ src = a.rows + (long long)b * width;
    const uint8_t* __restrict__ lit = a.lits + (long long)b * width;
    const int n = min(max(a.tlen[b], 0), width);
    const int d = min(max(a.dlen[b], 0), n);
    const long long S = width + 4;  // one int plane of the row, the sentinel slot included
    int* prev1 = a.scratch + (long long)b * a.row_ints;
    int* cand = prev1 + S;
    int* mlen = cand + S;
    int* big = mlen + S;  // the fingerprint planes, then the chain's planes
    int* tab = big + (long long)max(a.levels - 2, 4) * S;
    int* t_ll = tab;
    int* t_ls = tab + a.nseq_pad;
    int* t_off = tab + 2LL * a.nseq_pad;
    int* t_ml = tab + 3LL * a.nseq_pad;
    int* t_coff = tab + 4LL * a.nseq_pad;
    // one hash table a CTA: the last position of each word in its segment
    unsigned long long* tables = a.tables + ((long long)b * ranks << a.table_bits);
    unsigned long long* table = tables + ((long long)rank << a.table_bits);
    uint8_t* dst = a.out + (long long)b * a.comp_pad;

    // --- 0. empty hash tables ------------------------------------------------------
    for (long long i = tid; i < (1LL << a.table_bits); i += kThreads)
        table[i] = 0;
    __syncthreads();

    // --- 1. each position's nearest previous equal word -----------------------------
    // Positions 0..n-13 hold every eligible position and every candidate. Each
    // CTA sweeps its segment of them tile by tile, then a position whose word
    // is new to its segment looks it up in the segments before.
    const int L = max(n - 12, 0), ntiles = (L + kThreads - 1) / kThreads;
    const int seg_lo = min(L, rank * ntiles / ranks * kThreads);
    const int seg_hi = min(L, (rank + 1) * ntiles / ranks * kThreads);
    for (int t0 = seg_lo; t0 < seg_hi; t0 += kThreads) {
        const int p = t0 + tid;
        unsigned long long v =
            p < seg_hi ? ((unsigned long long)word_at(src, p) << 32) | (unsigned)p : kNoKey;
        int buf = 0;
        for (int k = 2; k <= kThreads; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                unsigned long long o;
                if (j >= 32) {
                    sk[buf][tid] = v;
                    __syncthreads();
                    o = sk[buf][tid ^ j];
                    buf ^= 1;
                } else {
                    o = __shfl_xor_sync(kAll, v, j);
                }
                const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
                v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
            }
        }
        sk[buf][tid] = v;
        __syncthreads();
        const int cnt = min(kThreads, seg_hi - t0);
        const uint32_t w = (uint32_t)(v >> 32);
        const int pos = (int)(uint32_t)v;
        bool last = false;
        if (tid < cnt) {
            const bool first = tid == 0 || (uint32_t)(sk[buf][tid - 1] >> 32) != w;
            last = tid == cnt - 1 || (uint32_t)(sk[buf][tid + 1] >> 32) != w;
            prev1[pos] =
                first ? table_last(table, a.table_bits, w) : (int)(uint32_t)sk[buf][tid - 1];
        }
        __syncthreads();
        if (last)
            table_set(table, a.table_bits, w, pos);
    }
    cluster.sync();
    for (int p = seg_lo + tid; p < seg_hi && rank > 0; p += kThreads) {
        if (prev1[p] >= 0)
            continue;
        const uint32_t w = word_at(src, p);
        int prev = -1;
        for (int r = rank - 1; r >= 0 && prev < 0; --r)
            prev = table_find(tables + ((long long)r << a.table_bits), a.table_bits, w);
        prev1[p] = prev;
    }

    // --- 2. the fingerprint planes, levels 3..levels ---------------------------------
    // Level k is read only where a lifting step fits, a + 2^k <= n - 5.
    for (int k = 3; k <= a.levels; ++k) {
        uint32_t* hk = reinterpret_cast<uint32_t*>(big + (k - 3) * S);
        const uint32_t* hp = reinterpret_cast<const uint32_t*>(big + (k - 4) * S);
        const int rk = n - 4 - (1 << k), half = 1 << (k - 1);
        for (int x = gt; x < rk; x += span)
            hk[x] = k == 3 ? mix(word_at(src, x), word_at(src, x + 4)) : mix(hp[x], hp[x + half]);
        cluster.sync();
    }
    if (a.levels < 3)
        cluster.sync();

    // --- 3. the best of the 4 candidates by binary lifting --------------------------
    const uint32_t* planes = reinterpret_cast<const uint32_t*>(big);
    for (int p = d + gt; p < n; p += span) {
        int best = -1, best_len = 0;
        if (p <= n - 13) {
            const int lim = n - 5 - p;
            int c[4], ml[4];
            int x = p;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                x = x >= 0 ? prev1[x] : -1;
                if (x >= 0 && p - x > 65535)
                    x = -1;  // and so are the farther ones
                c[j] = x;
                ml[j] = 4;
            }
            for (int k = a.levels; k >= 0; --k) {
                const int step = 1 << k;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c[j] >= 0 && ml[j] + step <= lim &&
                        same_span(src, planes, S, k, p + ml[j], c[j] + ml[j]))
                        ml[j] += step;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (c[j] >= 0 && ml[j] > best_len) {
                    best = c[j];
                    best_len = ml[j];
                }
        }
        cand[p] = best;
        mlen[p] = best_len;
    }
    cluster.sync();

    // --- 4. the lazy step and the jump table ------------------------------------------
    int* jc = big;
    int* jn = big + S;
    uint8_t* on = reinterpret_cast<uint8_t*>(big + 2 * S);
    int* mf = big + 3 * S;  // match length after the lazy step, 0 for none
    for (int p = d + gt; p <= n; p += span) {
        int jump = width, m = 0;
        if (p < n) {
            const bool defer = p + 1 < n && cand[p + 1] >= 0 && mlen[p + 1] > mlen[p];
            m = cand[p] >= 0 && !defer ? mlen[p] : 0;
            jump = min(m ? p + m : p + 1, width);
        }
        jc[p] = jn[p] = jump;
        on[p] = p == d;
        mf[p] = m;
    }
    if (gt == 0 && n < width) {  // the sentinel slot, where every walk ends
        jc[width] = jn[width] = width;
        on[width] = 0;
    }
    cluster.sync();

    // --- 5. the greedy chain by pointer doubling --------------------------------------
    const int rounds = 32 - __clz(n - d + 1);
    for (int r = 0; r < rounds; ++r) {
        for (int p = d + gt; p <= n; p += span) {
            const int j = jc[p];
            if (on[p])
                on[j] = 1;
            if (r + 1 < rounds)
                jn[p] = jc[j];
        }
        cluster.sync();
        int* t = jc;
        jc = jn;
        jn = t;
    }

    // --- 6. the match table: literal starts, backward extension, compaction -----------
    Pair tot;
    int nm = 0, total = 0;
    if (rank == 0) {
        const int per = (n - d + kThreads - 1) / kThreads;
        const int lo = d + tid * per, hi = min(n, lo + per);
        int cnt = 0, end_max = 0;
        for (int p = lo; p < hi; ++p)
            if (on[p] && mf[p]) {
                ++cnt;
                end_max = max(end_max, p + mf[p]);
            }
        const Pair before = block_scan(cnt, end_max, &tot, sh);
        int rank_m = before.sum, run_end = before.max;
        for (int p = lo; p < hi; ++p) {
            const int m = mf[p];
            if (!(on[p] && m))
                continue;
            const int start = max(d, run_end);
            const int c = cand[p];
            const int cap = min(p - start, c);
            int back = 0;
            while (back < 16 && back < cap && __ldg(src + p - back - 1) == __ldg(src + c - back - 1))
                ++back;
            if (rank_m < a.nseq_pad) {
                t_ll[rank_m] = p - back - start;
                t_ls[rank_m] = start;
                t_off[rank_m] = p - c;
                t_ml[rank_m] = m + back;
            }
            ++rank_m;
            run_end = max(run_end, p + m);
        }
        nm = tot.sum;
        const int last_end = max(d, tot.max);
        if (tid == 0 && nm < a.nseq_pad) {  // the trailing literal-only sequence
            t_ll[nm] = n - last_end;
            t_ls[nm] = last_end;
            t_off[nm] = 1;
            t_ml[nm] = 0;
        }
        __syncthreads();

        // --- 7. the payload offsets, then (on every CTA) the bytes ------------------
        const int ns = min(nm + 1, a.nseq_pad);
        const int sper = (ns + kThreads - 1) / kThreads;
        const int slo = tid * sper, shi = min(ns, slo + sper);
        int bytes = 0;
        for (int i = slo; i < shi; ++i)
            bytes += seq_bytes(t_ll[i], max(t_ml[i] - 4, 0), i < nm);
        const Pair at = block_scan(bytes, 0, &tot, sh);
        for (int i = slo, q = at.sum; i < shi; ++i) {
            t_coff[i] = q;
            q += seq_bytes(t_ll[i], max(t_ml[i] - 4, 0), i < nm);
        }
        total = tot.sum;
        if (tid == 0) {
            a.total[b] = total;
            t_coff[a.nseq_pad] = nm;  // for the other CTAs
            t_coff[a.nseq_pad + 1] = total;
        }
    }
    cluster.sync();
    if (rank != 0) {
        nm = t_coff[a.nseq_pad];
        total = t_coff[a.nseq_pad + 1];
    }
    const int ns = min(nm + 1, a.nseq_pad);
    for (int i = rank * kWarps + warp; i < ns; i += ranks * kWarps) {
        const int ll = t_ll[i], ls = t_ls[i], off = t_off[i], mlc = max(t_ml[i] - 4, 0);
        const bool has_match = i < nm;
        const int q0 = t_coff[i];
        const int len = min(seq_bytes(ll, mlc, has_match), a.comp_pad - q0);
        for (int delta = lane; delta < len; delta += 32)
            dst[q0 + delta] = seq_byte(delta, ll, ls, off, mlc, has_match, lit);
    }
    for (int q = max(total, 0) + gt; q < a.comp_pad; q += span)
        dst[q] = 0;
}

}  // namespace

// CTAs a row for a batch of ``nrows`` rows: the most, up to kMaxRanks, at
// which every row's cluster is resident at once (one wave), else 1. The
// counts are read from the current device once a process.
extern "C" int tlz4_encode_rows_ranks(int nrows)
{
    static int fits[kMaxRanks + 1] = {0};  // clusters resident at once, by cluster size
    for (int r = kMaxRanks; r > 1; --r) {
        if (fits[r] == 0) {
            int dev = 0, sms = 1;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(r * sms);
            cfg.blockDim = dim3(kThreads);
            cudaLaunchAttribute attr;
            attr.id = cudaLaunchAttributeClusterDimension;
            attr.val.clusterDim.x = r;
            attr.val.clusterDim.y = 1;
            attr.val.clusterDim.z = 1;
            cfg.attrs = &attr;
            cfg.numAttrs = 1;
            int count = 0;
            if (cudaOccupancyMaxActiveClusters(&count, encode_rows_kernel, &cfg) != cudaSuccess)
                count = 0;
            cudaGetLastError();
            fits[r] = count > 0 ? count : -1;
        }
        if (nrows <= fits[r])
            return r;
    }
    return 1;
}

extern "C" int tlz4_encode_rows(const void* rows, const void* lits, const void* dlen,
                                const void* tlen, int nrows, int ranks, int width, int levels,
                                int comp_pad, int nseq_pad, void* scratch, long long row_ints,
                                void* tables, int table_bits, void* out, void* total, void* stream)
{
    if (nrows == 0)
        return 0;
    const Args a{static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(lits),
                 static_cast<const int*>(dlen), static_cast<const int*>(tlen), width, levels,
                 comp_pad, nseq_pad, static_cast<int*>(scratch), row_ints,
                 static_cast<unsigned long long*>(tables), table_bits, static_cast<uint8_t*>(out),
                 static_cast<int*>(total)};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nrows * ranks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ranks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, encode_rows_kernel, a);
}

extern "C" const char* tlz4_encode_rows_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
