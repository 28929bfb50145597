// The resident decode for NVIDIA Hopper (sm_90a), C interface: a batch of
// independent LZ4 blocks, one payload row each, already on the card, decoded
// into one output row each, with each row's length and error flags.
//
// It replaces no Pallas kernel. It is the JAX package's `jnp` program
// `_decode_batch` (lz4_flex_tpu/parallel/pipeline.py, a `vmap` of
// `decode_resident_core`, lz4_flex_tpu/ops/decode.py), which the port first ran
// as ~1,600 torch ops a call (ops/decode.py:decode_resident_rows_reference:
// the speculative parse of ops/parse.py, the checks, and the expansion of
// ops/expand2.py). For every row it returns what that program returns, byte
// for byte, malformed rows included:
//
//   * the walk visits the positions the parse marks on the chain: the orbit
//     of position 0 under the per-position successor, while pos < n. Each
//     position's fields and flags are those of `_speculative_tables`, with
//     its clamped reads; the flags are OR-ed along the chain and combined as
//     `parse_rows` does (a stream that never terminates counts as truncated
//     only when no other flag explains it); `total` is the sum of the
//     sequences' literal and match lengths (int32, as the torch program);
//   * offset_oob: a sequence among the first nseq_pad with a match that
//     starts before the block (`_expand_parsed`); output_too_small:
//     total > capacity;
//   * the bytes of the expansion's source map: a literal byte is row byte
//     lit_start + k (0 past the row); a match byte at q is the output byte at
//     q - offset (offset 0 copies as 1), or 0 before the block start; the
//     table holds nseq_pad sequences, so past them the last kept match runs
//     on to `total`; positions from `total` to out_pad hold the row's own
//     byte at that position (0 past the row), which is where the expansion's
//     padding points; positions at or past out_pad are dropped.
//
// What bounds it on this card: LZ4's token walk. A block is a chain of
// sequences, each header saying where the next starts, so one block is one
// serial walk (a few thousand sequences a 64 KiB block of text), and a
// batch of at most a few hundred blocks cannot fill the card's bandwidth: a
// call moves ~10 MB, a few microseconds at 3.35 TB/s, while the walk of one
// block takes hundreds of microseconds of dependent loads.
//
// What the design does about it:
//  * One CTA a row, so every row of a call walks at once (three 64 KiB
//    windows an SM: 396 rows in one wave on 132 SMs), and two warps a row:
//    one walks the headers, the other writes the bytes, so the chain of
//    header reads and the copies run side by side. The walk hands the copies
//    batches of 32 sequences through two slots in shared memory (named
//    barriers; the walk runs up to two batches ahead).
//  * The walk is warp-uniform: every lane decodes the same header from the
//    same addresses (one broadcast load), so no shuffle sits on the chain; an
//    LSIC run is found 32 bytes a step by a ballot. Only the chain is serial:
//    the flags, the output offsets (a warp scan) and the match offsets are
//    computed for a batch at once, a lane a sequence.
//  * The copy warp writes a batch a lane a sequence: every literal, then
//    every match whose source lies before the batch's run, then the others
//    in order by the whole warp; long sequences by the whole warp.
//  * The output window lives in shared memory, so a match's source costs
//    shared-memory latency. A match byte reads the byte one period earlier
//    (q - offset + (j mod offset) for lane j of a 32-byte piece), so a whole
//    piece, self-overlapping or not, reads bytes written before it.
//  * Finished 16 KiB chunks of the window go to device memory as 16-byte
//    stores while the walk goes on. LZ4 offsets reach 65,535 bytes back, so
//    for out_pad above 64 KiB (4 MiB blocks) the window is a 128 KiB ring in
//    shared memory: one template, its ring size chosen by out_pad.
//  * Literal bytes are read from the row through the read-only cache.
// The kernel allocates nothing, makes no host read and writes every byte of
// its outputs, and reads nothing outside the rows whatever they hold.
// Parity holds where no position or length sum passes 2^31 (in the torch
// program such sums wrap): on every row under 8 MiB (a sum grows by at most
// 257 times the row's bytes), and on any row of a valid block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;  // bytes of the window stored to device memory at once
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int add32(int a, int b)  // int32 addition that wraps, as torch's
{
    return (int)((unsigned)a + (unsigned)b);
}

struct Row {
    const uint8_t* __restrict__ p;
    int width;

    // The byte at i clamped into the row (the torch program's clamped gathers).
    __device__ __forceinline__ int at(int i) const
    {
        return __ldg(p + min(max(i, 0), width - 1));
    }

    // The LSIC run starting at q (clamped into the row): the first byte at or
    // after q that is not 0xFF ends it, or the row's last byte does.
    // Warp-uniform q; every lane takes part.
    __device__ __forceinline__ void lsic(int q, int lane, int& value, int& nbytes) const
    {
        q = min(max(q, 0), width - 1);
        value = __ldg(p + q);
        nbytes = 1;
        if (value != 0xFF || q == width - 1)  // a run of one byte, the common case
            return;
        for (int base = q;; base += 32) {
            const int i = base + lane;
            const unsigned stop = __ballot_sync(kAll, i >= width - 1 || __ldg(p + i) != 0xFF);
            if (stop) {
                const int nz = base + __ffs(stop) - 1;
                value = (int)((unsigned)(nz - q) * 255u) + __ldg(p + nz);
                nbytes = nz - q + 1;
                return;
            }
        }
    }
};

template <int kRingBits>
struct Window {
    static constexpr int kMask = (1 << kRingBits) - 1;
    uint8_t* ring;       // shared memory: output position q at ring[q & kMask]
    uint8_t* dst;        // the row's output in device memory
    int flushed;         // positions below this are in dst
    int lane;

    // Store every whole chunk below `upto` (positions the walk has written).
    __device__ __forceinline__ void flush(int upto)
    {
        if (flushed + kChunk > upto)
            return;
        __syncwarp();
        do {
            for (int j = lane * 16; j < kChunk; j += 32 * 16)
                *reinterpret_cast<uint4*>(dst + flushed + j) =
                    *reinterpret_cast<const uint4*>(ring + ((flushed + j) & kMask));
            flushed += kChunk;
        } while (flushed + kChunk <= upto);
    }

    // Literal bytes for output positions [lo, hi): row byte k0 + (q - lo).
    __device__ __forceinline__ void literal(const Row& r, int lo, int hi, int k0)
    {
        for (int s = lo; s < hi; s += kChunk) {
            const int e = min(hi, s + kChunk);
            for (int q = s + lane; q < e; q += 32) {
                const int k = k0 + (q - lo);
                ring[q & kMask] = (unsigned)k < (unsigned)r.width ? __ldg(r.p + k) : 0;
            }
            __syncwarp();
            flush(e);
        }
    }

    // One sequence's bytes by the whole warp: ll literal bytes from row byte
    // ls at output position op, then ml match bytes at offset off >= 1,
    // clipped to [0, out_pad).
    __device__ __forceinline__ void sequence(const Row& r, int op, int ll, int ls, int ml, int off,
                                             int out_pad)
    {
        const int ms = add32(op, ll);
        literal(r, max(op, 0), min(ms, out_pad), ls + (max(op, 0) - op));
        match(max(ms, 0), min(add32(ms, ml), out_pad), off);
    }

    // The bytes of a batch of `cnt` sequences in order, lane k holding
    // sequence k's fields (ms = op + ll, me = ms + ml). Runs of short
    // sequences (literal and match of at most 32 bytes, inside [0, out_pad))
    // are written a lane a sequence (`run`); a long one by the whole warp
    // between the runs around it.
    __device__ __forceinline__ void batch(const Row& r, int cnt, int op, int ll, int ls, int ml,
                                          int off, int out_pad)
    {
        const int ms = add32(op, ll), me = add32(ms, ml);
        const bool is_short = (unsigned)ll <= 32 && (unsigned)ml <= 32 && op >= 0 && me >= op
                              && me <= out_pad;
        const unsigned longs = __ballot_sync(kAll, lane < cnt && !is_short);
        for (int k = 0; k < cnt;) {
            const unsigned m = longs & (kAll << k);
            const int e = m ? __ffs(m) - 1 : cnt;
            if (e > k)
                run(r, k, e, op, ll, ls, ml, off, ms, me);
            if (e == cnt)
                break;
            sequence(r, __shfl_sync(kAll, op, e), __shfl_sync(kAll, ll, e), __shfl_sync(kAll, ls, e),
                     __shfl_sync(kAll, ml, e), __shfl_sync(kAll, off, e), out_pad);
            k = e + 1;
        }
    }

    // Short sequences k..e-1, a lane each: every literal; then every match
    // that reads only bytes before the run or its own literal, as the byte
    // one period back (so a lane's loads do not wait on its stores); then
    // the other matches in order by the whole warp.
    __device__ __forceinline__ void run(const Row& r, int k, int e, int op, int ll, int ls, int ml,
                                        int off, int ms, int me)
    {
        const bool mine = lane >= k && lane < e;
        const int start = __shfl_sync(kAll, op, k);
        const int nl = mine ? ll : 0;
        const int max_l = __reduce_max_sync(kAll, nl);
        for (int j = 0; j < max_l; j += 4) {
            uint8_t v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int x = ls + j + u;
                v[u] = j + u < nl && (unsigned)x < (unsigned)r.width ? __ldg(r.p + x) : 0;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (j + u < nl)
                    ring[(op + j + u) & kMask] = v[u];
        }
        __syncwarp();
        const bool own = mine && ml > 0 && (ms - off + min(ml, off) <= start || off <= ll);
        const int nm = own ? ml : 0;
        const int max_m = __reduce_max_sync(kAll, nm);
        for (int j = 0, ph = 0; j < max_m; j += 4) {  // ph = j mod off
            uint8_t v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int pu = ph + u;
                pu -= pu >= off ? off : 0;
                pu -= pu >= off ? off : 0;
                pu -= pu >= off ? off : 0;
                const int src = ms - off + pu;
                v[u] = j + u < nm && src >= 0 ? ring[src & kMask] : 0;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (j + u < nm)
                    ring[(ms + j + u) & kMask] = v[u];
            for (ph += 4; ph >= off;)
                ph -= off;
        }
        __syncwarp();
        for (unsigned rest = __ballot_sync(kAll, mine && ml > 0 && !own); rest; rest &= rest - 1) {
            const int d = __ffs(rest) - 1;
            const int d_ms = __shfl_sync(kAll, ms, d);
            match(d_ms, __shfl_sync(kAll, me, d), __shfl_sync(kAll, off, d));
        }
        flush(__shfl_sync(kAll, me, e - 1));
    }

    // Match bytes for output positions [lo, hi) at offset `off` >= 1, lo at
    // or after the match start: the byte one period back, piece by piece.
    __device__ __forceinline__ void match(int lo, int hi, int off)
    {
        const int jm = lane < off ? lane : lane % off;  // lane's phase within a period
        // Pieces of 32 lanes x `u` bytes read only positions below the piece.
        const int u = off >= 128 ? 4 : off >= 64 ? 2 : 1;
        for (int s = lo; s < hi; s += kChunk) {
            const int e = min(hi, s + kChunk);
            for (int w = s; w < e; w += 32 * u) {
                uint8_t v[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int src = w - off + jm + 32 * k;
                    v[k] = (k < u && w + lane + 32 * k < e && src >= 0) ? ring[src & kMask] : 0;
                }
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (k < u && w + lane + 32 * k < e)
                        ring[(w + lane + 32 * k) & kMask] = v[k];
                __syncwarp();
            }
            flush(e);
        }
    }
};

// The walk's batches: up to 32 sequences each, handed from the walk warp to
// the copy warp through two slots in shared memory.
constexpr int kBatch = 32;
struct Batch {
    int op[kBatch], ll[kBatch], ls[kBatch], ml[kBatch], pos[kBatch];  // pos: the offset's bytes
    int cnt;   // sequences in the batch
    int last;  // the walk ended with this batch
};
// What the walk hands over at its end.
struct Tail {
    int total, cut;  // cut: where the table of nseq_pad sequences ends, or -1
    unsigned flags;  // kLitOob, kTrunc, kOffZero (sequences past the table), kTerm
};
constexpr unsigned kLitOob = 1, kTrunc = 2, kOffZero = 4, kTerm = 8;
// Named barriers (0 is __syncthreads): slot s is full (FULL + s) or free (FREE + s).
constexpr int kFull = 1, kFree = 3, kPair = 64;

__device__ __forceinline__ void bar_sync(int id)
{
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kPair) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id)
{
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kPair) : "memory");
}

// The walk warp: the chain of sequence headers, in batches of 32. The
// serial loop follows only the chain (lane k keeps the k-th header's
// fields); the flags, the output offsets (a warp scan) and the table's cut
// are then computed for the whole batch at once. The copy warp reads the
// offsets, which lie off the chain.
__device__ __forceinline__ void walk(const uint8_t* __restrict__ row, int width, int n, int nseq_pad,
                                     int lane, Batch* slots, Tail* tail)
{
    const Row r{row, width};
    const int lim = min(n, width);  // chain positions lie below both
    unsigned fl = 0;
    int p = 0, op = 0, i = 0, cut = -1;
    // A successor past 2^31 ends the chain, as the torch program's clamp does.
    bool more = p < lim;
    int slot = 0;
    do {
        int cnt = 0, k_ll = 0, k_ls = 0, k_ml = 0, k_pos = 0, k_nxt = 0;
        bool k_lt = false;
        while (more && cnt < kBatch) {
            const int t = __ldg(row + p);
            int ll = t >> 4, lit_start = p + 1, value, nb;
            bool lsic_trunc = false;
            if (ll == 15) {
                r.lsic(p + 1, lane, value, nb);
                ll = 15 + value;
                lit_start = p + 1 + nb;
                lsic_trunc = lit_start > n;
            }
            const int off_pos = add32(lit_start, ll);
            const bool fin = off_pos >= n;
            int ml = 4 + (t & 15), nxt = add32(off_pos, 2);
            if ((t & 15) == 15 && !fin) {
                r.lsic(off_pos + 2, lane, value, nb);
                ml = 19 + value;
                nxt = add32(off_pos, 2 + nb);
            }
            nxt = fin ? n : nxt;
            if (lane == cnt) {
                k_ll = ll;
                k_ls = lit_start;
                k_ml = fin ? 0 : ml;
                k_pos = off_pos;
                k_nxt = nxt;
                k_lt = lsic_trunc;
            }
            ++cnt;
            p = nxt;
            more = p >= 0 && p < lim;
        }
        // The batch's flags, output offsets and cut, a lane a sequence.
        const bool on = lane < cnt;
        const bool fin = on && k_pos >= n;
        fl |= (__any_sync(kAll, fin && k_pos > n && !k_lt) ? kLitOob : 0u)
            | (__any_sync(kAll, on && (k_lt || (!fin && (add32(k_pos, 2) > n || k_nxt > n)))) ? kTrunc
                                                                                              : 0u)
            | (__any_sync(kAll, fin && k_pos == n && !k_lt) ? kTerm : 0u);
        int end = on ? add32(k_ll, k_ml) : 0;  // inclusive scan of the output lengths
        for (int d = 1; d < 32; d *= 2) {
            const int v = __shfl_up_sync(kAll, end, d);
            end = lane >= d ? add32(end, v) : end;
        }
        const int k_op = add32(op, add32(end, -(on ? add32(k_ll, k_ml) : 0)));
        op = add32(op, __shfl_sync(kAll, end, 31));
        // the table holds the first nseq_pad sequences; past it only the
        // offset-zero flag is read here (the copy warp sees nothing)
        const int kept = min(cnt, max(nseq_pad - i, 0));
        if (kept < cnt) {
            const bool past = on && lane >= kept && !fin;
            if (__any_sync(kAll, past && (r.at(k_pos) | r.at(k_pos + 1)) == 0))
                fl |= kOffZero;
            if (nseq_pad >= i && nseq_pad < i + cnt)
                cut = __shfl_sync(kAll, k_op, nseq_pad - i);
        }
        i += cnt;
        bar_sync(kFree + slot);
        Batch& b = slots[slot];
        if (lane < kept) {
            b.op[lane] = k_op;
            b.ll[lane] = k_ll;
            b.ls[lane] = k_ls;
            b.ml[lane] = k_ml;
            b.pos[lane] = k_pos;
        }
        if (lane == 0) {
            b.cnt = kept;
            b.last = !more;
            if (!more)
                *tail = Tail{op, cut, fl};
        }
        bar_arrive(kFull + slot);
        slot ^= 1;
    } while (more);
    // Wait for the copy warp to release both slots.
    bar_sync(kFree + slot);
    bar_sync(kFree + (slot ^ 1));
}

// One CTA of two warps a row: warp 0 walks the tokens, warp 1 writes the
// bytes of the sequences the walk hands it, in order, then the rest of the
// row's outputs. Dynamic shared memory: the window (`window` bytes: at least
// min(2^kRingBits, out_pad rounded up to a power of two)), then two batch
// slots and the tail.
template <int kRingBits>
__global__ void __launch_bounds__(2 * 32) resident_decode_kernel(
    const uint8_t* __restrict__ rows, long long row_stride, int width, const int* __restrict__ clen,
    int out_pad, int nseq_pad, int capacity, int window, uint8_t* __restrict__ out,
    int* __restrict__ total_out, uint8_t* __restrict__ flags)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x;
    const Row r{rows + b * row_stride, width};
    Batch* slots = reinterpret_cast<Batch*>(smem + window);
    Tail* tail = reinterpret_cast<Tail*>(slots + 2);
    if (threadIdx.x < 32) {
        walk(r.p, width, clen[b], nseq_pad, lane, slots, tail);
        return;
    }
    Window<kRingBits> win{smem, out + (long long)b * out_pad, 0, lane};
    bar_arrive(kFree);  // both slots start free
    bar_arrive(kFree + 1);
    bool off_zero = false, off_oob = false;
    int last_ms = 0, last_off = 1;  // the last sequence of the table's match
    for (int slot = 0;; slot ^= 1) {
        bar_sync(kFull + slot);
        const Batch& bt = slots[slot];
        const int cnt = bt.cnt, last = bt.last;
        int k_op = 0, k_ll = 0, k_ls = 0, k_ml = 0, k_pos = 0;
        if (lane < cnt) {
            k_op = bt.op[lane];
            k_ll = bt.ll[lane];
            k_ls = bt.ls[lane];
            k_ml = bt.ml[lane];
            k_pos = bt.pos[lane];
        }
        bar_arrive(kFree + slot);
        // Each lane reads its sequence's offset (0 for the last sequence,
        // which has no match); the batch's offset flags in one vote.
        const int offset = lane < cnt && k_ml > 0 ? r.at(k_pos) | (r.at(k_pos + 1) << 8) : 0;
        off_zero |= __any_sync(kAll, lane < cnt && k_ml > 0 && offset == 0);
        off_oob |= __any_sync(kAll, lane < cnt && k_ml > 0 && add32(add32(k_op, k_ll), -offset) < 0);
        const int k_off = max(offset, 1);
        if (cnt) {
            last_ms = __shfl_sync(kAll, add32(k_op, k_ll), cnt - 1);
            last_off = __shfl_sync(kAll, k_off, cnt - 1);
        }
        win.batch(r, cnt, k_op, k_ll, k_ls, k_ml, k_off, out_pad);
        if (last)
            break;
    }
    const Tail tl = *tail;
    const int total = tl.total;
    const int done = min(max(total, 0), out_pad);  // [0, done) is decoded output
    if (tl.cut >= 0)
        win.match(max(tl.cut, last_ms), done, last_off);
    __syncwarp();
    win.flush(done);
    // The window's last partial chunk, then the padding: the row's own byte
    // at each position (0 past the row).
    uint8_t* dst = win.dst;
    const int vec_end = done & ~15;
    for (int q = win.flushed + lane * 16; q < vec_end; q += 32 * 16)
        *reinterpret_cast<uint4*>(dst + q) =
            *reinterpret_cast<const uint4*>(smem + (q & Window<kRingBits>::kMask));
    const int head_end = min((done + 15) & ~15, out_pad);
    for (int q = vec_end + lane; q < head_end; q += 32)
        dst[q] = q < done ? smem[q & Window<kRingBits>::kMask] : (q < width ? __ldg(r.p + q) : 0);
    const bool row_aligned = (reinterpret_cast<uintptr_t>(r.p) & 15) == 0;
    for (int q = head_end + lane * 16; q < out_pad; q += 32 * 16) {
        uint4 v;
        if (row_aligned && q + 16 <= width) {
            v = __ldg(reinterpret_cast<const uint4*>(r.p + q));
        } else {
            uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
            for (int k = 0; k < 16; ++k)
                vb[k] = q + k < width ? __ldg(r.p + q + k) : 0;
        }
        *reinterpret_cast<uint4*>(dst + q) = v;
    }
    if (lane == 0) {
        const bool lit_oob = tl.flags & kLitOob;
        off_zero |= (tl.flags & kOffZero) != 0;
        // a stream that never terminates counts as truncated only when no
        // other flag explains it
        const bool trunc = (tl.flags & kTrunc) || (!(tl.flags & kTerm) && !lit_oob && !off_zero);
        total_out[b] = total;
        uint8_t* f = flags + 5 * (long long)b;
        f[0] = lit_oob;
        f[1] = trunc;
        f[2] = off_zero;
        f[3] = off_oob;
        f[4] = total > capacity;
    }
}

template <int kRingBits>
cudaError_t launch(const void* rows, long long row_stride, int width, const void* clen, int nrows,
                   int out_pad, int nseq_pad, int capacity, void* out, void* total, void* flags,
                   cudaStream_t stream)
{
    int window = 1024;
    while (window < out_pad && window < (1 << kRingBits))
        window *= 2;
    const int smem = window + 2 * (int)sizeof(Batch) + (int)sizeof(Tail);
    auto kernel = resident_decode_kernel<kRingBits>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess)
        return err;
    kernel<<<nrows, 2 * 32, smem, stream>>>(
        static_cast<const uint8_t*>(rows), row_stride, width, static_cast<const int*>(clen), out_pad,
        nseq_pad, capacity, window, static_cast<uint8_t*>(out), static_cast<int*>(total),
        static_cast<uint8_t*>(flags));
    return cudaGetLastError();
}

}  // namespace

extern "C" int tlz4_resident_decode(const void* rows, long long row_stride, int width,
                                    const void* clen, int nrows, int out_pad, int nseq_pad,
                                    int capacity, void* out, void* total, void* flags, void* stream)
{
    if (nrows == 0)
        return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return (int)(out_pad <= 65536
                     ? launch<16>(rows, row_stride, width, clen, nrows, out_pad, nseq_pad, capacity,
                                  out, total, flags, s)
                     : launch<17>(rows, row_stride, width, clen, nrows, out_pad, nseq_pad, capacity,
                                  out, total, flags, s));
}

extern "C" const char* tlz4_resident_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
