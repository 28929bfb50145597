// K1: the LZ4 ring decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ring_kernel` (lz4_flex_tpu/ops/ringdecode.py,
// built by `_kernel_call`). It computes what the plan's executable spec
// computes (`ring_decode_reference` in lz4_flex_tpu_torch/ops/ringdecode.py):
// for every output tile t, in order,
//
//   table = [ring: the previous WR output rows (zeros before the stream) |
//            tile: TR rows seeded from the plan's literal image]
//   for each fire j < nf_tot[t], for each of its RB records:
//     lanes lo <= l < lo+len of tile row `row` = table[S + (l+ph) mod P]
//   emit the tile
//
// with S = f0, ph = f1 & 127, P = ((f1>>7)&127)+1, lo = (f1>>14)&127,
// len = (f2&127)+1, row = (f2>>7) & (2*TR-1); a record with row >= TR is
// padding. All reads of a fire see the table as it was before that fire's
// writes, and the writes within one fire are disjoint.
//
// What bounds it: the ring makes one plan's tiles a serial chain, so one CTA
// on one SM walks them all, and each fire is a dependent step of two
// barriers over a shared-memory gather and scatter. The time is the chain of
// fires and tiles times their per-step cost on one SM (instruction
// throughput and shared-memory latency), far above the device-memory bound of the bytes
// moved (PERF.md has the measured split).
//
// What the design does about it: the whole (WR+TR) x 128 B table stays in
// dynamic shared memory (96 KiB at TR=256, 128 KiB at TR=512) for the whole
// run; a fire's 3 KiB of record fields arrive in shared memory by an
// asynchronous copy started one fire ahead, so no fire waits on device
// memory; and 1024 threads cover one fire's RB records in one pass: warp w
// takes records w, w+32, ..., and its 32 threads walk the record's own
// bytes, lanes lo+x, lo+x+32, ... (ceil(len/32) passes, one for most
// records), so a warp reads and writes consecutive bytes of a row (no bank
// conflicts). Each record decodes from its own S and P (the plan's
// per-fire periodic flags and the row alignment of plain records are not
// trusted), padding records are skipped before any address is formed, and
// every read address and written lane stays inside the table, whatever the
// record fields hold.
// The TPU form's one-hot matrix pulls are not copied: on this card a
// shared-memory byte gather is the direct form.
//
// The checksum variant (K1b) also sums byte * ((idx*131+7) & 0xFFFF) over
// idx < ntot into 128 uint32 lane partials (wrapping mod 2^32, the bits of
// the TPU kernel's int32 (1, 128) output); one CTA per plan needs no atomics
// in device memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kRB = 256;                      // records per fire
constexpr int kRecPerWarp = kRB / kWarps;     // 8
constexpr int kLanePerThread = kLanes / 32;   // 4
constexpr int kWR = 512;                      // ring rows (64 KiB window)
constexpr int kRing16 = kWR * kLanes / 16;    // ring size in uint4
constexpr int kShiftPerThread = (kRing16 + kThreads - 1) / kThreads;

// Start the asynchronous copy of one fire's record fields (3 x RB int32,
// 16 B per copying thread) into shared memory, and commit it as one batch.
__device__ __forceinline__ void fetch_fire(int32_t (*dst)[kRB], const int32_t* f0,
                                           const int32_t* f1, const int32_t* f2,
                                           size_t fbase, int tid)
{
    constexpr int kChunks = kRB / 4;  // 16-byte chunks per field
    if (tid < 3 * kChunks) {
        const int field = tid / kChunks;
        const int c = (tid % kChunks) * 4;
        const int32_t* src = (field == 0 ? f0 : field == 1 ? f1 : f2) + fbase + c;
        __pipeline_memcpy_async(&dst[field][c], src, 16);
    }
    __pipeline_commit();
}

template <bool CHECKSUM>
__global__ void __launch_bounds__(kThreads, 1)
ring_decode_kernel(const uint8_t* __restrict__ init,
                   const int32_t* __restrict__ f0,
                   const int32_t* __restrict__ f1,
                   const int32_t* __restrict__ f2,
                   const int32_t* __restrict__ nf_tot,
                   uint8_t* __restrict__ out,
                   int ntiles, int nf, int tile_rows, long long ntot,
                   uint32_t* __restrict__ acc)
{
    extern __shared__ __align__(16) uint8_t tbl[];
    __shared__ uint32_t acc_s[kLanes];
    // Record fields of the current fire and the next one (double buffer).
    __shared__ __align__(16) int32_t rec[2][3][kRB];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int TR = tile_rows;
    const int tile16 = TR * kLanes / 16;
    const int tbl_bytes = (kWR + TR) * kLanes;
    const int row_mask = 2 * TR - 1;
    uint4* tbl4 = reinterpret_cast<uint4*>(tbl);

    uint32_t part[16];
    if (CHECKSUM) {
#pragma unroll
        for (int b = 0; b < 16; ++b) part[b] = 0;
        if (tid < kLanes) acc_s[tid] = 0;
    }

    // Tile 0 sees an all-zero ring.
    for (int i = tid; i < kRing16; i += kThreads) tbl4[i] = make_uint4(0, 0, 0, 0);

    for (int t = 0; t < ntiles; ++t) {
        if (t > 0) {
            // Shift the ring: rows [TR, TR+WR) -> [0, WR). Source and
            // destination overlap when TR < WR, so load everything first.
            uint4 tmp[kShiftPerThread];
#pragma unroll
            for (int k = 0; k < kShiftPerThread; ++k) {
                const int i = tid + k * kThreads;
                if (i < kRing16) tmp[k] = tbl4[tile16 + i];
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kShiftPerThread; ++k) {
                const int i = tid + k * kThreads;
                if (i < kRing16) tbl4[i] = tmp[k];
            }
        }
        // Seed the tile from the literal image.
        const uint4* src = reinterpret_cast<const uint4*>(init) + (size_t)t * tile16;
        for (int i = tid; i < tile16; i += kThreads) tbl4[kRing16 + i] = src[i];
        const int nft = min(nf_tot[t], nf);
        const size_t tbase = (size_t)t * nf * kRB;
        if (nft > 0) fetch_fire(rec[0], f0, f1, f2, tbase, tid);
        __pipeline_wait_prior(0);
        __syncthreads();

        for (int j = 0; j < nft; ++j) {
            // The next fire's records load while this one runs.
            if (j + 1 < nft)
                fetch_fire(rec[(j + 1) & 1], f0, f1, f2, tbase + (size_t)(j + 1) * kRB, tid);
            const int32_t(*cur)[kRB] = rec[j & 1];
            // Phase 1: gather every covered (record, lane) byte into
            // registers; keep each record's destination as row | lo<<9 |
            // hi<<16 (or -1 for padding) for phase 2.
            uint32_t vals[kRecPerWarp];
            int32_t meta[kRecPerWarp];
#pragma unroll
            for (int i = 0; i < kRecPerWarp; ++i) {
                vals[i] = 0;
                meta[i] = -1;
                const int r = warp + i * kWarps;
                const int a2 = cur[2][r];
                const int row = (a2 >> 7) & row_mask;
                if (row >= TR) continue;  // padding: its f0 and f1 may be garbage
                const int S = cur[0][r];
                const int a1 = cur[1][r];
                const int ph = a1 & 127;
                const int P = ((a1 >> 7) & 127) + 1;
                const int lo = (a1 >> 14) & 127;
                // A record may claim lanes past the row (lo+len > 128); the
                // spec masks them, so they must not reach the next row.
                const int hi = min(lo + (a2 & 127) + 1, kLanes);
                meta[i] = row | (lo << 9) | (hi << 16);
#pragma unroll
                for (int k = 0; k < kLanePerThread; ++k) {
                    if (lo + 32 * k >= hi) break;  // warp-uniform: the record is done
                    const int l = lo + lane + 32 * k;
                    if (l >= hi) continue;
                    const int q = P == 128 ? ((l + ph) & 127) : (l + ph) % P;
                    const int idx = min(max(S + q, 0), tbl_bytes - 1);
                    vals[i] |= (uint32_t)tbl[idx] << (8 * k);
                }
            }
            __syncthreads();
            // Phase 2: scatter into the tile.
#pragma unroll
            for (int i = 0; i < kRecPerWarp; ++i) {
                if (meta[i] < 0) continue;
                const int row = meta[i] & 511;
                const int lo = (meta[i] >> 9) & 127;
                const int hi = meta[i] >> 16;
                uint8_t* dst = tbl + (kWR + row) * kLanes;
#pragma unroll
                for (int k = 0; k < kLanePerThread; ++k) {
                    if (lo + 32 * k >= hi) break;
                    const int l = lo + lane + 32 * k;
                    if (l < hi) dst[l] = (uint8_t)(vals[i] >> (8 * k));
                }
            }
            __pipeline_wait_prior(0);
            __syncthreads();
        }

        // Emit the tile (and fold it into the checksum lanes). With 1024
        // threads and 16 B per uint4, thread tid always covers lanes
        // 16*(tid%8) .. +15.
        uint4* dst = reinterpret_cast<uint4*>(out) + (size_t)t * tile16;
        for (int i = tid; i < tile16; i += kThreads) {
            const uint4 v = tbl4[kRing16 + i];
            dst[i] = v;
            if (CHECKSUM) {
                const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
                const uint32_t base = (uint32_t)((size_t)t * tile16 + i) * 16u;
#pragma unroll
                for (int b = 0; b < 16; ++b) {
                    const uint32_t g = base + b;
                    const uint32_t byte = (w4[b >> 2] >> (8 * (b & 3))) & 0xFF;
                    const uint32_t wt = (long long)g < ntot ? ((g * 131u + 7u) & 0xFFFFu) : 0u;
                    part[b] += byte * wt;
                }
            }
        }
        // The next tile's shift reads the table only after its own barrier,
        // which also orders these reads before the seed overwrites the tile.
    }

    if (CHECKSUM) {
#pragma unroll
        for (int b = 0; b < 16; ++b) atomicAdd(&acc_s[16 * (tid & 7) + b], part[b]);
        __syncthreads();
        if (tid < kLanes) acc[tid] = acc_s[tid];
    }
}

template <bool CHECKSUM>
cudaError_t launch(const void* init, const void* f0, const void* f1,
                   const void* f2, const void* nf_tot, void* out,
                   int ntiles, int nf, int tile_rows, long long ntot,
                   void* acc, cudaStream_t stream)
{
    const int smem = (kWR + tile_rows) * kLanes;
    cudaError_t err = cudaFuncSetAttribute(
        ring_decode_kernel<CHECKSUM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ring_decode_kernel<CHECKSUM><<<1, kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(init), static_cast<const int32_t*>(f0),
        static_cast<const int32_t*>(f1), static_cast<const int32_t*>(f2),
        static_cast<const int32_t*>(nf_tot), static_cast<uint8_t*>(out),
        ntiles, nf, tile_rows, ntot, static_cast<uint32_t*>(acc));
    return cudaGetLastError();
}

}  // namespace

// Decode one ring plan. `acc` null selects the plain variant (K1a), else the
// checksum variant (K1b) writes 128 uint32 lane partials there. Shapes:
// init (ntiles*tile_rows, 128) u8, f0/f1/f2 (ntiles, nf, 256) i32, nf_tot
// (ntiles,) i32, out (ntiles*tile_rows, 128) u8. The window is 512 rows.
// Returns the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int tlz4_ring_decode(const void* init, const void* f0,
                                const void* f1, const void* f2,
                                const void* nf_tot, void* out,
                                int ntiles, int nf, int tile_rows,
                                long long ntot, void* acc, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (acc != nullptr)
        return (int)launch<true>(init, f0, f1, f2, nf_tot, out, ntiles, nf,
                                 tile_rows, ntot, acc, s);
    return (int)launch<false>(init, f0, f1, f2, nf_tot, out, ntiles, nf,
                              tile_rows, ntot, acc, s);
}

extern "C" const char* tlz4_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
