// Fire probe: the ring decoder's fire loop on a real plan, in compile-time
// variants, for NVIDIA Hopper (sm_90a).
//
// The Hopper counterpart of the TPU fire-step probes (experiments/fire_step.py,
// fire_ablate.py, fire_ablate3.py, fire_ablate5.py, batchfire.py,
// batchfire2.py): which part of a fire owns its cost, and how the cost of a
// fire of 256 records moves with the threads that run it.
//
//   base        the first design of K1, verbatim (1024 threads; the ring
//               shifted through registers each tile, the tile seeded by a
//               synchronous load, 8 records per warp walked one after another)
//   base_t512,  the same body with 512 and 256 threads (16 and 32 records
//   base_t256   per warp)
//   v2, v2_t512 the second design (ring_decode.cuh) with 30 fire warps (the
//               production K1a) and with 16 (512 fire threads)
//   v2_nofires  ablations of v2, timing only: no fires (the tile pipeline
//   v2_notable  alone), fires without table reads and writes, and fires
//   v2_nobarrier without table work and without their two barriers
//   ablations of base, output wrong by design, timing only:
//     nofields   constant record fields in place of the shared-memory loads
//     nomod      `& 127` in place of `% P`
//     nogather   no table read: the gathered byte is the address's low byte
//     noscatter  no tile write (the gathered bytes feed a sink instead)
//     onebarrier no barrier between a fire's gather and its scatter
//     noshift    no ring shift
//     noseed     no seeding of the tile from the literal image
//     noemit     no write of the tile to the output
//
// Every exact variant computes ring_decode_reference; bounds and times are
// printed by experiments/fire_probe.py.

#include <cuda_pipeline.h>

#include "ring_decode.cuh"

namespace {

enum Variant {
    kBase = 0,
    kNoFields,
    kNoMod,
    kNoGather,
    kNoScatter,
    kOneBarrier,
    kNoShift,
    kNoSeed,
    kNoEmit,
    kBaseT512,
    kBaseT256,
    kV2,
    kV2T512,
    kV2NoFires,
    kV2NoTable,
    kV2NoBarrier,
    kNumVariants
};

constexpr int kLanes = 128;
constexpr int kRB = 256;
constexpr int kWR = 512;
constexpr int kLanePerThread = kLanes / 32;
constexpr int kRing16 = kWR * kLanes / 16;

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

// The first design's K1a body; ABL selects one ablation (kBase: none).
template <int THREADS, int ABL>
__global__ void __launch_bounds__(THREADS, 1)
base_kernel(const uint8_t* __restrict__ init, const int32_t* __restrict__ f0,
            const int32_t* __restrict__ f1, const int32_t* __restrict__ f2,
            const int32_t* __restrict__ nf_tot, uint8_t* __restrict__ out,
            int ntiles, int nf, int tile_rows)
{
    constexpr int kWarps = THREADS / 32;
    constexpr int kRecPerWarp = kRB / kWarps;
    constexpr int kShiftPerThread = (kRing16 + THREADS - 1) / THREADS;
    extern __shared__ __align__(16) uint8_t tbl[];
    __shared__ __align__(16) int32_t rec[2][3][kRB];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int TR = tile_rows;
    const int tile16 = TR * kLanes / 16;
    const int tbl_bytes = (kWR + TR) * kLanes;
    const int row_mask = 2 * TR - 1;
    uint4* tbl4 = reinterpret_cast<uint4*>(tbl);
    uint32_t sink = 0;

    for (int i = tid; i < kRing16; i += THREADS) tbl4[i] = make_uint4(0, 0, 0, 0);

    for (int t = 0; t < ntiles; ++t) {
        if (t > 0 && ABL != kNoShift) {
            uint4 tmp[kShiftPerThread];
#pragma unroll
            for (int k = 0; k < kShiftPerThread; ++k) {
                const int i = tid + k * THREADS;
                if (i < kRing16) tmp[k] = tbl4[tile16 + i];
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kShiftPerThread; ++k) {
                const int i = tid + k * THREADS;
                if (i < kRing16) tbl4[i] = tmp[k];
            }
        }
        if (ABL != kNoSeed) {
            const uint4* src = reinterpret_cast<const uint4*>(init) + (size_t)t * tile16;
            for (int i = tid; i < tile16; i += THREADS) tbl4[kRing16 + i] = src[i];
        }
        const int nft = min(nf_tot[t], nf);
        const size_t tbase = (size_t)t * nf * kRB;
        if (nft > 0) fetch_fire(rec[0], f0, f1, f2, tbase, tid);
        __pipeline_wait_prior(0);
        __syncthreads();

        for (int j = 0; j < nft; ++j) {
            if (j + 1 < nft)
                fetch_fire(rec[(j + 1) & 1], f0, f1, f2, tbase + (size_t)(j + 1) * kRB, tid);
            const int32_t(*cur)[kRB] = rec[j & 1];
            uint32_t vals[kRecPerWarp];
            int32_t meta[kRecPerWarp];
#pragma unroll
            for (int i = 0; i < kRecPerWarp; ++i) {
                vals[i] = 0;
                meta[i] = -1;
                const int r = warp + i * kWarps;
                const int a2 = ABL == kNoFields ? (15 | ((r & (TR - 1)) << 7)) : cur[2][r];
                const int row = (a2 >> 7) & row_mask;
                if (row >= TR) continue;
                const int S = ABL == kNoFields ? r * kLanes : cur[0][r];
                const int a1 = ABL == kNoFields ? (127 << 7) : cur[1][r];
                const int ph = a1 & 127;
                const int P = ((a1 >> 7) & 127) + 1;
                const int lo = (a1 >> 14) & 127;
                const int hi = min(lo + (a2 & 127) + 1, kLanes);
                meta[i] = row | (lo << 9) | (hi << 16);
#pragma unroll
                for (int k = 0; k < kLanePerThread; ++k) {
                    if (lo + 32 * k >= hi) break;
                    const int l = lo + lane + 32 * k;
                    if (l >= hi) continue;
                    const int q = ABL == kNoMod ? ((l + ph) & 127)
                                                : (P == 128 ? ((l + ph) & 127) : (l + ph) % P);
                    const int idx = min(max(S + q, 0), tbl_bytes - 1);
                    vals[i] |= (uint32_t)(ABL == kNoGather ? (idx & 255) : tbl[idx]) << (8 * k);
                }
            }
            if (ABL != kOneBarrier) __syncthreads();
#pragma unroll
            for (int i = 0; i < kRecPerWarp; ++i) {
                if (meta[i] < 0) continue;
                if (ABL == kNoScatter) {
                    sink ^= vals[i] + (uint32_t)meta[i];
                    continue;
                }
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

        if (ABL != kNoEmit) {
            uint4* dst = reinterpret_cast<uint4*>(out) + (size_t)t * tile16;
            for (int i = tid; i < tile16; i += THREADS) dst[i] = tbl4[kRing16 + i];
        }
    }
    if (ABL == kNoScatter && sink == 0x9E3779B9u) out[0] = (uint8_t)tid;  // keeps the gathers live
}

template <int THREADS, int ABL>
cudaError_t launch_base(const void* init, const void* f0, const void* f1, const void* f2,
                        const void* nf_tot, void* out, int ntiles, int nf, int tile_rows,
                        cudaStream_t stream)
{
    const int smem = (kWR + tile_rows) * kLanes;
    cudaError_t err = cudaFuncSetAttribute(base_kernel<THREADS, ABL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    base_kernel<THREADS, ABL><<<1, THREADS, smem, stream>>>(
        static_cast<const uint8_t*>(init), static_cast<const int32_t*>(f0),
        static_cast<const int32_t*>(f1), static_cast<const int32_t*>(f2),
        static_cast<const int32_t*>(nf_tot), static_cast<uint8_t*>(out), ntiles, nf, tile_rows);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tlz4_fire_probe_variants(void) { return kNumVariants; }

// Run variant `variant` (see the list above) over one uploaded ring plan,
// with the shapes of tlz4_ring_decode (csrc/ring_decode.cu). Returns the
// launch's cudaError_t; never synchronizes.
extern "C" int tlz4_fire_probe(int variant, const void* init, const void* f0, const void* f1,
                               const void* f2, const void* nf_tot, void* out, int ntiles, int nf,
                               int tile_rows, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TLZ4_BASE(T, A) return (int)launch_base<T, A>(init, f0, f1, f2, nf_tot, out, ntiles, nf, tile_rows, s)
    switch (variant) {
        case kBase: TLZ4_BASE(1024, kBase);
        case kNoFields: TLZ4_BASE(1024, kNoFields);
        case kNoMod: TLZ4_BASE(1024, kNoMod);
        case kNoGather: TLZ4_BASE(1024, kNoGather);
        case kNoScatter: TLZ4_BASE(1024, kNoScatter);
        case kOneBarrier: TLZ4_BASE(1024, kOneBarrier);
        case kNoShift: TLZ4_BASE(1024, kNoShift);
        case kNoSeed: TLZ4_BASE(1024, kNoSeed);
        case kNoEmit: TLZ4_BASE(1024, kNoEmit);
        case kBaseT512: TLZ4_BASE(512, kBase);
        case kBaseT256: TLZ4_BASE(256, kBase);
        case kV2:
            return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps>(
                tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, -1, nullptr, s);
        case kV2T512:
            return (int)tlz4::launch_ring_v2_rows<16>(tile_rows, init, f0, f1, f2, nf_tot, out,
                                                         ntiles, nf, -1, nullptr, s);
        case kV2NoFires:
            return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps, tlz4::kNoFires>(
                tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, -1, nullptr, s);
        case kV2NoTable:
            return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps, tlz4::kNoTable>(
                tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, -1, nullptr, s);
        case kV2NoBarrier:
            return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps, tlz4::kNoBarrier>(
                tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, -1, nullptr, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef TLZ4_BASE
}

extern "C" const char* tlz4_fire_probe_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
