// Gather probe: in-kernel gathers and row moves from a table resident in
// shared memory, one CTA of 1024 threads (the ring decoder's situation), for
// NVIDIA Hopper (sm_90a).
//
// The Hopper counterpart of the TPU probes experiments/pallas_gather_forms.py
// (G1 flat 1-D, G2 within-row lane, G3 row select, G4 2-D, G5 per-row dynamic
// slice), pallas_rowsel_forms.py, pallas_rowsel2.py, pallas_rowsel3.py (row
// select y[i,:] = x[q[i],:]) and rowgather_forms.py (unaligned row gather at
// arbitrary byte starts, and the row scatter on the write side). The TPU
// forms (one-hot matrix pulls, transpose sandwiches) are not copied; each
// function gets the forms worth comparing on this card:
//
//   byte   one output byte per thread per step
//   vec16  16 output bytes per thread, stored as one uint4 (for an unaligned
//          row: two aligned uint4 loads joined by __funnelshift_r)
//   warp   one warp per row, 4 bytes per lane (lane gather: the row sits in
//          the warp's registers and bytes move by __shfl_sync; unaligned row:
//          two aligned words per lane joined by __funnelshift_r)
//
// Table: 768 rows x 128 B = 96 KiB (K1's window and tile at TR=256); output
// 128 rows x 128 B = 16 KiB. Functions (idx as int32):
//   flat        out[e]     = tbl[idx[e]],            e < 16384, idx < 98304
//   lane        out[i][l]  = tbl[i][idx[i*128+l]],   i < 128, idx < 128
//   rowsel      out[i][:]  = tbl[idx[i]][:],         idx < 768
//   rowgather   out[i][l]  = tbl_flat[idx[i] + l],   idx <= 98304 - 128
//   rowscatter  out[idx[i]][:] = tbl[i][:],          idx a permutation of 0..127
// The kernel fills the table from device memory, runs the function `reps`
// times into a shared output buffer (a CTA barrier after each pass, as after
// each of K1's fires), and writes the buffer out. Every variant is exact;
// experiments/gather_probe.py holds it against tensor indexing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTblRows = 768;
constexpr int kTblBytes = kTblRows * 128;
constexpr int kOutRows = 128;
constexpr int kOutBytes = kOutRows * 128;
constexpr int kPerThread = kOutBytes / kThreads;  // 16
constexpr uint32_t kFull = 0xffffffffu;

enum Variant {
    kFlatByte = 0,
    kFlatVec16,
    kLaneByte,
    kLaneWarp,
    kRowselByte,
    kRowselVec16,
    kRowselWarp,
    kRowgatherByte,
    kRowgatherVec16,
    kRowgatherWarp,
    kRowscatterByte,
    kRowscatterVec16,
    kRowscatterWarp,
    kNumVariants
};

// `x`, hidden from the compiler, so that a pass's table reads are not hoisted
// out of the loop of passes (the table does not change between passes).
__device__ __forceinline__ int opaque(int x)
{
    asm volatile("" : "+r"(x));
    return x;
}

// 16 bytes starting at byte `start` of the table, from two aligned uint4s.
__device__ __forceinline__ uint4 unaligned16(const uint4* tbl4, int start)
{
    const int a = start >> 4;
    const int sh = start & 15;
    const uint4 A = tbl4[a];
    const uint4 B = tbl4[min(a + 1, kTblBytes / 16 - 1)];  // unused when sh == 0
    const uint32_t w[8] = {A.x, A.y, A.z, A.w, B.x, B.y, B.z, B.w};
    const int ws = sh >> 2;
    const uint32_t bs = 8u * (uint32_t)(sh & 3);
    uint32_t r[5];
#pragma unroll
    for (int j = 0; j < 5; ++j)
        r[j] = ws == 0 ? w[j] : ws == 1 ? w[j + 1] : ws == 2 ? w[j + 2] : w[j + 3];
    return make_uint4(__funnelshift_r(r[0], r[1], bs), __funnelshift_r(r[1], r[2], bs),
                      __funnelshift_r(r[2], r[3], bs), __funnelshift_r(r[3], r[4], bs));
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
gather_kernel(const uint8_t* __restrict__ tbl_g, const int32_t* __restrict__ idx_g,
              uint8_t* __restrict__ out_g, int reps)
{
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* tbl = smem;
    uint8_t* obuf = smem + kTblBytes;
    const uint4* tbl4 = reinterpret_cast<const uint4*>(tbl);
    const uint32_t* tbl32 = reinterpret_cast<const uint32_t*>(tbl);
    uint4* obuf4 = reinterpret_cast<uint4*>(obuf);
    uint32_t* obuf32 = reinterpret_cast<uint32_t*>(obuf);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int i = tid; i < kTblBytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(tbl)[i] = reinterpret_cast<const uint4*>(tbl_g)[i];

    // Each thread's indices (or addresses) live in registers for all passes.
    int a[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int e = tid + k * kThreads;  // byte forms: output byte e
        const int r = warp + 32 * (k >> 2);  // warp forms: row r, lane's bytes 4*lane + (k & 3)
        if (V == kFlatByte) a[k] = idx_g[e];
        if (V == kFlatVec16) a[k] = idx_g[16 * tid + k];
        if (V == kLaneByte) a[k] = (e & ~127) + idx_g[e];
        if (V == kLaneWarp) a[k] = idx_g[r * 128 + 4 * lane + (k & 3)];
        if (V == kRowselByte) a[k] = idx_g[e >> 7] * 128 + (e & 127);
        if (V == kRowgatherByte) a[k] = idx_g[e >> 7] + (e & 127);
        if (V == kRowscatterByte) a[k] = idx_g[e >> 7] * 128 + (e & 127);
        if (V == kRowselWarp && (k & 3) == 0) a[k] = idx_g[r] * 32 + lane;
        if (V == kRowgatherWarp && (k & 3) == 0) a[k] = idx_g[r] + 4 * lane;
        if (V == kRowscatterWarp && (k & 3) == 0) a[k] = idx_g[r] * 32 + lane;
    }
    // vec16 row forms: one 16-byte chunk per thread (row tid/8, part tid%8).
    const int vrow = tid >> 3, vpart = tid & 7;
    int va = 0;
    if (V == kRowselVec16) va = idx_g[vrow] * 8 + vpart;
    if (V == kRowgatherVec16) va = idx_g[vrow] + 16 * vpart;
    if (V == kRowscatterVec16) va = idx_g[vrow] * 8 + vpart;
    __syncthreads();

    for (int rep = 0; rep < reps; ++rep) {
        if (V == kFlatByte || V == kLaneByte || V == kRowselByte || V == kRowgatherByte) {
#pragma unroll
            for (int k = 0; k < kPerThread; ++k) obuf[tid + k * kThreads] = tbl[opaque(a[k])];
        } else if (V == kRowscatterByte) {
#pragma unroll
            for (int k = 0; k < kPerThread; ++k) obuf[a[k]] = tbl[opaque(tid + k * kThreads)];
        } else if (V == kFlatVec16) {
            uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
            for (int k = 0; k < kPerThread; ++k) w[k >> 2] |= (uint32_t)tbl[opaque(a[k])] << (8 * (k & 3));
            obuf4[tid] = make_uint4(w[0], w[1], w[2], w[3]);
        } else if (V == kLaneWarp) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = warp + 32 * r;
                const uint32_t wd = tbl32[opaque(row * 32 + lane)];
                uint32_t o = 0;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int l = a[4 * r + c];
                    o |= ((__shfl_sync(kFull, wd, l >> 2) >> (8 * (l & 3))) & 0xFFu) << (8 * c);
                }
                obuf32[row * 32 + lane] = o;
            }
        } else if (V == kRowselWarp) {
#pragma unroll
            for (int r = 0; r < 4; ++r) obuf32[(warp + 32 * r) * 32 + lane] = tbl32[opaque(a[4 * r])];
        } else if (V == kRowgatherWarp) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int s = opaque(a[4 * r]);
                const int wi = s >> 2;
                const uint32_t lo = tbl32[wi];
                const uint32_t hi = tbl32[min(wi + 1, kTblBytes / 4 - 1)];
                obuf32[(warp + 32 * r) * 32 + lane] = __funnelshift_r(lo, hi, 8u * (uint32_t)(s & 3));
            }
        } else if (V == kRowscatterWarp) {
#pragma unroll
            for (int r = 0; r < 4; ++r) obuf32[a[4 * r]] = tbl32[opaque((warp + 32 * r) * 32 + lane)];
        } else if (V == kRowselVec16) {
            obuf4[tid] = tbl4[opaque(va)];
        } else if (V == kRowgatherVec16) {
            obuf4[tid] = unaligned16(tbl4, opaque(va));
        } else if (V == kRowscatterVec16) {
            obuf4[va] = tbl4[opaque(tid)];
        }
        __syncthreads();
    }
    reinterpret_cast<uint4*>(out_g)[tid] = obuf4[tid];
}

template <int V>
cudaError_t launch(const void* tbl, const void* idx, void* out, int reps, cudaStream_t stream)
{
    const int smem = kTblBytes + kOutBytes;
    cudaError_t err =
        cudaFuncSetAttribute(gather_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gather_kernel<V><<<1, kThreads, smem, stream>>>(static_cast<const uint8_t*>(tbl),
                                                    static_cast<const int32_t*>(idx),
                                                    static_cast<uint8_t*>(out), reps);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tlz4_gather_probe_variants(void) { return kNumVariants; }

// Run variant `variant` (the enum above): tbl (768, 128) u8, idx int32
// (16384 for flat and lane, else 128), out (128, 128) u8, all on the card
// and 16-byte aligned. Returns the launch's cudaError_t; never synchronizes.
extern "C" int tlz4_gather_probe(int variant, const void* tbl, const void* idx, void* out, int reps,
                                 void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
        case kFlatByte: return (int)launch<kFlatByte>(tbl, idx, out, reps, s);
        case kFlatVec16: return (int)launch<kFlatVec16>(tbl, idx, out, reps, s);
        case kLaneByte: return (int)launch<kLaneByte>(tbl, idx, out, reps, s);
        case kLaneWarp: return (int)launch<kLaneWarp>(tbl, idx, out, reps, s);
        case kRowselByte: return (int)launch<kRowselByte>(tbl, idx, out, reps, s);
        case kRowselVec16: return (int)launch<kRowselVec16>(tbl, idx, out, reps, s);
        case kRowselWarp: return (int)launch<kRowselWarp>(tbl, idx, out, reps, s);
        case kRowgatherByte: return (int)launch<kRowgatherByte>(tbl, idx, out, reps, s);
        case kRowgatherVec16: return (int)launch<kRowgatherVec16>(tbl, idx, out, reps, s);
        case kRowgatherWarp: return (int)launch<kRowgatherWarp>(tbl, idx, out, reps, s);
        case kRowscatterByte: return (int)launch<kRowscatterByte>(tbl, idx, out, reps, s);
        case kRowscatterVec16: return (int)launch<kRowscatterVec16>(tbl, idx, out, reps, s);
        case kRowscatterWarp: return (int)launch<kRowscatterWarp>(tbl, idx, out, reps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* tlz4_gather_probe_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
