// K1: the LZ4 ring decoder for NVIDIA Hopper (sm_90a), C interface.
//
// Replaces the Pallas TPU kernel `_ring_kernel` (lz4_flex_tpu/ops/ringdecode.py).
// The kernel, what bounds it and what its design does about that are in
// ring_decode.cuh; experiments/fire_probe.py measures it against the first
// design (csrc/fire_probe.cu, variant `base`).

#include "ring_decode.cuh"

// Decode one ring plan. `acc` null selects the plain variant (K1a), else the
// checksum variant (K1b) writes 128 uint32 lane partials there. Shapes:
// init (ntiles*tile_rows, 128) u8, f0/f1/f2 (ntiles, nf, 256) i32, nf_tot
// (ntiles,) i32, out (ntiles*tile_rows, 128) u8, all 16-byte aligned; the
// window is 512 rows and tile_rows one of 64, 128, 256, 512. Returns the
// launch's cudaError_t (0 on success); never synchronizes.
extern "C" int tlz4_ring_decode(const void* init, const void* f0, const void* f1, const void* f2,
                                const void* nf_tot, void* out, int ntiles, int nf, int tile_rows,
                                long long ntot, void* acc, void* stream)
{
    return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps>(
        tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, ntot, acc,
        static_cast<cudaStream_t>(stream));
}

extern "C" const char* tlz4_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
