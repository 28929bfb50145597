// K1: the LZ4 ring decoder for NVIDIA Hopper (sm_90a), C interface.
//
// Replaces the Pallas TPU kernel `_ring_kernel` (lz4_flex_tpu/ops/ringdecode.py),
// launched on one plan (K1a, K1b) or, as K1c, on the plans of several device
// groups at once (lz4_flex_tpu/parallel/pipeline.py:decode_blocks_sharded_ring).
// The kernel, what bounds it and what its design does about that are in
// ring_decode.cuh; experiments/fire_probe.py measures it against the first
// design (csrc/fire_probe.cu, variant `base`).

#include "ring_decode.cuh"

// Decode `nplans` ring plans padded to one shape and stacked, one CTA each:
// one plan is K1a, or with `acc` K1b (its checksum variant writes 128 uint32
// lane partials there; one plan only); several are K1c. Shapes: init and out
// (nplans, ntiles*tile_rows, 128) u8, f0/f1/f2 (nplans, ntiles, nf, 256) i32,
// nf_tot (nplans, ntiles) i32, each contiguous and 16-byte aligned; the
// window is 512 rows and tile_rows one of 64, 128, 256, 512. Returns the
// launch's cudaError_t (0 on success); never synchronizes.
extern "C" int tlz4_ring_decode(const void* init, const void* f0, const void* f1, const void* f2,
                                const void* nf_tot, void* out, int nplans, int ntiles, int nf,
                                int tile_rows, long long ntot, void* acc, void* stream)
{
    return (int)tlz4::launch_ring_v2_rows<tlz4::kFireWarps>(
        tile_rows, init, f0, f1, f2, nf_tot, out, ntiles, nf, ntot, acc,
        static_cast<cudaStream_t>(stream), nplans);
}

extern "C" const char* tlz4_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
