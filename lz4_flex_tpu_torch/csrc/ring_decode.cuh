// K1 (second design): the LZ4 ring decoder for NVIDIA Hopper (sm_90a).
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
// writes, and the writes within one fire are disjoint. Addresses are clamped
// into the table and lanes past 128 are masked, as in the spec.
//
// What bounds it: the ring makes one plan's tiles a serial chain, so one CTA
// on one SM walks them all; each fire is a gather, a barrier, a scatter and a
// barrier over the fire warps. The time is the fires' table work (warp
// instructions per record on one SM) plus each fire's fixed skeleton (field
// decode, two barriers) plus the tiles' bulk copies through one SM, far
// above the device-memory bound (PERF.md has the split that
// experiments/fire_probe.py measures).
//
// What this design does about it:
//  * A circular table of NR = WR + 2*TR rows in dynamic shared memory (96+32
//    KiB at TR=256, 192 KiB at TR=512) holds tile t's window, tile t, and a
//    free slot for tile t+1. Output row o lives in physical row
//    (o + WR) mod NR, so the spec's table byte S of tile t is physical byte
//    (S + t*TR*128) mod (NR*128): the first design's 64 KiB shift per tile is
//    gone.
//  * Warp specialisation. A tile-producer thread loads tile t+1's literal
//    image into the free slot by one bulk copy (TMA, mbarrier completion)
//    while tile t's fires run, and stores each finished tile from shared
//    memory to the output by one bulk store; a slot is loaded again only
//    after its store has read it. A record-producer thread keeps the record
//    fields of the next kRecStages fires in flight by bulk copies.
//  * A cheaper fire. Every warp the producers leave is a fire warp (30),
//    synchronised by a named barrier that the producers do not join. A
//    record is taken by a half-warp, 16 lanes a pass (records are 7-8 bytes
//    on average on the probe's soups, so a whole warp per record left three
//    lanes in four idle): half-warp g of the 60 takes records g, g+60, ...
//    Lane x of a warp loads and decodes one of the warp's records (padding
//    is recognised from f2 before f0/f1 are loaded) into three packed words,
//    and the half-warps take them by shuffle, so the dependent chain of field
//    loads is paid once per warp and fire. The first pass of all a warp's
//    records is gathered without branches, so their loads overlap, and only
//    as many steps as the warp has live records run. `% P` is a multiply and
//    shift by a per-record reciprocal from a 129-entry table. Both barriers
//    of a fire stay: records of one fire may read rows that the same fire
//    writes.
//  * K1b's checksum is a second kernel over the decoded output, across the
//    whole card (ring_checksum_kernel), in 32-bit index arithmetic with the
//    ntot mask only on the last chunks; on the single SM that decodes, the
//    fold would take instruction slots from the fire warps.
//  * K1c, the grouped launch (the TPU form's shard_map dispatch of G device
//    groups' plans, lz4_flex_tpu/parallel/pipeline.py:decode_blocks_sharded_ring):
//    the grid is one CTA per plan. G plans padded to one (ntiles, nf) shape
//    lie back to back, so CTA g finds its literal image and output at
//    g*ntiles*TR*128 bytes, its record fields at g*ntiles*nf*RB words and its
//    fire counts at g*ntiles words (read by plain loads, never by a bulk
//    copy, so that stride needs no 16-byte alignment). Each CTA walks its
//    plan with its own circular table; with up to 227 KB of shared memory on
//    an SM one CTA fits on each, so 132 plans run at once and the rest queue.
//    K1a is the G = 1 case. Padding tiles (nf_tot = 0) emit their zero
//    literal image, which no caller reads.
// The TPU form's one-hot matrix pulls are not copied: on this card a
// shared-memory byte gather is the direct form.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tlz4 {

constexpr int kLanes = 128;
constexpr int kRB = 256;        // records per fire
constexpr int kWR = 512;        // ring rows (64 KiB window)
constexpr int kRecStages = 4;   // fires of record fields in flight
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return ok != 0;
}

// Wait until the phase of `bar` with parity `parity` has completed. A wait
// of ~20 s (an arrival that never comes) traps, so that the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity)) {
        if (clock64() - t0 > 40000000000LL) __trap();
    }
}

// Bulk copy (TMA, 1-D) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory; completion is counted on
// `bar` in bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Bulk store from shared memory to device memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes)
{
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// At most N of this thread's committed bulk stores may still be reading
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read()
{
    asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// All of this thread's bulk stores have completed.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// Order this thread's shared-memory writes before later bulk copies (the
// async proxy) that read or overwrite them.
__device__ __forceinline__ void fence_async_smem()
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int nthreads)
{
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// FW fire warps and two producer warps.
template <int TR, int FW>
struct RingCfg {
    static_assert(TR >= 64 && TR <= 512 && (TR & (TR - 1)) == 0, "TR: a power of two in [64, 512]");
    static constexpr int W = kWR / TR;            // window slots
    static constexpr int NS = W + 2;              // slots: window, tile, free
    static constexpr int NRB = NS * TR * kLanes;  // circular table bytes
    static constexpr int TB = (kWR + TR) * kLanes;  // the spec's table bytes
    static constexpr int TILE_B = TR * kLanes;
    static constexpr int FT = FW * 32;            // fire threads
    static constexpr int NG = 2 * FW;             // half-warps
    static constexpr int RPG = (kRB + NG - 1) / NG;  // records per half-warp (at most)
    static constexpr int THREADS = FT + 64;
    static_assert(2 * RPG <= 32 && THREADS <= 1024, "FW: fire warps that fit one CTA");
};

// Fire warps of the production launch: every warp the producers leave.
constexpr int kFireWarps = 30;

// Ablations of the second design for experiments/fire_probe.py (timing
// only, output wrong by design); production launches use kNoAblation.
enum V2Ablation {
    kNoAblation = 0,   // the production kernel
    kNoFires,     // no fires: the tile pipeline alone (literal in, tile out)
    kNoTable,     // fires without their table reads and writes
    kNoBarrier,   // fires without table work and without their two barriers
};

// Physical table byte that lane offset `off` (= l - lo) of a record reads:
// the spec's S + (l+ph) mod P, clamped into the spec's table, moved to the
// circular table by `base`. pk = (lo+ph) | P<<8 | m<<16 with m = ceil(2^15/P),
// so that x mod P = x - ((x*m)>>15)*P for every x <= 254 (x*(m*P - 2^15) < 2^15).
template <class C>
__device__ __forceinline__ int gather_addr(int S, uint32_t pk, int off, int base)
{
    const int x = (int)(pk & 255) + off;  // l + ph <= 254
    const int q = x - ((x * (int)(pk >> 16)) >> 15) * (int)((pk >> 8) & 255);
    const int idx = min(max((int)((uint32_t)S + (uint32_t)q), 0), C::TB - 1) + base;
    return idx >= C::NRB ? idx - C::NRB : idx;
}

// One fire's records in STEPS steps of the calling warp: gather, the
// mid-fire barrier (after which `rec_empty` is released), scatter. Lane
// x = h*RPG + i holds the packed words of half-warp h's record of step i:
// dm = (physical byte of its first lane) | n<<18 (n lanes, 0 for padding),
// pk (gather_addr) and S.
template <class C, int STEPS, int ABL>
__device__ __forceinline__ void fire_records(uint8_t* tbl, uint32_t dm_own, uint32_t pk_own,
                                             int S_own, int base, int lane, uint64_t* rec_empty)
{
    const int u = lane & 15;
    const int sl = (lane >> 4) * C::RPG;
    const bool wide = __any_sync(kFull, (dm_own >> 18) > 16);  // a record needs a second pass
    uint32_t dm[STEPS], v0[STEPS], v1[STEPS];  // bytes of passes 0-3 and 4-7
    int src[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
        dm[i] = __shfl_sync(kFull, dm_own, sl + i);
        const uint32_t pk = __shfl_sync(kFull, pk_own, sl + i);
        const int S = __shfl_sync(kFull, S_own, sl + i);
        src[i] = u < (int)(dm[i] >> 18) ? gather_addr<C>(S, pk, u, base) : -1;
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
        v0[i] = src[i] >= 0 && ABL == kNoAblation ? (uint32_t)tbl[src[i]] : 0u;
        v1[i] = 0;
    }
    if (wide && ABL == kNoAblation) {
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
            const int n = dm[i] >> 18;
            if (!__any_sync(kFull, n > 16)) continue;
            const uint32_t pk = __shfl_sync(kFull, pk_own, sl + i);
            const int S = __shfl_sync(kFull, S_own, sl + i);
#pragma unroll
            for (int p = 1; p < kLanes / 16; ++p) {
                if (!__any_sync(kFull, n > 16 * p)) break;
                if (u + 16 * p < n) {
                    const uint32_t b = tbl[gather_addr<C>(S, pk, u + 16 * p, base)];
                    if (p < 4) v0[i] |= b << (8 * p);
                    else v1[i] |= b << (8 * (p - 4));
                }
            }
        }
    }
    if (ABL != kNoBarrier) named_sync(1, C::FT);
    if (threadIdx.x == 0) mbar_arrive(rec_empty);  // the fields are in registers
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
        if (u < (int)(dm[i] >> 18) && ABL == kNoAblation) tbl[(dm[i] & 0x3FFFF) + u] = (uint8_t)v0[i];
    if (wide && ABL == kNoAblation) {
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
            const int n = dm[i] >> 18;
            if (!__any_sync(kFull, n > 16)) continue;
#pragma unroll
            for (int p = 1; p < kLanes / 16; ++p) {
                if (!__any_sync(kFull, n > 16 * p)) break;
                if (u + 16 * p < n)
                    tbl[(dm[i] & 0x3FFFF) + u + 16 * p] =
                        (uint8_t)((p < 4 ? v0[i] : v1[i]) >> (8 * (p & 3)));
            }
        }
    }
}

template <int TR, int FW, int ABL>
__global__ void __launch_bounds__(RingCfg<TR, FW>::THREADS, 1)
ring_decode_v2(const uint8_t* __restrict__ init, const int32_t* __restrict__ f0,
               const int32_t* __restrict__ f1, const int32_t* __restrict__ f2,
               const int32_t* __restrict__ nf_tot, uint8_t* __restrict__ out, int ntiles, int nf)
{
    using C = RingCfg<TR, FW>;
    extern __shared__ __align__(128) uint8_t tbl[];
    __shared__ __align__(128) int32_t rec[kRecStages][3][kRB];
    __shared__ __align__(8) uint64_t lit_full[C::NS];   // slot's literal image landed
    __shared__ __align__(8) uint64_t tile_done[C::NS];  // slot's tile fully decoded
    __shared__ __align__(8) uint64_t rec_full[kRecStages];
    __shared__ __align__(8) uint64_t rec_empty[kRecStages];
    __shared__ uint32_t recip[kLanes + 1];  // recip[P] = ceil(2^15 / P)

    const int tid = threadIdx.x;
    const int lane = tid & 31;

    // This CTA's plan (K1c: one CTA per plan; K1a: the only one).
    {
        const size_t g = blockIdx.x;
        init += g * ntiles * C::TILE_B;
        out += g * ntiles * C::TILE_B;
        f0 += g * ntiles * nf * kRB;
        f1 += g * ntiles * nf * kRB;
        f2 += g * ntiles * nf * kRB;
        nf_tot += g * ntiles;
    }

    // Output rows -WR..-1 (physical rows 0..WR-1) are zeros for tile 0.
    uint4* tbl4 = reinterpret_cast<uint4*>(tbl);
    for (int i = tid; i < kWR * kLanes / 16; i += C::THREADS) tbl4[i] = make_uint4(0, 0, 0, 0);
    if (tid <= kLanes) recip[tid] = tid ? (32768u + tid - 1) / tid : 0;
    if (tid == 0) {
        for (int s = 0; s < C::NS; ++s) {
            mbar_init(&lit_full[s], 1);
            mbar_init(&tile_done[s], 1);
        }
        for (int s = 0; s < kRecStages; ++s) {
            mbar_init(&rec_full[s], 1);
            mbar_init(&rec_empty[s], 1);
        }
        fence_mbar_init();
    }
    fence_async_smem();  // the zeros are overwritten by bulk copies later
    __syncthreads();

    if (tid < C::FT) {
        // ---- fire warps ----------------------------------------------------
        // Half-warp g = 2*warp + h takes records g, g+NG, g+2*NG, ...; lane
        // x < 2*RPG of the warp decodes the record of half x/RPG, step x%RPG.
        const int warp = tid >> 5;
        const int r = 2 * warp + lane / C::RPG + C::NG * (lane % C::RPG);
        int k = 0;                       // fire index over the whole plan
        int s = C::W;                    // slot of tile t
        int base = 0;                    // physical byte of the spec's byte 0
        int nft_next = ntiles > 0 ? nf_tot[0] : 0;
        for (int t = 0; t < ntiles; ++t) {
            const int nft = ABL == kNoFires ? 0 : min(nft_next, nf);
            if (t + 1 < ntiles) nft_next = nf_tot[t + 1];
            const int tile_off = s * C::TILE_B;
            mbar_wait(&lit_full[s], (t / C::NS) & 1);
            for (int j = 0; j < nft; ++j, ++k) {
                const int st = k % kRecStages;
                mbar_wait(&rec_full[st], (k / kRecStages) & 1);
                const int32_t(*cur)[kRB] = rec[st];
                uint32_t dm_own = 0, pk_own = 0;
                int S_own = 0;
                if (lane < 2 * C::RPG && r < kRB) {
                    const int a2 = cur[2][r];
                    const int row = (a2 >> 7) & (2 * TR - 1);
                    if (row < TR) {
                        const int a1 = cur[1][r];
                        S_own = cur[0][r];
                        const int ph = a1 & 127;
                        const int P = ((a1 >> 7) & 127) + 1;
                        const int lo = (a1 >> 14) & 127;
                        const int n = min(lo + (a2 & 127) + 1, kLanes) - lo;
                        pk_own = (uint32_t)(lo + ph) | ((uint32_t)P << 8) | (recip[P] << 16);
                        dm_own = (uint32_t)(tile_off + row * kLanes + lo) | ((uint32_t)n << 18);
                    }
                }
                // Steps this warp runs: past the last live record of either half.
                const uint32_t livem = __ballot_sync(kFull, dm_own != 0);
                const int steps = max(32 - __clz(livem & ((1u << C::RPG) - 1)),
                                      32 - __clz(livem >> C::RPG));
                if (steps <= 1)
                    fire_records<C, 1, ABL>(tbl, dm_own, pk_own, S_own, base, lane, &rec_empty[st]);
                else if (steps <= 2)
                    fire_records<C, 2, ABL>(tbl, dm_own, pk_own, S_own, base, lane, &rec_empty[st]);
                else if (steps <= 3)
                    fire_records<C, 3, ABL>(tbl, dm_own, pk_own, S_own, base, lane, &rec_empty[st]);
                else if (steps <= 4)
                    fire_records<C, 4, ABL>(tbl, dm_own, pk_own, S_own, base, lane, &rec_empty[st]);
                else
                    fire_records<C, C::RPG, ABL>(tbl, dm_own, pk_own, S_own, base, lane, &rec_empty[st]);
                if (j == nft - 1) fence_async_smem();  // the tile leaves by a bulk store
                if (ABL != kNoBarrier) named_sync(1, C::FT);
            }
            if (tid == 0) mbar_arrive(&tile_done[s]);
            base += C::TILE_B;
            if (base >= C::NRB) base -= C::NRB;
            if (++s == C::NS) s = 0;
        }
    } else if (tid < C::FT + 32) {
        // ---- tile producer: literal images in, finished tiles out ----------
        if (lane != 0 || ntiles == 0) return;
        auto slot = [](int t) { return (t + C::W) % C::NS; };
        mbar_expect_tx(&lit_full[slot(0)], C::TILE_B);
        bulk_load(tbl + slot(0) * C::TILE_B, init, C::TILE_B, &lit_full[slot(0)]);
        for (int t = 0; t <= ntiles; ++t) {
            if (t >= 1) {
                const int sp = slot(t - 1);
                mbar_wait(&tile_done[sp], ((t - 1) / C::NS) & 1);
                bulk_store(out + (size_t)(t - 1) * C::TILE_B, tbl + sp * C::TILE_B, C::TILE_B);
                bulk_commit();
            }
            if (t + 1 < ntiles) {
                // The slot of t+1 last held tile t+1-NS, read by tile t-1's
                // fires (done: waited above) and by its store (at most the
                // newest store, of tile t-1, may still be reading).
                bulk_wait_read<1>();
                const int sn = slot(t + 1);
                mbar_expect_tx(&lit_full[sn], C::TILE_B);
                bulk_load(tbl + sn * C::TILE_B, init + (size_t)(t + 1) * C::TILE_B, C::TILE_B,
                          &lit_full[sn]);
            }
        }
        bulk_wait_all();
    } else {
        // ---- record producer: each fire's 3 x RB fields, kRecStages ahead ---
        if (lane != 0) return;
        int k = 0;
        for (int t = 0; t < ntiles; ++t) {
            const int nft = ABL == kNoFires ? 0 : min(nf_tot[t], nf);
            for (int j = 0; j < nft; ++j, ++k) {
                const int st = k % kRecStages;
                if (k >= kRecStages) mbar_wait(&rec_empty[st], (k / kRecStages - 1) & 1);
                mbar_expect_tx(&rec_full[st], 3 * kRB * 4);
                const size_t off = ((size_t)t * nf + j) * kRB;
                bulk_load(rec[st][0], f0 + off, kRB * 4, &rec_full[st]);
                bulk_load(rec[st][1], f1 + off, kRB * 4, &rec_full[st]);
                bulk_load(rec[st][2], f2 + off, kRB * 4, &rec_full[st]);
            }
        }
    }
}

// K1b's fold: acc[l] += byte * ((idx*131+7) & 0xFFFF) over the bytes idx <
// ntot of `out` whose idx % 128 == l, wrapping mod 2^32. `acc` starts at 0.
// Blocks and the grid stride are multiples of 8 chunks of 16 bytes, so each
// thread's chunks cover the same 16 lanes; the weights need idx mod 2^16
// only, so 32-bit indices suffice.
__global__ void __launch_bounds__(256)
ring_checksum_kernel(const uint4* __restrict__ out, long long nchunks, long long ntot,
                     uint32_t* __restrict__ acc)
{
    __shared__ uint32_t acc_s[kLanes];
    const int tid = threadIdx.x;
    if (tid < kLanes) acc_s[tid] = 0;
    __syncthreads();
    uint32_t part[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) part[b] = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long c = (long long)blockIdx.x * blockDim.x + tid; c < nchunks; c += stride) {
        const uint4 v = out[c];
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
        const uint32_t w0 = (uint32_t)c * 16u * 131u + 7u;
        if (16 * (c + 1) <= ntot) {
#pragma unroll
            for (int b = 0; b < 16; ++b)
                part[b] += ((w4[b >> 2] >> (8 * (b & 3))) & 0xFFu) * ((w0 + 131u * b) & 0xFFFFu);
        } else {
            const long long left = ntot - 16 * c;  // the last chunks only
#pragma unroll
            for (int b = 0; b < 16; ++b)
                if (b < left)
                    part[b] += ((w4[b >> 2] >> (8 * (b & 3))) & 0xFFu) * ((w0 + 131u * b) & 0xFFFFu);
        }
    }
#pragma unroll
    for (int b = 0; b < 16; ++b) atomicAdd(&acc_s[16 * (tid & 7) + b], part[b]);
    __syncthreads();
    if (tid < kLanes) atomicAdd(&acc[tid], acc_s[tid]);
}

// `nplans` plans of one (ntiles, nf) shape, back to back: one CTA each.
template <int TR, int FW, int ABL>
cudaError_t launch_ring_v2(const void* init, const void* f0, const void* f1, const void* f2,
                           const void* nf_tot, void* out, int ntiles, int nf, cudaStream_t stream,
                           int nplans = 1)
{
    using C = RingCfg<TR, FW>;
    cudaError_t err = cudaFuncSetAttribute(ring_decode_v2<TR, FW, ABL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::NRB);
    if (err != cudaSuccess) return err;
    ring_decode_v2<TR, FW, ABL><<<nplans, C::THREADS, C::NRB, stream>>>(
        static_cast<const uint8_t*>(init), static_cast<const int32_t*>(f0),
        static_cast<const int32_t*>(f1), static_cast<const int32_t*>(f2),
        static_cast<const int32_t*>(nf_tot), static_cast<uint8_t*>(out), ntiles, nf);
    return cudaGetLastError();
}

// Decode `nplans` plans of one (ntiles, nf) shape, back to back (K1a and K1b:
// one; K1c: several, one CTA each), with the second design and FW fire warps
// for a runtime tile height; with `acc` (one plan only), also fold the
// checksum lanes of out[0, ntot).
template <int FW, int ABL = kNoAblation>
cudaError_t launch_ring_v2_rows(int tile_rows, const void* init, const void* f0, const void* f1,
                                const void* f2, const void* nf_tot, void* out, int ntiles, int nf,
                                long long ntot, void* acc, cudaStream_t stream, int nplans = 1)
{
    if (acc != nullptr && nplans != 1) return cudaErrorInvalidValue;
    cudaError_t err;
    switch (tile_rows) {
        case 64: err = launch_ring_v2<64, FW, ABL>(init, f0, f1, f2, nf_tot, out, ntiles, nf, stream, nplans); break;
        case 128: err = launch_ring_v2<128, FW, ABL>(init, f0, f1, f2, nf_tot, out, ntiles, nf, stream, nplans); break;
        case 256: err = launch_ring_v2<256, FW, ABL>(init, f0, f1, f2, nf_tot, out, ntiles, nf, stream, nplans); break;
        case 512: err = launch_ring_v2<512, FW, ABL>(init, f0, f1, f2, nf_tot, out, ntiles, nf, stream, nplans); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || acc == nullptr) return err;
    err = cudaMemsetAsync(acc, 0, kLanes * sizeof(uint32_t), stream);
    if (err != cudaSuccess) return err;
    const long long nchunks = (long long)ntiles * tile_rows * kLanes / 16;
    const long long blocks = (nchunks + 255) / 256;
    ring_checksum_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
        static_cast<const uint4*>(out), nchunks, ntot, static_cast<uint32_t*>(acc));
    return cudaGetLastError();
}

}  // namespace tlz4
