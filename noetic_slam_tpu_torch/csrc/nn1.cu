// Kernel A: exact 1-NN search with best-first visit lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel noetic_slam_tpu/ops/pallas/nn_kernel.py
// (_nn_kernel, launched by nn1_fused) and the plain XLA code around it that
// builds the visit lists. The wrapper is
// noetic_slam_tpu_torch/ops/cuda/nn_kernel.py. One call is two launches:
//
//  1. nn1_boxes_kernel: one warp per target tile of T_TILE rows takes the
//     axis-aligned box of the tile's rows that are below t_count and not
//     sentinels (|coordinate| < 1e5); a tile without such rows gets the
//     inverted box (+inf, -inf).
//  2. nn1_walk_kernel: one CTA of NW warps per group of GROUP queries (QPL
//     per lane; every warp of the CTA holds the same queries in registers).
//     a. List build: the CTA takes the group's box, the box-to-box squared
//        lower bound to every target tile in range, keeps the candidates
//        (bound < min(cap^2, 1e17), and some query of the group within
//        that cut of the tile's box) as 64-bit keys (bound bits, tile) in
//        shared memory and sorts them (bitonic). Keys are unique, so the
//        list does not depend on the order the candidates were appended.
//     b. Walk: warp w takes list entries w, w + NW, ... For each it reads
//        the group's merged bests from shared memory, stops if the entry's
//        bound is above the worst of them (sorted list: no later entry can
//        help), and otherwise lets each lane test its own query's
//        point-to-box squared distance against its own best; the tile is
//        skipped unless some lane needs it (__ballot_sync). For a needed
//        tile the lanes turn from queries to rows: the warp loads the
//        tile's rows into registers (T_TILE / 32 a lane, coalesced) and
//        takes the needing queries one at a time (broadcast by shuffle);
//        every lane takes the first minimum of its rows, two warp
//        reductions (smallest d^2, then smallest row among its holders)
//        give the tile's smallest packed key (bits of d^2, row index),
//        and the query's lane publishes an improvement with one 64-bit
//        atomicMin in shared memory. Only queries that need a tile pay
//        for it.
//     c. Epilogue: the exact squared distance at the winners from the
//        original coordinates; a query that found nothing strictly inside
//        the cap keeps idx 0 and cap^2.
//
// What bounds it on the card: by the count, f32 operations on CUDA cores
// (about 10 instructions a pair), not bytes: the live targets (3 MB) sit in
// L2. At 8192 queries the pairs that must be evaluated are microseconds of
// work, so what a call really takes is the chain of short dependent phases
// of one CTA (queries, box tests, sort, a few tiles), each a round trip to
// L2 or a barrier. The design therefore (a) prunes per query, in the list build and again in
// the walk, so that a not-found query (whose best stays at cap^2) no
// longer forces its whole group through every tile near the group's box,
// and a lane whose query does not need a tile does no work for it, (b)
// gives each group NW warps, so that the card is full at 8192 queries and
// the longest serial chain is a few tiles, and (c) needs no block-wide
// barrier during the walk and no shared-memory staging.
//
// Exactness and determinism. The point-to-box bound is computed with the
// same rounded operations as the distances (rounding is monotonic), so it
// is <= the computed d^2 of every row of the tile. A tile is skipped only
// if the bound is ABOVE the query's current best, so the tile that holds
// the smallest packed key (smallest d^2, then smallest row index) is never
// skipped, whatever the other warps have published so far; every other
// tile only contributes larger keys. The result is that smallest key:
// independent of the visiting order, bitwise equal run to run, and equal
// to the plain version's first minimum. Distances are plain f32
// differences, never on tensor cores, summed with __fmul_rn/__fadd_rn so
// that nothing is contracted into FMAs: kernel, plain version and the
// recomputation give bitwise the same d^2, and d^2 < cap^2 decides found
// or not found identically in all three.
//
// Contract (kept from the Pallas kernel):
//  - best starts at cap^2 (inf when uncapped) and index 0: a query with no
//    target strictly inside the cap returns idx 0 and d = cap^2;
//  - rows at or beyond t_count (and beyond nt) are never read, and a
//    sentinel row below it is never returned;
//  - ragged edges (nq, nt not multiples of anything) are masked here.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// the kernel's shape; scripts/torch_nn1_sweep.py builds patched copies
constexpr int T_TILE = 128;     // target rows per tile
constexpr int NW = 16;          // warps per CTA (per query group)
constexpr int QPL = 1;          // queries per lane
constexpr int BY_BOUND = 1;     // lists ordered by bound (1) or by tile (0)

constexpr int GROUP = 32 * QPL;         // queries per CTA
constexpr int RPL = T_TILE / 32;        // a tile's rows per lane
constexpr float OK_ABS = 1e5f;          // sentinel rows lie at or beyond
constexpr float FAR2 = 1e17f;           // bounds at or beyond: no candidate
constexpr int MAX_SMEM = 226 * 1024;    // dynamic shared memory of a CTA
                                        // (227 KB less the static arrays)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;

static_assert(T_TILE % 32 == 0 && T_TILE >= 32 && T_TILE <= 512,
              "tile rows: a multiple of 32");
static_assert(NW >= 1 && NW <= 32, "1 to 32 warps a CTA");
static_assert(QPL >= 1 && QPL <= 4, "1 to 4 queries a lane");

typedef unsigned long long u64;

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// squared distance from a point to a box (0 inside; inf to an inverted box)
__device__ __forceinline__ float box3(float x, float y, float z,
                                      const float* lo, const float* hi) {
    return sq3(fmaxf(fmaxf(lo[0] - x, x - hi[0]), 0.f),
               fmaxf(fmaxf(lo[1] - y, y - hi[1]), 0.f),
               fmaxf(fmaxf(lo[2] - z, z - hi[2]), 0.f));
}

__device__ __forceinline__ int row_limit(const int* t_count, int t_count_host,
                                         int nt) {
    int limit = t_count ? *t_count : t_count_host;
    limit = limit < nt ? limit : nt;
    return limit > 0 ? limit : 0;
}

__device__ __forceinline__ void warp_box(float* lo, float* hi) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
        for (int off = 16; off > 0; off >>= 1) {
            lo[c] = fminf(lo[c], __shfl_xor_sync(FULL, lo[c], off));
            hi[c] = fmaxf(hi[c], __shfl_xor_sync(FULL, hi[c], off));
        }
}

__device__ __forceinline__ void grow_box(float* lo, float* hi, float x,
                                         float y, float z) {
    if (fabsf(x) < OK_ABS && fabsf(y) < OK_ABS && fabsf(z) < OK_ABS) {
        lo[0] = fminf(lo[0], x); hi[0] = fmaxf(hi[0], x);
        lo[1] = fminf(lo[1], y); hi[1] = fmaxf(hi[1], y);
        lo[2] = fminf(lo[2], z); hi[2] = fmaxf(hi[2], z);
    }
}

// tbox (ntt, 6): min xyz, max xyz of each target tile's live rows
__global__ void nn1_boxes_kernel(const float* __restrict__ t, int nt,
                                 const int* __restrict__ t_count,
                                 int t_count_host, float* __restrict__ tbox,
                                 int ntt) {
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (tile >= ntt) return;                 // whole warps leave together
    const int limit = row_limit(t_count, t_count_host, nt);
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    const int r0 = tile * T_TILE;
    for (int k = lane; k < T_TILE; k += 32) {
        const int r = r0 + k;
        if (r < limit)
            grow_box(lo, hi, t[3 * (size_t)r], t[3 * (size_t)r + 1],
                     t[3 * (size_t)r + 2]);
    }
    warp_box(lo, hi);
    if (lane == 0) {
        float* b = tbox + 6 * (size_t)tile;
        b[0] = lo[0]; b[1] = lo[1]; b[2] = lo[2];
        b[3] = hi[0]; b[4] = hi[1]; b[5] = hi[2];
    }
}

__global__ void __launch_bounds__(NW * 32)
nn1_walk_kernel(const float* __restrict__ q, int nq,
                const float* __restrict__ t, int nt,
                const int* __restrict__ t_count, int t_count_host,
                const float* __restrict__ max_dist, float cap2_host,
                const float* __restrict__ tbox, int ntt,
                int* __restrict__ out_idx, float* __restrict__ out_d) {
    extern __shared__ u64 keys[];    // dynamic: the list's keys
    __shared__ u64 best[GROUP];      // merged (bits of d^2, row) per query
    __shared__ float gbox[6];        // the group's box
    __shared__ float gq[3 * GROUP];  // the group's queries (+inf: no query)
    __shared__ int ncand_s;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int limit = row_limit(t_count, t_count_host, nt);
    float cap2 = cap2_host;
    if (max_dist) {
        const float md = *max_dist;
        cap2 = __fmul_rn(md, md);
    }
    const u64 none = (u64)__float_as_uint(cap2) << 32;     // (cap^2, row 0)

    float qx[QPL], qy[QPL], qz[QPL];
    bool has[QPL];
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
        const int qi = blockIdx.x * GROUP + j * 32 + lane;
        has[j] = qi < nq;
        qx[j] = has[j] ? q[3 * (size_t)qi] : 0.f;
        qy[j] = has[j] ? q[3 * (size_t)qi + 1] : 0.f;
        qz[j] = has[j] ? q[3 * (size_t)qi + 2] : 0.f;
    }

    if (warp == 0) {
        float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
        float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
            if (has[j]) grow_box(lo, hi, qx[j], qy[j], qz[j]);
            best[j * 32 + lane] = none;
            gq[3 * (j * 32 + lane)] = has[j] ? qx[j] : CUDART_INF_F;
            gq[3 * (j * 32 + lane) + 1] = has[j] ? qy[j] : CUDART_INF_F;
            gq[3 * (j * 32 + lane) + 2] = has[j] ? qz[j] : CUDART_INF_F;
        }
        warp_box(lo, hi);
        if (lane == 0) {
            gbox[0] = lo[0]; gbox[1] = lo[1]; gbox[2] = lo[2];
            gbox[3] = hi[0]; gbox[4] = hi[1]; gbox[5] = hi[2];
            ncand_s = 0;
        }
    }
    __syncthreads();

    // ---- list build: candidates of this group, as sortable keys
    {
        int n_in = (limit + T_TILE - 1) / T_TILE;
        n_in = n_in < ntt ? n_in : ntt;
        const float cut = fminf(cap2, FAR2);
        for (int tile = tid; tile < n_in; tile += NW * 32) {
            const float* b = tbox + 6 * (size_t)tile;
            const float lo[3] = {b[0], b[1], b[2]}, hi[3] = {b[3], b[4], b[5]};
            const float lb2 = sq3(
                fmaxf(fmaxf(lo[0] - gbox[3], gbox[0] - hi[0]), 0.f),
                fmaxf(fmaxf(lo[1] - gbox[4], gbox[1] - hi[1]), 0.f),
                fmaxf(fmaxf(lo[2] - gbox[5], gbox[2] - hi[2]), 0.f));
            // box to box first, then per query: some query of the group
            // must come within the cut of the tile's box
            bool any = false;
            if (lb2 < cut)
                for (int k = 0; k < GROUP && !any; ++k)
                    any = box3(gq[3 * k], gq[3 * k + 1], gq[3 * k + 2], lo,
                               hi) < cut;
            if (any) {
                const u64 lbk = __float_as_uint(lb2);
                keys[atomicAdd(&ncand_s, 1)] =
                    BY_BOUND ? (lbk << 32) | (u64)tile
                             : ((u64)tile << 32) | lbk;
            }
        }
    }
    __syncthreads();
    const int ncand = ncand_s;
    if (ncand > 1) {
        int npow = 2;
        while (npow < ncand) npow <<= 1;
        for (int i = ncand + tid; i < npow; i += NW * 32) keys[i] = ~0ull;
        __syncthreads();
        for (int k = 2; k <= npow; k <<= 1)
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = tid; i < npow; i += NW * 32) {
                    const int p = i ^ j;
                    if (p > i) {
                        const u64 a = keys[i], b = keys[p];
                        if ((a > b) == ((i & k) == 0)) {
                            keys[i] = b;
                            keys[p] = a;
                        }
                    }
                }
                __syncthreads();
            }
    }

    // ---- walk: this warp's share of the list, no block-wide barrier
    const volatile u64* vbest = best;
    for (int i = warp; i < ncand; i += NW) {
        const u64 key = keys[i];
        const int tile = (int)(BY_BOUND ? key & 0xffffffffu : key >> 32);
        u64 mine[QPL];                  // each query's merged best so far
        unsigned w = 0;
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
            mine[j] = vbest[j * 32 + lane];
            const unsigned bd = (unsigned)(mine[j] >> 32);
            if (has[j]) w = w > bd ? w : bd;
        }
        // non-negative floats order as their bits
        if (BY_BOUND && (unsigned)(key >> 32) > __reduce_max_sync(FULL, w))
            break;
        const float* b = tbox + 6 * (size_t)tile;
        const float lo[3] = {b[0], b[1], b[2]}, hi[3] = {b[3], b[4], b[5]};
        unsigned need[QPL];             // the lanes whose query needs the tile
        unsigned any = 0;
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
            need[j] = __ballot_sync(
                FULL, has[j] && box3(qx[j], qy[j], qz[j], lo, hi)
                                    <= __uint_as_float((unsigned)(mine[j] >> 32)));
            any |= need[j];
        }
        if (!any) continue;

        // the tile's rows in registers, row lane + 32 k in step k; rows past
        // the end, and sentinel rows (the boxes leave them out, so whether
        // their tile is scanned depends on the other queries), get x = +inf:
        // their d^2 is inf and never wins
        const int t0 = tile * T_TILE;
        float tx[RPL], ty[RPL], tz[RPL];
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
            const int r = t0 + lane + 32 * k;
            float x = CUDART_INF_F, y = 0.f, z = 0.f;
            if (r < limit) {
                x = t[3 * (size_t)r];
                y = t[3 * (size_t)r + 1];
                z = t[3 * (size_t)r + 2];
                if (!(fabsf(x) < OK_ABS && fabsf(y) < OK_ABS
                      && fabsf(z) < OK_ABS))
                    x = CUDART_INF_F;
            }
            tx[k] = x; ty[k] = y; tz[k] = z;
        }

        // one needing query at a time against all the rows: every lane takes
        // its rows' first minimum, two warp reductions give the smallest
        // (d^2, row) of the tile
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
            bool improved = false;
            for (unsigned m = need[j]; m; m &= m - 1) {
                const int src = __ffs(m) - 1;
                const float x = __shfl_sync(FULL, qx[j], src);
                const float y = __shfl_sync(FULL, qy[j], src);
                const float z = __shfl_sync(FULL, qz[j], src);
                const unsigned bd =
                    __shfl_sync(FULL, (unsigned)(mine[j] >> 32), src);
                float md = CUDART_INF_F;
                int mk = 0;
#pragma unroll
                for (int k = 0; k < RPL; ++k) {
                    const float d = sq3(x - tx[k], y - ty[k], z - tz[k]);
                    if (d < md) { md = d; mk = k; }
                }
                const unsigned mb = __float_as_uint(md);
                const unsigned dmin = __reduce_min_sync(FULL, mb);
                // an equal d^2 at a smaller row index wins: <= here, the
                // packed comparison below decides
                if (dmin <= bd && dmin < INF_BITS) {
                    const unsigned row = __reduce_min_sync(
                        FULL, mb == dmin ? (unsigned)(t0 + lane + 32 * mk)
                                         : 0xffffffffu);
                    const u64 found = ((u64)dmin << 32) | row;
                    if (lane == src && found < mine[j]) {
                        mine[j] = found;
                        improved = true;
                    }
                }
            }
            if (improved) atomicMin(&best[j * 32 + lane], mine[j]);
        }
    }
    __syncthreads();

    // ---- epilogue: exact d^2 at the winners, cap^2 where nothing was found
    if (warp == 0) {
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
            if (!has[j]) continue;
            const int qi = blockIdx.x * GROUP + j * 32 + lane;
            const u64 key = best[j * 32 + lane];
            const int idx = (int)(key & 0xffffffffu);
            float d = __uint_as_float((unsigned)(key >> 32));
            const bool missed = cap2 < CUDART_INF_F && d >= cap2;
            if (!missed && idx < nt)
                d = sq3(qx[j] - t[3 * (size_t)idx],
                        qy[j] - t[3 * (size_t)idx + 1],
                        qz[j] - t[3 * (size_t)idx + 2]);
            out_idx[qi] = idx;
            out_d[qi] = d;
        }
    }
}

size_t walk_smem(int ntt) {
    size_t npad = 2;
    while (npad < (size_t)ntt) npad <<= 1;
    return sizeof(u64) * npad;
}

}  // namespace

extern "C" int nst_nn1_tile() { return T_TILE; }
extern "C" int nst_nn1_group() { return GROUP; }
extern "C" int nst_nn1_warps() { return NW; }

// the most target rows a call takes (the list's keys must fit in a CTA's
// shared memory)
extern "C" int nst_nn1_max_rows() {
    int ntt = 2;
    while (walk_smem(2 * ntt) <= (size_t)MAX_SMEM) ntt *= 2;
    return ntt * T_TILE;
}

// tbox: (ceil(nt / T_TILE), 6) f32. t_count: device int32 or null (then
// t_count_host counts).
extern "C" int nst_nn1_boxes_launch(const void* t, int nt, const void* t_count,
                                    int t_count_host, void* tbox,
                                    void* stream) {
    const int ntt = (nt + T_TILE - 1) / T_TILE;
    if (ntt == 0) return 0;
    nn1_boxes_kernel<<<(ntt + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        (const float*)t, nt, (const int*)t_count, t_count_host, (float*)tbox,
        ntt);
    return (int)cudaGetLastError();
}

// max_dist: device f32 or null (then cap2_host = cap^2 counts, inf when
// uncapped).
extern "C" int nst_nn1_walk_launch(const void* q, int nq, const void* t,
                                   int nt, const void* t_count,
                                   int t_count_host, const void* max_dist,
                                   float cap2_host, const void* tbox,
                                   void* out_idx, void* out_d, void* stream) {
    static size_t smem_allowed = 48 * 1024;
    if (nq == 0) return 0;
    const int ntt = (nt + T_TILE - 1) / T_TILE;
    const size_t smem = walk_smem(ntt);
    if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(
            nn1_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_allowed = MAX_SMEM;
    }
    nn1_walk_kernel<<<(nq + GROUP - 1) / GROUP, NW * 32, smem,
                      (cudaStream_t)stream>>>(
        (const float*)q, nq, (const float*)t, nt, (const int*)t_count,
        t_count_host, (const float*)max_dist, cap2_host, (const float*)tbox,
        ntt, (int*)out_idx, (float*)out_d);
    return (int)cudaGetLastError();
}
