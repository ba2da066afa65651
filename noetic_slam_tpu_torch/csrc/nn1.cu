// Kernel A: exact 1-NN search with best-first visit lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel noetic_slam_tpu/ops/pallas/nn_kernel.py
// (_nn_kernel, launched by nn1_fused). The wrapper
// (noetic_slam_tpu_torch/ops/cuda/nn_kernel.py) builds, in plain torch,
// per-query-tile visit lists: the target tiles sorted by the lower bound
// of the box-to-box squared distance, with their bounds. This kernel walks
// them.
//
// Design: one CTA per query tile, one thread per query. Each visited target
// tile (NN_T_TILE rows of the target cloud) is staged through shared memory
// as three float arrays; every thread then reads the same row at the same
// time (a shared-memory broadcast) and keeps a running (min d^2, argmin).
// After each tile a block reduction gives the tile's worst current best;
// the walk stops at the first list entry whose lower bound is not below it
// (the bound holds for every pair in the two boxes, so the result stays
// exact).
//
// What bounds it on the card: compares and multiply-adds (about 9 flops per
// pair in the visited tiles) - it reads each visited tile once per query
// tile, and the visit lists keep the pairs near the correspondence radius.
// Distances are plain f32 differences, never on tensor cores. The sum of
// squares is written with __fmul_rn/__fadd_rn so it is not contracted into
// FMAs: the wrapper's exact recomputation at the winners, and the plain
// version, then give bitwise the same d^2.
//
// Contract (kept from the Pallas kernel):
//  - best starts at cap2 (inf when uncapped) and index 0: a query with no
//    target strictly inside the cap returns idx 0 and d = cap2;
//  - rows at or beyond t_count (and beyond nt) are never read;
//  - ragged edges (nq not a multiple of the tile) are masked here.

#include <cuda_runtime.h>
#include <math_constants.h>

#define NN_T_TILE 256

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

__global__ void nn1_kernel(const float* __restrict__ q, int nq,
                           const float* __restrict__ t, int nt,
                           const int* __restrict__ t_count,
                           const float* __restrict__ cap2_ptr,
                           const int* __restrict__ vlist,
                           const float* __restrict__ vlb,
                           const int* __restrict__ vcnt, int ntt,
                           int* __restrict__ out_idx,
                           float* __restrict__ out_d) {
    __shared__ float sx[NN_T_TILE];
    __shared__ float sy[NN_T_TILE];
    __shared__ float sz[NN_T_TILE];
    __shared__ float warp_max[32];
    __shared__ float worst_s;

    const int tile_q = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    const int qi = tile_q * blockDim.x + tid;
    const bool has_q = qi < nq;

    const float cap2 = *cap2_ptr;
    int limit = *t_count;
    limit = limit < nt ? limit : nt;
    limit = limit > 0 ? limit : 0;

    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (has_q) {
        qx = q[3 * qi];
        qy = q[3 * qi + 1];
        qz = q[3 * qi + 2];
    }
    float best = cap2;
    int best_i = 0;
    float worst = cap2;

    const int n_visit = vcnt[tile_q];
    const int* list = vlist + (size_t)tile_q * ntt;
    const float* lbs = vlb + (size_t)tile_q * ntt;

    for (int i = 0; i < n_visit; ++i) {
        // every thread reads the same bound and the same shared worst:
        // the exit is uniform across the block
        if (!(lbs[i] < worst)) break;
        const int t0 = list[i] * NN_T_TILE;
        int n_here = limit - t0;
        n_here = n_here < NN_T_TILE ? n_here : NN_T_TILE;
        for (int k = tid; k < n_here; k += blockDim.x) {
            const int r = t0 + k;
            sx[k] = t[3 * r];
            sy[k] = t[3 * r + 1];
            sz[k] = t[3 * r + 2];
        }
        __syncthreads();
        if (has_q) {
            for (int k = 0; k < n_here; ++k) {
                const float d = sq3(qx - sx[k], qy - sy[k], qz - sz[k]);
                if (d < best) {
                    best = d;
                    best_i = t0 + k;
                }
            }
        }
        // worst current best over the tile's real queries
        float v = has_q ? best : -CUDART_INF_F;
        for (int off = 16; off > 0; off >>= 1)
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == 0) warp_max[warp] = v;
        __syncthreads();
        if (tid == 0) {
            float m = warp_max[0];
            for (int w = 1; w < nwarps; ++w) m = fmaxf(m, warp_max[w]);
            worst_s = m;
        }
        __syncthreads();
        worst = worst_s;
    }
    if (has_q) {
        out_idx[qi] = best_i;
        out_d[qi] = best;
    }
}

extern "C" int nst_nn1_launch(const void* q, int nq, const void* t, int nt,
                              const void* t_count, const void* cap2,
                              const void* vlist, const void* vlb,
                              const void* vcnt, int ntt, int q_tile,
                              int t_tile, void* out_idx, void* out_d,
                              void* stream) {
    if (t_tile != NN_T_TILE || q_tile <= 0 || q_tile > 1024 || q_tile % 32)
        return (int)cudaErrorInvalidValue;
    const int nqt = (nq + q_tile - 1) / q_tile;
    if (nqt == 0) return 0;
    nn1_kernel<<<nqt, q_tile, 0, (cudaStream_t)stream>>>(
        (const float*)q, nq, (const float*)t, nt, (const int*)t_count,
        (const float*)cap2, (const int*)vlist, (const float*)vlb,
        (const int*)vcnt, ntt, (int*)out_idx, (float*)out_d);
    return (int)cudaGetLastError();
}
