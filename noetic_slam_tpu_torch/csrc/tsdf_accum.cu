// Kernel B: TSDF block accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel noetic_slam_tpu/ops/pallas/tsdf_kernel.py
// (_accum_kernel, launched by block_accumulate). After the block-major sort
// of one scan's ray samples (noetic_slam_tpu_torch/models/tsdf.py), every
// touched block owns one contiguous range [start, start + cnt) of the
// sample stream (ivox, w, w*sdf), and all of those samples land in that
// block's 512-voxel payload row.
//
// Design: one CTA per candidate entry; entries with cnt <= 0 return at
// once. 512 threads, one per voxel of the row. The block's samples are
// staged through shared memory in stream order, 512 at a time; each thread
// adds, in stream order, the samples whose ivox is its own voxel. Then each
// thread reads its voxel's (W, Σwd) once, adds, applies the clamp
// (new_w = min(W + ΣW, max_weight), Σwd scaled by new_w / (W + ΣW)) or, with
// no_clamp, the pure sum, and writes once. Rows are unique among real
// entries, so CTAs share no memory and need no ordering.
//
// The sums are deterministic run to run: no atomics, a fixed order per
// voxel. The keyframe archive's sign = -1 exact cancellation relies on that.
//
// What bounds it on the card: bytes - the sample stream (12 B per sample)
// and the touched rows (2 x 2 KB read + written per block); the per-thread
// compare loop over each staged chunk is on-chip work. The TPU's 8-row
// group scratch and its padding-first ordering contract are not needed.

#include <cuda_runtime.h>

#define TSDF_V 512
#define TSDF_CHUNK 512

__global__ void __launch_bounds__(TSDF_V)
tsdf_accum_kernel(float* __restrict__ weight, float* __restrict__ wsum,
                  int C, const int* __restrict__ rows,
                  const int* __restrict__ starts,
                  const int* __restrict__ cnts,
                  const int* __restrict__ ivox,
                  const float* __restrict__ w,
                  const float* __restrict__ wd, int S, float max_weight,
                  int no_clamp) {
    __shared__ int s_iv[TSDF_CHUNK];
    __shared__ float s_w[TSDF_CHUNK];
    __shared__ float s_wd[TSDF_CHUNK];

    const int b = blockIdx.x;
    const int row = rows[b];
    int start = starts[b];
    const int cnt = cnts[b];
    if (cnt <= 0 || row < 0 || row >= C) return;      // uniform per CTA
    start = start > 0 ? start : 0;
    int end = start + cnt;
    end = end < S ? end : S;

    const int v = threadIdx.x;
    float acc_w = 0.f, acc_wd = 0.f;
    for (int c0 = start; c0 < end; c0 += TSDF_CHUNK) {
        const int s = c0 + v;
        if (s < end) {
            s_iv[v] = ivox[s];
            s_w[v] = w[s];
            s_wd[v] = wd[s];
        }
        __syncthreads();
        const int n = (end - c0) < TSDF_CHUNK ? (end - c0) : TSDF_CHUNK;
        for (int k = 0; k < n; ++k) {
            if (s_iv[k] == v) {
                acc_w = __fadd_rn(acc_w, s_w[k]);
                acc_wd = __fadd_rn(acc_wd, s_wd[k]);
            }
        }
        __syncthreads();
    }

    const size_t off = (size_t)row * TSDF_V + v;
    const float new_w = __fadd_rn(weight[off], acc_w);
    const float new_wd = __fadd_rn(wsum[off], acc_wd);
    if (no_clamp) {
        weight[off] = new_w;
        wsum[off] = new_wd;
    } else {
        const float clamped = fminf(new_w, max_weight);
        const float scale = __fdiv_rn(clamped, fmaxf(new_w, 1e-12f));
        weight[off] = clamped;
        wsum[off] = __fmul_rn(new_wd, scale);
    }
}

extern "C" int nst_tsdf_accum_launch(void* weight, void* wsum, int C,
                                     const void* rows, const void* starts,
                                     const void* cnts, int A,
                                     const void* ivox, const void* w,
                                     const void* wd, int S, float max_weight,
                                     int no_clamp, void* stream) {
    if (A == 0) return 0;
    tsdf_accum_kernel<<<A, TSDF_V, 0, (cudaStream_t)stream>>>(
        (float*)weight, (float*)wsum, C, (const int*)rows,
        (const int*)starts, (const int*)cnts, (const int*)ivox,
        (const float*)w, (const float*)wd, S, max_weight, no_clamp);
    return (int)cudaGetLastError();
}
