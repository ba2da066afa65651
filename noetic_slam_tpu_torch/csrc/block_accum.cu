// Kernels B and C: block accumulation of a block-sorted sample stream into
// a (C, 512) payload, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of noetic_slam_tpu/ops/pallas/
// tsdf_kernel.py:
//   B  _accum_kernel   (launched by block_accumulate): the TSDF's two
//      channels (w, w*sdf), then the clamp-renormalise of the row;
//   C  _logodds_kernel (launched by logodds_accumulate): the occupancy
//      map's one channel (the log-odds delta), then clip(L + sum, l_min,
//      l_max); with l_min/l_max at -/+1e30 that is a pure sum (the
//      keyframe archive's signed de-fusion).
// After the block-major sort of one scan's samples (block_runs in
// noetic_slam_tpu_torch/models/tsdf.py), every touched block owns one
// contiguous range [start, start + cnt) of the stream, and all of those
// samples land in that block's 512-voxel payload row.
//
// Design: one template, on the channel count and the epilogue. One CTA per
// candidate entry; entries with cnt <= 0 return at once. 512 threads, one
// per voxel of the row. The block's samples are staged through shared
// memory in stream order, 512 at a time; each thread adds, in stream order,
// the samples whose ivox is its own voxel. Then each thread reads its
// voxel's payload once, adds, applies the epilogue and writes once. Rows
// are unique among real entries, so CTAs share no memory and need no
// ordering. Untouched rows are never read or written.
//
// The sums are deterministic run to run: no atomics, a fixed order per
// voxel. The keyframe archive's sign = -1 exact cancellation relies on that.
//
// What bounds them on the card: bytes. The stream (4 B of ivox plus 4 B per
// channel per sample: 12 B for B, 8 B for C) is read once, and each touched
// row (2 KB per channel) is read once and written once; the per-thread
// compare loop over each staged chunk stays on chip. The design reads each
// byte once, coalesced. What it does not balance is the work per CTA: one
// CTA walks all of its block's samples, so a block that holds thousands of
// samples (the occupancy map's blocks around the sensor, where every ray's
// first free-space samples land) sets the kernel's time, and a block with a
// few dozen samples still costs a 512-thread CTA and a whole row read and
// written: at one scan's shapes both kernels run far above their byte
// bound and behind a single index_add_ of the same stream (PERF.md). The
// TPU's 8-row group scratch and its padding-first ordering contract are
// not needed.

#include <cuda_runtime.h>

#define ACC_V 512
#define ACC_CHUNK 512

// B: new_w = min(W + sum_w, max_weight), sum_wd scaled by new_w / (W + sum_w);
// with no_clamp the pure sum.
struct TsdfEpilogue {
    float max_weight;
    int no_clamp;
    __device__ void operator()(size_t off, const float* acc, float* weight,
                               float* wsum) const {
        const float new_w = __fadd_rn(weight[off], acc[0]);
        const float new_wd = __fadd_rn(wsum[off], acc[1]);
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
};

// C: clip(L + sum_delta, l_min, l_max) (jnp.clip's max-then-min order).
struct LogoddsEpilogue {
    float l_min, l_max;
    __device__ void operator()(size_t off, const float* acc, float* logodds,
                               float*) const {
        logodds[off] = fminf(fmaxf(__fadd_rn(logodds[off], acc[0]), l_min),
                             l_max);
    }
};

template <int NCH, class Epilogue>
__global__ void __launch_bounds__(ACC_V)
block_accum_kernel(float* __restrict__ pay0, float* __restrict__ pay1,
                   int C, const int* __restrict__ rows,
                   const int* __restrict__ starts,
                   const int* __restrict__ cnts,
                   const int* __restrict__ ivox,
                   const float* __restrict__ ch0,
                   const float* __restrict__ ch1, int S, Epilogue epi) {
    __shared__ int s_iv[ACC_CHUNK];
    __shared__ float s_ch[NCH][ACC_CHUNK];

    const int b = blockIdx.x;
    const int row = rows[b];
    int start = starts[b];
    const int cnt = cnts[b];
    if (cnt <= 0 || row < 0 || row >= C) return;      // uniform per CTA
    start = start > 0 ? start : 0;
    int end = start + cnt;
    end = end < S ? end : S;

    const int v = threadIdx.x;
    float acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.f;
    for (int c0 = start; c0 < end; c0 += ACC_CHUNK) {
        const int s = c0 + v;
        if (s < end) {
            s_iv[v] = ivox[s];
            s_ch[0][v] = ch0[s];
            if constexpr (NCH > 1) s_ch[1][v] = ch1[s];
        }
        __syncthreads();
        const int n = (end - c0) < ACC_CHUNK ? (end - c0) : ACC_CHUNK;
        for (int k = 0; k < n; ++k) {
            if (s_iv[k] == v) {
#pragma unroll
                for (int c = 0; c < NCH; ++c)
                    acc[c] = __fadd_rn(acc[c], s_ch[c][k]);
            }
        }
        __syncthreads();
    }
    epi((size_t)row * ACC_V + v, acc, pay0, pay1);
}

extern "C" int nst_tsdf_accum_launch(void* weight, void* wsum, int C,
                                     const void* rows, const void* starts,
                                     const void* cnts, int A,
                                     const void* ivox, const void* w,
                                     const void* wd, int S, float max_weight,
                                     int no_clamp, void* stream) {
    if (A == 0) return 0;
    block_accum_kernel<2, TsdfEpilogue><<<A, ACC_V, 0, (cudaStream_t)stream>>>(
        (float*)weight, (float*)wsum, C, (const int*)rows,
        (const int*)starts, (const int*)cnts, (const int*)ivox,
        (const float*)w, (const float*)wd, S,
        TsdfEpilogue{max_weight, no_clamp});
    return (int)cudaGetLastError();
}

extern "C" int nst_logodds_accum_launch(void* logodds, int C,
                                        const void* rows, const void* starts,
                                        const void* cnts, int A,
                                        const void* ivox, const void* delta,
                                        int S, float l_min, float l_max,
                                        void* stream) {
    if (A == 0) return 0;
    block_accum_kernel<1, LogoddsEpilogue>
        <<<A, ACC_V, 0, (cudaStream_t)stream>>>(
            (float*)logodds, nullptr, C, (const int*)rows,
            (const int*)starts, (const int*)cnts, (const int*)ivox,
            (const float*)delta, nullptr, S, LogoddsEpilogue{l_min, l_max});
    return (int)cudaGetLastError();
}
