// Kernel D: GICP's Levenberg-Marquardt lambda search in one launch, for
// Hopper (sm_90a).
//
// D replaces no Pallas kernel: the JAX package's search is a
// lax.while_loop (noetic_slam_tpu/ops/gicp.py, inner_lm), which the port
// first ran as lm_max_iterations masked iterations of small PyTorch ops
// (a 6x6 solve, the SE(3) exponential, the error over every pair, eight
// selects), several hundred launches a search. The wrapper is
// noetic_slam_tpu_torch/ops/cuda/lm_kernel.py.
//
// The search's schedule does not depend on the data until the step that
// ends it: from lambda_0 (init_lambda_factor * max|diag H| when the
// incoming lambda is negative) and nu = 2, every reject sets
// lambda <- nu * lambda and nu <- 2 nu, so candidate k has
// lambda_k = lambda_0 * 2^(k(k+1)/2), each product exact in f32. Until the
// search ends x0, y0, H and b do not change. So all K candidates are
// solved and scored at once, and the sequential loop's result falls out of
// a scan over k:
//
//  1. Set-up, in every block: thread 0 takes the lambda schedule (the
//     loop's own products); thread k < K solves (H + lambda_k I) d_k = -b
//     by LU with partial pivoting, forms delta_k = exp(d_k) (the
//     small-angle quaternion of utils/geometry.so3_exp_quat, then
//     quat_to_mat) and xi_k = delta_k x0, all in shared memory.
//  2. Scoring: block g takes the 1,024 pairs g * 1024 + j * 256 + t
//     (thread t, j = 0..3), held in registers. For each candidate a
//     thread adds its four terms e^T M e, e = t - xi_k p, in j order; a
//     warp adds its lanes by an xor butterfly (offset 16 first); thread k
//     adds the eight warps' sums as a halving tree and writes
//     partials[g][k].
//  3. Epilogue, in the last block to finish (a __threadfence and an atomic
//     ticket, which it resets for the next launch): y_k is the sum of the
//     partials in block order, with no float atomics; then one thread runs
//     the masked loop's carry over k (rho, reject, convergence on a
//     reject, lambda on accept lambda_k * max(1/3, 1 - (2 rho - 1)^3); x
//     and y kept on a reject; dT the last delta evaluated) and writes
//     every output into one small buffer.
//
// The per-pair terms are rounded operation by operation (__fmul_rn,
// __fadd_rn: nothing is contracted into an FMA) in the order of
// lm_kernel.error_sums, which also sums in this kernel's order: the
// plain version's error at the kernel's x equals the kernel's y bitwise,
// and two launches agree bitwise.
//
// A device tally [KMAX + 1] counts the searches that ended at candidate k
// (slot KMAX: none ended in K); nothing on the timed path reads it.
//
// What bounds it: the pairs, ~60 B each (source point 12 B, target row
// 12 B, Mahalanobis weight 36 B): 8,192 of them are 0.49 MB, ~0.15 us at
// 3.35 TB/s, and ~25 operations a pair and candidate. At these sizes the
// real floor is one launch's latency plus the set-up's chain of dependent
// operations (a 6x6 solve, an exponential, a 4x4 product), and the design
// answers to that floor: one launch where the loop made hundreds.

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 16;                  // most candidates a launch takes
constexpr int THREADS = 256;              // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;                    // pairs a thread
constexpr int BLOCK_PAIRS = THREADS * PPT;
constexpr unsigned FULL = 0xffffffffu;

static_assert(KMAX <= THREADS, "a thread a candidate");
static_assert(WARPS == 8, "the warp tree below adds eight sums");

// output buffer (f32 words): x 0-15, lambda 16, dT 17-32, y 33, flags 34
// (bytes: accepted, converged, stop), the candidate that ended the
// search 35 (int32; K when none did)
constexpr int OUT_X = 0, OUT_LAM = 16, OUT_DT = 17, OUT_Y = 33,
              OUT_FLAGS = 34, OUT_K = 35;

struct Smem {
    float lam[KMAX];
    float d[KMAX][6];
    float delta[KMAX][16];
    float xi[KMAX][16];
    float warp_sum[WARPS][KMAX];
    float y[KMAX];
    int last;
};

// torch.max / torch.maximum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float fma_free3(float a0, float b0, float a1,
                                           float b1, float a2, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

// (H + lam I) d = -b by LU with partial pivoting (the first largest
// pivot), then the two triangular solves
__device__ void solve6(const float* __restrict__ H,
                       const float* __restrict__ b, float lam, float* d) {
    float A[6][6], r[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
            A[i][j] = __fadd_rn(H[i * 6 + j],
                                __fmul_rn(lam, i == j ? 1.f : 0.f));
        r[i] = -b[i];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        int p = c;
        float best = fabsf(A[c][c]);
#pragma unroll
        for (int i = c + 1; i < 6; ++i)
            if (fabsf(A[i][c]) > best) { best = fabsf(A[i][c]); p = i; }
#pragma unroll
        for (int i = c + 1; i < 6; ++i)
            if (i == p) {
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    const float s = A[c][j]; A[c][j] = A[i][j]; A[i][j] = s;
                }
                const float s = r[c]; r[c] = r[i]; r[i] = s;
            }
#pragma unroll
        for (int i = c + 1; i < 6; ++i) {
            const float l = __fdiv_rn(A[i][c], A[c][c]);
#pragma unroll
            for (int j = c + 1; j < 6; ++j)
                A[i][j] = __fsub_rn(A[i][j], __fmul_rn(l, A[c][j]));
            r[i] = __fsub_rn(r[i], __fmul_rn(l, r[c]));
        }
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
        float s = r[i];
#pragma unroll
        for (int j = i + 1; j < 6; ++j)
            s = __fsub_rn(s, __fmul_rn(A[i][j], d[j]));
        d[i] = __fdiv_rn(s, A[i][i]);
    }
}

// 6-vector -> SE(3) (4x4, row-major): rotation exp(d[0:3]) through the
// small-angle quaternion of utils/geometry.so3_exp_quat, translation d[3:6]
__device__ void delta_to_T(const float* d, float* T) {
    const float w0 = d[0], w1 = d[1], w2 = d[2];
    const float th2 = fma_free3(w0, w0, w1, w1, w2, w2);
    const float th4 = __fmul_rn(th2, th2);
    const bool small = th2 < 1e-10f;
    const float th = sqrtf(small ? 1.f : th2);
    const float half = __fmul_rn(0.5f, th);
    const float imag = small
        ? __fadd_rn(__fsub_rn(0.5f, __fdiv_rn(th2, 48.f)),
                    __fdiv_rn(th4, 3840.f))
        : __fdiv_rn(sinf(half), th);
    const float re = small
        ? __fadd_rn(__fsub_rn(1.f, __fdiv_rn(th2, 8.f)),
                    __fdiv_rn(th4, 384.f))
        : cosf(half);
    const float x = __fmul_rn(imag, w0), y = __fmul_rn(imag, w1),
                z = __fmul_rn(imag, w2);
    const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y),
                zz = __fmul_rn(z, z);
    const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z),
                yz = __fmul_rn(y, z);
    const float wx = __fmul_rn(re, x), wy = __fmul_rn(re, y),
                wz = __fmul_rn(re, z);
    T[0] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(yy, zz)));
    T[1] = __fmul_rn(2.f, __fsub_rn(xy, wz));
    T[2] = __fmul_rn(2.f, __fadd_rn(xz, wy));
    T[3] = d[3];
    T[4] = __fmul_rn(2.f, __fadd_rn(xy, wz));
    T[5] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, zz)));
    T[6] = __fmul_rn(2.f, __fsub_rn(yz, wx));
    T[7] = d[4];
    T[8] = __fmul_rn(2.f, __fsub_rn(xz, wy));
    T[9] = __fmul_rn(2.f, __fadd_rn(yz, wx));
    T[10] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, yy)));
    T[11] = d[5];
    T[12] = 0.f; T[13] = 0.f; T[14] = 0.f; T[15] = 1.f;
}

// ops/gicp's convergence test: max|R - I| / rot_eps and max|t| / trans_eps
// both below 1
__device__ bool is_converged(const float* T, float rot_eps,
                             float trans_eps) {
    float r = fabsf(__fsub_rn(T[0], 1.f));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            r = nan_max(r, fabsf(__fsub_rn(T[i * 4 + j], i == j ? 1.f : 0.f)));
    float t = fabsf(T[3]);
    t = nan_max(t, fabsf(T[7]));
    t = nan_max(t, fabsf(T[11]));
    return nan_max(__fdiv_rn(r, rot_eps), __fdiv_rn(t, trans_eps)) < 1.f;
}

// e^T M e, e = t - (R p + tr): lm_kernel.error_sums's order
__device__ __forceinline__ float pair_error(const float* X, float px,
                                            float py, float pz,
                                            const float* t, const float* M) {
    const float e0 = __fsub_rn(t[0], __fadd_rn(
        fma_free3(X[0], px, X[1], py, X[2], pz), X[3]));
    const float e1 = __fsub_rn(t[1], __fadd_rn(
        fma_free3(X[4], px, X[5], py, X[6], pz), X[7]));
    const float e2 = __fsub_rn(t[2], __fadd_rn(
        fma_free3(X[8], px, X[9], py, X[10], pz), X[11]));
    const float m0 = fma_free3(M[0], e0, M[1], e1, M[2], e2);
    const float m1 = fma_free3(M[3], e0, M[4], e1, M[5], e2);
    const float m2 = fma_free3(M[6], e0, M[7], e1, M[8], e2);
    return fma_free3(e0, m0, e1, m1, e2, m2);
}

__global__ void __launch_bounds__(THREADS)
lm_search_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ maha, int n,
                 const float* __restrict__ H, const float* __restrict__ b,
                 const float* __restrict__ y0, const float* __restrict__ x0,
                 const float* __restrict__ lam_in, int K, float init_factor,
                 float rot_eps, float trans_eps, float* partials,
                 unsigned int* ticket, int* tally, float* out) {
    __shared__ Smem s;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // 1. the candidates
    if (tid == 0) {
        float lam = lam_in[0];
        if (lam < 0.f) {
            float m = fabsf(H[0]);
#pragma unroll
            for (int i = 1; i < 6; ++i) m = nan_max(m, fabsf(H[i * 7]));
            lam = __fmul_rn(init_factor, m);
        }
        float nu = 2.f;
        for (int k = 0; k < K; ++k) {
            s.lam[k] = lam;
            lam = __fmul_rn(nu, lam);
            nu = __fmul_rn(2.f, nu);
        }
    }
    __syncthreads();
    if (tid < K) {
        float d[6], D[16];
        solve6(H, b, s.lam[tid], d);
        delta_to_T(d, D);
#pragma unroll
        for (int i = 0; i < 6; ++i) s.d[tid][i] = d[i];
#pragma unroll
        for (int i = 0; i < 16; ++i) s.delta[tid][i] = D[i];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                s.xi[tid][r * 4 + c] = __fadd_rn(
                    __fadd_rn(__fmul_rn(D[r * 4], x0[c]),
                              __fmul_rn(D[r * 4 + 1], x0[4 + c])),
                    __fadd_rn(__fmul_rn(D[r * 4 + 2], x0[8 + c]),
                              __fmul_rn(D[r * 4 + 3], x0[12 + c])));
    }
    __syncthreads();

    // 2. every candidate's error over this block's pairs: the thread's
    // pairs in registers (0 beyond n), then candidate by candidate its four
    // terms in j order, the warp's lanes, the block's warps
    float P[PPT][3], T[PPT][3], M[PPT][9];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int i = blockIdx.x * BLOCK_PAIRS + j * THREADS + tid;
        const bool in = i < n;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            P[j][c] = in ? src[3 * i + c] : 0.f;
            T[j][c] = in ? tgt[3 * i + c] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 9; ++c) M[j][c] = in ? maha[9 * i + c] : 0.f;
    }
    const int first = blockIdx.x * BLOCK_PAIRS + tid;
    for (int k = 0; k < K; ++k) {
        float X[12];
#pragma unroll
        for (int c = 0; c < 12; ++c) X[c] = s.xi[k][c];
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const float q = first + j * THREADS < n
                ? pair_error(X, P[j][0], P[j][1], P[j][2], T[j], M[j]) : 0.f;
            a = j == 0 ? q : __fadd_rn(a, q);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            a = __fadd_rn(a, __shfl_xor_sync(FULL, a, off));
        if (lane == 0) s.warp_sum[warp][k] = a;
    }
    __syncthreads();
    if (tid < K) {
        float v[WARPS];
#pragma unroll
        for (int i = 0; i < WARPS; ++i) v[i] = s.warp_sum[i][tid];
#pragma unroll
        for (int h = WARPS / 2; h > 0; h >>= 1)
#pragma unroll
            for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
        partials[blockIdx.x * KMAX + tid] = v[0];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
        s.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s.last) return;

    // 3. the last block: y_k in block order, then the loop's carry over k
    __threadfence();
    if (tid < K) {
        float y = __ldcg(partials + tid);
        for (int g = 1; g < (int)gridDim.x; ++g)
            y = __fadd_rn(y, __ldcg(partials + g * KMAX + tid));
        s.y[tid] = y;
    }
    __syncthreads();
    if (tid != 0) return;
    *ticket = 0u;
    const float Y0 = y0[0];
    float lam = K > 0 ? s.lam[0] : lam_in[0];
    if (K == 0 && lam < 0.f) {
        float m = fabsf(H[0]);
        for (int i = 1; i < 6; ++i) m = nan_max(m, fabsf(H[i * 7]));
        lam = __fmul_rn(init_factor, m);
    }
    float nu = 2.f;
    bool accepted = false, moved = false;
    int kend = K, klast = -1;
    for (int k = 0; k < K; ++k) {
        klast = k;
        const float* d = s.d[k];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i)
            dot = __fadd_rn(dot, __fmul_rn(d[i], __fsub_rn(
                __fmul_rn(lam, d[i]), b[i])));
        const float rho = __fdiv_rn(__fsub_rn(Y0, s.y[k]), dot);
        const bool reject = rho < 0.f;
        const bool conv = reject && is_converged(s.delta[k], rot_eps,
                                                 trans_eps);
        if (reject) {
            lam = __fmul_rn(nu, lam);
            nu = __fmul_rn(2.f, nu);
        } else {
            const float u = __fsub_rn(__fmul_rn(2.f, rho), 1.f);
            float f = __fsub_rn(1.f, __fmul_rn(__fmul_rn(u, u), u));
            f = f < 1.f / 3.f ? 1.f / 3.f : f;      // torch.clamp: NaN stays
            lam = __fmul_rn(lam, f);
            moved = true;
        }
        if (!reject || conv) {
            accepted = true;
            kend = k;
            break;
        }
    }
    const float* X = moved ? s.xi[kend] : x0;
    for (int i = 0; i < 16; ++i) out[OUT_X + i] = X[i];
    out[OUT_LAM] = lam;
    float dT[16];
    for (int i = 0; i < 16; ++i)
        dT[i] = klast >= 0 ? s.delta[klast][i] : (i % 5 == 0 ? 1.f : 0.f);
    for (int i = 0; i < 16; ++i) out[OUT_DT + i] = dT[i];
    out[OUT_Y] = moved ? s.y[kend] : Y0;
    const bool converged = accepted && is_converged(dT, rot_eps, trans_eps);
    unsigned char* flags = reinterpret_cast<unsigned char*>(out + OUT_FLAGS);
    flags[0] = accepted;
    flags[1] = converged;
    flags[2] = converged || !accepted;
    flags[3] = 0;
    reinterpret_cast<int*>(out)[OUT_K] = kend;
    atomicAdd(tally + (kend < K ? kend : KMAX), 1);
}

}  // namespace

extern "C" int nst_lm_search_kmax() { return KMAX; }
extern "C" int nst_lm_search_block_pairs() { return BLOCK_PAIRS; }

// src, tgt (n, 3), maha (n, 3, 3), H (6, 6), b (6), y0, x0 (4, 4), lam_in:
// f32 device pointers; 0 <= K <= KMAX. partials: at least
// max(1, ceil(n / BLOCK_PAIRS)) * KMAX f32; ticket: one uint32, 0 between
// launches (the kernel leaves it 0); tally: KMAX + 1 int32; out: 36 words.
extern "C" int nst_lm_search_launch(const void* src, const void* tgt,
                                    const void* maha, int n, const void* H,
                                    const void* b, const void* y0,
                                    const void* x0, const void* lam_in, int K,
                                    float init_factor, float rot_eps,
                                    float trans_eps, void* partials,
                                    void* ticket, void* tally, void* out,
                                    void* stream) {
    if (K < 0 || K > KMAX || n < 0) return (int)cudaErrorInvalidValue;
    const int blocks = n > 0 ? (n + BLOCK_PAIRS - 1) / BLOCK_PAIRS : 1;
    lm_search_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)src, (const float*)tgt, (const float*)maha, n,
        (const float*)H, (const float*)b, (const float*)y0,
        (const float*)x0, (const float*)lam_in, K, init_factor, rot_eps,
        trans_eps, (float*)partials, (unsigned int*)ticket, (int*)tally,
        (float*)out);
    return (int)cudaGetLastError();
}
