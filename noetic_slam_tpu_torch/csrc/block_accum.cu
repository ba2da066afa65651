// Kernels B and C: block accumulation of a block-sorted sample stream into
// a (C, 512) payload, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of noetic_slam_tpu/ops/pallas/
// tsdf_kernel.py:
//   B  _accum_kernel   (launched by block_accumulate): the TSDF's two
//      channels (w, w*sdf), then the clamp-renormalise;
//   C  _logodds_kernel (launched by logodds_accumulate): the occupancy
//      map's one channel (the log-odds delta), then clip(L + sum, l_min,
//      l_max); with l_min/l_max at -/+1e30 that is a pure sum (the
//      keyframe archive's signed de-fusion).
// After the block-major sort of one scan's samples (block_runs in
// noetic_slam_tpu_torch/models/tsdf.py), every touched block owns one
// contiguous range [start, start + cnt) of the stream, and all of those
// samples land in that block's 512-voxel payload row.
//
// What bounds it on the card: not bytes and not operations (one scan moves
// ~2 MB and adds ~0.3 M floats, under a microsecond of either), but latency
// and balance. A scan's 4,096 entries hold ~30 samples and ~16 hit voxels
// on average, while the few blocks around the sensor hold ~4,000 samples
// each. Merging a 32-sample tile in a warp is a chain of shuffle and
// shared-memory round trips, so the time is set by the longest chain of
// tiles one warp walks, and by the dependent global round trips around it
// (entry, stream, payload). The TPU kernel contracts a one-hot (512 x 512)
// matrix per 512-sample chunk on the MXU and writes whole 8-row groups; on
// Hopper that is wasted work, and the first port (one 512-thread CTA per
// entry, each thread scanning every sample for its own voxel, whole rows
// read and written) lost to one index_add_ by ~9x.
//
// Design: one template, on the channel count and the epilogue. A CTA of NW
// warps takes NW entries, strided over the entry array, so that the long
// entries, which sit next to each other in block order, land in different
// CTAs. Entries with cnt <= 0 are skipped.
// - Balanced serial work: an entry of at most SHORT samples is its own
//   warp's work, walked first. A longer one is cut into min(NW, ceil(cnt /
//   PART)) equal parts, rounded up to whole tiles (a function of cnt
//   alone), walked side by side by that many warps of the CTA; the CTA
//   packs its long entries into rounds of NW warps in entry order. A warp
//   walks its samples in 32-sample tiles with coalesced loads, NB tiles a
//   batch, the next batch's loads issued before the current one is merged.
//   No thread reads a sample that is not its own; the longest chain is
//   max(SHORT / 32, ceil(cnt / (32 * NW))) tiles.
// - Same-voxel samples merged in the warp: within a tile, lanes holding the
//   same voxel are grouped with __match_any_sync and summed by a fixed
//   shuffle tree over the group (pointer jumping along the group's lanes in
//   ascending order: pairs, then pairs of pairs, ...). The group's lowest
//   lane adds the sum into the warp's accumulator in shared memory.
// - Only hit voxels touch device memory: beside its accumulator each warp
//   keeps a 512-bit hit mask (the first touch of a voxel stores, later ones
//   add), so nothing is zeroed per entry but the 16 mask words, and a list
//   of the voxels it hit. A short entry's epilogue goes over the list. A
//   long entry's threads stride over the 512 voxels and merge its parts'
//   partials in part order. Each hit voxel has one owner thread, which
//   reads the payload once, applies the epilogue and writes once. Voxels
//   of a touched row that no sample hits are neither read nor written, and
//   neither are untouched rows.
// The sums are a function of the stream alone (fixed cut, fixed tree in the
// tile, stream order in the warp, part order across warps; the atomics are
// ORs of bits, whose results do not depend on order), so two runs agree
// bitwise, and a stream fused with sign +1 and then -1 from a zero payload
// returns exactly 0 (every rounding of the negated stream is the negation
// of the original's). Rows are unique among real entries, so CTAs share no
// payload and need no ordering. The grid is sized from A alone: no device
// value is read to size a launch.

#include <cuda_runtime.h>

#define ACC_V 512                 // voxels per block: one payload row
#define ACC_WORDS (ACC_V / 32)    // 32-bit words of a hit mask
#define FULL_MASK 0xffffffffu

// The shape, chosen by scripts/torch_block_accum_sweep.py (PERF.md: 16
// warps ahead of 8 and 32; 4-tile batches ahead of 2 cold; the single-warp
// limit makes no difference between 384 and 512).
constexpr int NW = 16;            // warps per CTA: entries per CTA, and the
                                  // most parts one entry is cut into
constexpr int NB = 4;             // 32-sample tiles a warp loads at once
constexpr int SHORT = 384;        // samples one warp takes alone
constexpr int PART = 32 * NB;     // a long entry: ceil(cnt / PART) parts
constexpr int EPI_K = 4;          // voxels a lane updates at once, epilogue
static_assert(NW >= 2 && NW <= 32, "2 to 32 warps per CTA");

// B: new_w = min(W + sum_w, max_weight), wsum + sum_wd scaled by
// new_w / (W + sum_w); with no_clamp the pure sum. p: the voxel's payload
// (in, out), a: its sums.
struct TsdfEpilogue {
    float max_weight;
    int no_clamp;
    __device__ void operator()(float (&p)[2], const float (&a)[2]) const {
        const float new_w = __fadd_rn(p[0], a[0]);
        const float new_wd = __fadd_rn(p[1], a[1]);
        if (no_clamp) {
            p[0] = new_w;
            p[1] = new_wd;
        } else {
            const float clamped = fminf(new_w, max_weight);
            const float scale = __fdiv_rn(clamped, fmaxf(new_w, 1e-12f));
            p[0] = clamped;
            p[1] = __fmul_rn(new_wd, scale);
        }
    }
};

// C: clip(L + sum_delta, l_min, l_max) (jnp.clip's max-then-min order).
struct LogoddsEpilogue {
    float l_min, l_max;
    __device__ void operator()(float (&p)[1], const float (&a)[1]) const {
        p[0] = fminf(fmaxf(__fadd_rn(p[0], a[0]), l_min), l_max);
    }
};

// One warp's shared state: its partial sums, and the voxels it hit as a
// mask and (up to SHORT of them) as a list in the order of their first
// touch.
template <int NCH>
struct WarpSlab {
    float acc[NCH][ACC_V];
    unsigned hit[ACC_WORDS];
    unsigned short list[SHORT];
};

// One batch of NB tiles of a warp's samples [t, t + 32 * NB) below we:
// the lane's voxel (-1 where it has no sample) and channel values.
template <int NCH>
struct Batch {
    int iv[NB];
    float x[NB][NCH];

    __device__ __forceinline__ void load(int t, int we, int lane,
                                         const int* __restrict__ ivox,
                                         const float* __restrict__ ch0,
                                         const float* __restrict__ ch1) {
#pragma unroll
        for (int u = 0; u < NB; ++u) {
            const int s = t + 32 * u + lane;
            const bool ok = s < we;
            iv[u] = ok ? ivox[s] : -1;
            x[u][0] = ok ? ch0[s] : 0.f;
            if constexpr (NCH > 1) x[u][1] = ok ? ch1[s] : 0.f;
        }
    }
};

template <int NCH>
__device__ __forceinline__ void clear_hits(WarpSlab<NCH>& my, int lane) {
    if (lane < ACC_WORDS) my.hit[lane] = 0u;
    __syncwarp();
}

// Merges the same-voxel lanes of the first nt tiles of a batch: on return
// s[u] holds, at the lowest lane of each group of tile u (lead[u]), the
// group's sum. The sum is a fixed tree over the group's lanes in ascending
// order, by pointer jumping: s holds the sum of this lane and the group's
// next lanes up to (not including) lane nxt; each round adds the partial
// that nxt holds and jumps to nxt's nxt, so ceil(log2(g)) rounds sum a
// group of g. The tiles' rounds are independent and overlap. All 32 lanes
// call it; iv outside [0, 512) is no sample (a group of its own lane).
template <int NCH>
__device__ __forceinline__ void merge_tiles(const Batch<NCH>& b, int nt,
                                            int lane, bool (&lead)[NB],
                                            float (&s)[NB][NCH]) {
    int nxt[NB];
    int big = 1;
#pragma unroll
    for (int u = 0; u < NB; ++u) {
        nxt[u] = 32;
        lead[u] = false;
#pragma unroll
        for (int c = 0; c < NCH; ++c) s[u][c] = b.x[u][c];
        if (u >= nt) continue;                        // uniform per warp
        const bool ok = (unsigned)b.iv[u] < ACC_V;
        const unsigned grp = __match_any_sync(FULL_MASK,
                                              ok ? b.iv[u] : -1 - lane);
        const unsigned above = grp & (0xfffffffeu << lane);
        nxt[u] = above ? __ffs(above) - 1 : 32;
        lead[u] = ok && lane == __ffs(grp) - 1;
        big = max(big, __popc(grp));
    }
    big = __reduce_max_sync(FULL_MASK, big);
    for (int span = 1; span < big; span *= 2) {      // uniform per warp
#pragma unroll
        for (int u = 0; u < NB; ++u) {
            if (u >= nt) continue;                    // uniform per warp
            const int src = nxt[u] & 31;
            float v[NCH];
#pragma unroll
            for (int c = 0; c < NCH; ++c)
                v[c] = __shfl_sync(FULL_MASK, s[u][c], src);
            const int jump = __shfl_sync(FULL_MASK, nxt[u], src);
            if (nxt[u] < 32) {
#pragma unroll
                for (int c = 0; c < NCH; ++c) s[u][c] = __fadd_rn(s[u][c], v[c]);
                nxt[u] = jump;
            }
        }
    }
}

// Adds one tile's group sums (lane's: voxel iv, sum s, lead = it holds
// one) into the warp's slab; n, the length of the warp's list, is uniform
// over the warp. All 32 lanes call it.
template <int NCH>
__device__ __forceinline__ void add_tile(WarpSlab<NCH>& my, int lane, int iv,
                                         bool lead, const float (&s)[NCH],
                                         int& n) {
    const int v = lead ? iv : 0;
    const unsigned bit = 1u << (v & 31);
    // leaders of one tile hold distinct voxels: the bit read here is the
    // state before this tile, whatever other leaders OR in meanwhile; the
    // partial is read beside it and used only where the bit is set
    const unsigned word = my.hit[v >> 5];
    float old[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) old[c] = my.acc[c][v];
    const bool seen = word & bit;
    const unsigned fresh = __ballot_sync(FULL_MASK, lead && !seen);
    if (lead) {
        if (!seen) {
            atomicOr(&my.hit[v >> 5], bit);
            const int i = n + __popc(fresh & ((1u << lane) - 1u));
            if (i < SHORT) my.list[i] = (unsigned short)v;
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
            my.acc[c][v] = seen ? __fadd_rn(old[c], s[c]) : s[c];
    }
    n += __popc(fresh);
    __syncwarp();
}

// Adds the samples [ws, we) into the warp's slab, tile by tile in stream
// order, and returns the length of the warp's list. The next batch's loads
// are issued before the current batch is merged and added.
template <int NCH>
__device__ __forceinline__ int walk(WarpSlab<NCH>& my, int lane, int ws,
                                    int we, const int* __restrict__ ivox,
                                    const float* __restrict__ ch0,
                                    const float* __restrict__ ch1) {
    int n = 0;
    Batch<NCH> cur;
    cur.load(ws, we, lane, ivox, ch0, ch1);
    for (int t = ws; t < we; t += 32 * NB) {
        Batch<NCH> next;
        next.load(t + 32 * NB, we, lane, ivox, ch0, ch1);
        bool lead[NB];
        float s[NB][NCH];
        const int nt = min(NB, (we - t + 31) / 32);   // tiles with samples
        merge_tiles<NCH>(cur, nt, lane, lead, s);
#pragma unroll
        for (int u = 0; u < NB; ++u)
            if (u < nt)                               // uniform per warp
                add_tile<NCH>(my, lane, cur.iv[u], lead[u], s[u], n);
        cur = next;
    }
    return n;
}

// Applies the epilogue to the voxels v[k] >= 0 of payload row ``row`` with
// sums a[k]: every payload load is issued before the first store.
template <int NCH, int K, class Epilogue>
__device__ __forceinline__ void update(float* __restrict__ pay0,
                                       float* __restrict__ pay1, int row,
                                       const int (&v)[K],
                                       const float (&a)[K][NCH],
                                       const Epilogue& epi) {
    const size_t base = (size_t)row * ACC_V;
    float p[K][NCH] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (v[k] < 0) continue;
        p[k][0] = pay0[base + v[k]];
        if constexpr (NCH > 1) p[k][1] = pay1[base + v[k]];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (v[k] < 0) continue;
        epi(p[k], a[k]);
        pay0[base + v[k]] = p[k][0];
        if constexpr (NCH > 1) pay1[base + v[k]] = p[k][1];
    }
}

// The epilogue of a one-part entry: the n voxels of the warp's list, EPI_K
// a lane at once; each partial is the voxel's sum.
template <int NCH, class Epilogue>
__device__ __forceinline__ void short_epilogue(const WarpSlab<NCH>& my,
                                               int lane, int n, int row,
                                               float* pay0, float* pay1,
                                               const Epilogue& epi) {
    for (int i0 = 0; i0 < n; i0 += 32 * EPI_K) {
        int v[EPI_K];
        float a[EPI_K][NCH] = {};
#pragma unroll
        for (int k = 0; k < EPI_K; ++k) {
            const int i = i0 + 32 * k + lane;
            v[k] = i < n ? my.list[i] : -1;
            if (v[k] >= 0)
#pragma unroll
                for (int c = 0; c < NCH; ++c) a[k][c] = my.acc[c][v[k]];
        }
        update<NCH, EPI_K>(pay0, pay1, row, v, a, epi);
    }
}

// An entry of a CTA: its row and range, cut into ``parts`` parts (a
// function of its cnt alone); a long entry (parts > 1) is walked in round
// ``round`` by the CTA's warps [first, first + parts).
struct Plan {
    int row, start, cnt, parts, round, first;
};

__device__ __forceinline__ Plan load_entry(int b, int A, int C, int S,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ starts,
                                           const int* __restrict__ cnts) {
    Plan e{0, 0, 0, 0, 0, 0};
    if (b < A) {
        const int cnt = cnts[b], row = rows[b], start = max(starts[b], 0);
        if (cnt > 0 && row >= 0 && row < C) {
            const int end = (int)min((long long)start + cnt, (long long)S);
            const int c = max(end - start, 0);
            e = Plan{row, start, c,
                     c <= SHORT ? 1 : min(NW, (c + PART - 1) / PART), 0, 0};
        }
    }
    return e;
}

// The epilogue of a long entry, after its parts' walks: its parts' threads
// (this one: t) stride over the 512 voxels, sum the partials of the parts
// that hit each one in part order, and update the voxels some part hit.
template <int NCH, class Epilogue>
__device__ __forceinline__ void long_epilogue(const WarpSlab<NCH>* slabs,
                                              const Plan& e, int t,
                                              float* pay0, float* pay1,
                                              const Epilogue& epi) {
    const int stride = 32 * e.parts;
    for (int v0 = t; v0 < ACC_V; v0 += stride * EPI_K) {
        int v[EPI_K];
        float a[EPI_K][NCH] = {};
#pragma unroll
        for (int k = 0; k < EPI_K; ++k) {
            const int vox = v0 + stride * k;
            const unsigned bit = 1u << (vox & 31);
            bool any = false;
            for (int q = 0; vox < ACC_V && q < e.parts; ++q) {
                const WarpSlab<NCH>& part = slabs[e.first + q];
                if (!(part.hit[vox >> 5] & bit)) continue;
#pragma unroll
                for (int c = 0; c < NCH; ++c)
                    a[k][c] = any ? __fadd_rn(a[k][c], part.acc[c][vox])
                                  : part.acc[c][vox];
                any = true;
            }
            v[k] = any ? vox : -1;
        }
        update<NCH, EPI_K>(pay0, pay1, e.row, v, a, epi);
    }
}

// CTA c takes the entries k * gridDim.x + c, k < NW (strided, so that the
// long entries, which sit next to each other around the sensor, land in
// different CTAs); its warp k owns entry k. Round 0: every warp walks its
// own entry if that is short (one part) and applies its epilogue. Then each
// round of long entries, packed in entry order into the CTA's NW warps (an
// entry whose parts do not fit opens the next round): every warp walks its
// part into its own slab, and the entry's threads merge the parts'
// partials and update the payload.
template <int NCH, class Epilogue>
__global__ void __launch_bounds__(NW * 32)
block_accum_kernel(float* __restrict__ pay0, float* __restrict__ pay1,
                   int C, const int* __restrict__ rows,
                   const int* __restrict__ starts,
                   const int* __restrict__ cnts, int A,
                   const int* __restrict__ ivox,
                   const float* __restrict__ ch0,
                   const float* __restrict__ ch1, int S, Epilogue epi) {
    extern __shared__ __align__(16) unsigned char smem[];
    WarpSlab<NCH>* slabs = reinterpret_cast<WarpSlab<NCH>*>(smem);
    __shared__ Plan plan[NW];
    __shared__ int longs[NW];
    __shared__ int n_long, n_rounds;

    const int n_ctas = gridDim.x;
    const int cta = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    WarpSlab<NCH>& my = slabs[warp];

    // round 0: this warp's own entry, if short (warp 0 also reads the CTA's
    // entries for the plan, lane k entry k)
    const Plan own = load_entry(warp * n_ctas + cta, A, C, S, rows, starts,
                                cnts);
    Plan e = warp == 0 && lane < NW
                 ? load_entry(lane * n_ctas + cta, A, C, S, rows, starts, cnts)
                 : Plan{0, 0, 0, 0, 0, 0};
    if (own.parts == 1) {
        clear_hits(my, lane);
        const int n = walk<NCH>(my, lane, own.start, own.start + own.cnt,
                                ivox, ch0, ch1);
        short_epilogue<NCH>(my, lane, n, own.row, pay0, pay1, epi);
    }
    if (warp == 0) {
        // the CTA's plan: the long entries packed in entry order
        const unsigned lng = __ballot_sync(FULL_MASK, e.parts > 1);
        int round = 0, used = NW;
        for (unsigned m = lng; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            const int pj = __shfl_sync(FULL_MASK, e.parts, j);
            if (used + pj > NW) {
                ++round;
                used = 0;
            }
            if (lane == j) {
                e.round = round;
                e.first = used;
            }
            used += pj;
        }
        if (lane < NW) plan[lane] = e;
        if (e.parts > 1) longs[__popc(lng & ((1u << lane) - 1u))] = lane;
        if (lane == 0) {
            n_long = __popc(lng);
            n_rounds = round + 1;
        }
    }
    __syncthreads();                              // the plan is written

    const int rounds = n_rounds;
    for (int r = 1; r < rounds; ++r) {
        int k = -1;                               // the entry of this warp
        for (int i = 0; i < n_long; ++i) {
            const Plan& p = plan[longs[i]];
            if (p.round == r && warp >= p.first && warp < p.first + p.parts)
                k = longs[i];
        }
        if (k >= 0) {
            e = plan[k];
            clear_hits(my, lane);
            // part q: the q-th of e.parts equal sub-ranges, whole tiles
            const long long q = warp - e.first;
            const long long part = ((e.cnt + e.parts - 1) / e.parts + 31) & ~31;
            const int ws = e.start + (int)min(q * part, (long long)e.cnt);
            const int we = e.start + (int)min((q + 1) * part,
                                              (long long)e.cnt);
            walk<NCH>(my, lane, ws, we, ivox, ch0, ch1);
        }
        __syncthreads();                          // the parts are walked
        if (k >= 0)
            long_epilogue<NCH>(slabs, e, (warp - e.first) * 32 + lane, pay0,
                               pay1, epi);
        __syncthreads();                 // the slabs are free for the next
    }
}

template <int NCH, class Epilogue>
static int launch_accum(float* pay0, float* pay1, int C, const void* rows,
                        const void* starts, const void* cnts, int A,
                        const void* ivox, const void* ch0, const void* ch1,
                        int S, Epilogue epi, void* stream) {
    if (A <= 0) return 0;
    const size_t smem = sizeof(WarpSlab<NCH>) * NW;
    auto kernel = block_accum_kernel<NCH, Epilogue>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(A + NW - 1) / NW, NW * 32, smem, (cudaStream_t)stream>>>(
        pay0, pay1, C, (const int*)rows, (const int*)starts,
        (const int*)cnts, A, (const int*)ivox, (const float*)ch0,
        (const float*)ch1, S, epi);
    return (int)cudaGetLastError();
}

// The cut of an entry, for callers that report it: the most warps one
// entry gets, the samples one warp takes alone, the samples of a part.
extern "C" int nst_block_accum_warps(void) { return NW; }
extern "C" int nst_block_accum_short(void) { return SHORT; }
extern "C" int nst_block_accum_part(void) { return PART; }

extern "C" int nst_tsdf_accum_launch(void* weight, void* wsum, int C,
                                     const void* rows, const void* starts,
                                     const void* cnts, int A,
                                     const void* ivox, const void* w,
                                     const void* wd, int S, float max_weight,
                                     int no_clamp, void* stream) {
    return launch_accum<2>((float*)weight, (float*)wsum, C, rows, starts,
                           cnts, A, ivox, w, wd, S,
                           TsdfEpilogue{max_weight, no_clamp}, stream);
}

extern "C" int nst_logodds_accum_launch(void* logodds, int C,
                                        const void* rows, const void* starts,
                                        const void* cnts, int A,
                                        const void* ivox, const void* delta,
                                        int S, float l_min, float l_max,
                                        void* stream) {
    return launch_accum<1>((float*)logodds, nullptr, C, rows, starts, cnts,
                           A, ivox, delta, nullptr, S,
                           LogoddsEpilogue{l_min, l_max}, stream);
}
