// K9 `ell_walks` and K10 `rejection_walks`: whole p/q (second-order)
// walks, one launch each.
//
// K9 replaces embiggen_tpu/ops/walks.py::_second_order_step_ell and
// _sample_from_ell_row as random_walks scans them over the steps (its ELL
// branch). K10 replaces _second_order_step_rejection as random_walks scans
// it (its rejection branch). A step from curr with previous node prev weighs
// a candidate c by return_weight when c == prev, 1 when c neighbours prev,
// else explore_weight (times the arc's weight in K9; K10's alias proposals
// carry it).
//
// What bounds them on the H100: dependent reads, as in K1. A K9 step reads
// curr's ELL row (up to cap_eff ints, and as many weights), and the next
// step cannot start before the pick; a K10 step reads T proposals' arcs and
// runs T lower-bound searches of log2(deg) dependent reads each. The
// arithmetic (K9's membership tests) is small beside the memory latency of
// each step, if it is kept small: the first design, a warp per walker that
// scanned all ell_cap slots of prev for every candidate, spent 0.73 of its
// time there.
//
// What the designs do about it:
//   - K9: a group of G (8, 16 or 32) lanes per walker, G from the cap (8
//     up to 64 slots, the fastest at the S5 shapes), so that more walkers
//     run at once. The row of curr is read into the walker's shared memory,
//     32 slots at a time and only as far as its last real slot (rows are
//     padded only at their end), where it stays as the next step's previous
//     row (the JAX scan carry); nothing of prev is read again. Membership
//     is a lower-bound search of prev's row when that row is ascending
//     (every row of degree up to the cap keeps its CSR order), a scan of its
//     real slots when not (an over-cap row is a random subsample). Each lane
//     weighs a contiguous run of the candidates into registers; one group
//     scan of the runs' sums gives the CDF, and the pick #(cdf <= u) is a
//     group sum of each lane's count. Any cap works: a walker holds 8 bytes
//     per slot of shared memory (12 with arc weights), and fewer walkers
//     share a block when rows are wide. The pick is at most the last slot of
//     positive weight, so a u that rounds up to the total cannot land on
//     padding.
//   - K10: a group of T (8 or 16) lanes per walker, one proposal per lane,
//     so the T proposals and their searches run at once; a ballot finds the
//     first accepted, and where all reject, a group scan of the weights
//     picks among them (SIR, as the JAX version does). A search ends after
//     at most ceil(log2(deg + 1)) steps, the JAX `_bsearch_iters` bound.
// Randomness is Philox keyed by the wrapper's seed with counter (walker,
// step or block of steps, lane or 0, offset), so no generator state is read
// or written.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"
#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ Philox4 draw(int64_t walker, uint32_t step, uint32_t lane,
                                        uint32_t offset, uint32_t k0, uint32_t k1) {
  return philox4x32_10(Philox4{static_cast<uint32_t>(walker),
                               static_cast<uint32_t>(walker >> 32),
                               (step << 5) | lane, offset},
                       k0, k1);
}

// K9's shared memory per walker: curr's and prev's rows (swapped each step),
// and curr's arc weights when the graph is weighted.
__host__ __device__ __forceinline__ int ell_walker_ints(int ell_cap, bool weighted) {
  return (weighted ? 3 : 2) * ell_cap;
}

// Sum, max and inclusive scan over the G lanes of a walker's group (G a
// power of two up to 32; `gl` the lane in the group). Every lane of the
// warp takes part: K9 keeps its control flow the same for all the walkers
// of a warp, so that their groups are never run one after another.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, G);
  return v;
}

template <int G>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o, G));
  return v;
}

template <int G>
__device__ __forceinline__ float group_scan(float v, int gl) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float t = __shfl_up_sync(kFull, v, o, G);
    if (gl >= o) v += t;
  }
  return v;
}

template <int G>
__device__ __forceinline__ bool group_all(bool v, int lane) {
  const unsigned bits = G == 32 ? kFull : ((1u << G) - 1u);
  return ((__ballot_sync(kFull, v) >> (lane & ~(G - 1))) & bits) == bits;
}

// Copy one ELL row (and its weights, for the first `n_w` slots) into
// shared memory, kFirst slots first and more only while some walker of the
// warp has real slots to the end of the round: rows are padded only at
// their end, so most rows take one round of independent loads. Returns the
// row's extent (last real slot + 1, the same on every lane of the group)
// and, in `sorted`, whether row[0, extent) is non-decreasing (rows of
// degree up to the cap keep their CSR order, which is ascending), so that
// membership can search it.
template <int G, int kFirst>
__device__ int load_row(const int32_t* __restrict__ cols, const float* __restrict__ wts,
                        int64_t base, int ell_cap, int n_w, int32_t* row, float* wrow,
                        int gl, int lane, bool* sorted) {
  constexpr int kPer = kFirst / G;
  int hi = -1;
  for (int j0 = 0; j0 < ell_cap; j0 += kFirst) {
    int32_t v[kPer];
    float w[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = j0 + gl + i * G;
      v[i] = j < ell_cap ? __ldg(cols + base + j) : -1;
      w[i] = wts != nullptr && j < n_w ? __ldg(wts + base + j) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = j0 + gl + i * G;
      if (j < ell_cap) {
        row[j] = v[i];
        if (v[i] >= 0) hi = j;
        if (wts != nullptr && j < n_w) wrow[j] = w[i];
      }
    }
    if (!__any_sync(kFull, group_max<G>(hi) >= j0 + kFirst - 1)) break;
  }
  const int ext = group_max<G>(hi) + 1;
  const int ext_warp = __reduce_max_sync(kFull, ext);
  __syncwarp();
  bool ok = true;
  for (int j = 1 + gl; j < ext_warp; j += G) ok = ok && (j >= ext || row[j - 1] <= row[j]);
  *sorted = group_all<G>(ok, lane);
  return ext;
}

// Is c (>= 0) in row[0, ext)? A scan, for a prev row that is not sorted
// (an over-cap row holds a random subsample in random order).
__device__ __forceinline__ bool scan_member(const int32_t* row, int ext, int32_t c) {
  for (int i = 0; i < ext; ++i) {
    if (row[i] == c) return true;
  }
  return false;
}

// K9: a group of G lanes per walker. Each step copies curr's row into the
// walker's shared memory (`load_row`), where it stays as the next step's
// prev row. The candidates, slots [0, n) with n = min(cap_eff, extent)
// (every slot of the start's row on the first step), are cut into
// contiguous runs of S <= kMaxPer slots, one per lane; a lane weighs its
// run (membership by a lower-bound search in prev's row when that row is
// sorted, all the run's searches in lockstep, else by `scan_member`), keeps
// the weights in registers, and one group scan of the lanes' sums gives the
// CDF. The pick #(cdf <= u), at most the last slot of positive weight, is a
// group sum of each lane's count over its run. Where a row of the warp is
// longer than G kMaxPer slots, the warp weighs its rows in rounds of G
// kMaxPer slots, twice (once for the total, once for the count), with no
// CDF stored. Loop counts are the warp's largest; a walker past the last
// (in the last block) walks the last one's walk again and writes nothing.
template <int G>
__global__ void __launch_bounds__(256) ell_walks_kernel(
    const int32_t* __restrict__ ell_cols, const float* __restrict__ ell_w, int ell_cap,
    int cap_eff, const int32_t* __restrict__ starts, int32_t* __restrict__ walks,
    int64_t n_walkers, int walk_length, float return_weight, float explore_weight,
    uint32_t k0, uint32_t k1, uint32_t offset, long long* __restrict__ clocks) {
  constexpr int kMaxPer = 4;
  constexpr int kFirst = 32;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, gl = threadIdx.x % G, group = threadIdx.x / G;
  const int64_t b_own = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G) + group;
  const bool active = b_own < n_walkers;
  const int64_t b = active ? b_own : n_walkers - 1;
  const bool weighted = ell_w != nullptr;
  int32_t* rows = smem + static_cast<int64_t>(group) * ell_walker_ints(ell_cap, weighted);
  float* wrow = reinterpret_cast<float*>(rows + 2 * ell_cap);
  int32_t* out = walks + b * walk_length;
  const bool writer = active && gl == 0;
  const int32_t start = starts[b];
  if (writer) out[0] = start;
  if (walk_length == 1) return;
  // Cycles of the row loads, the weights (membership) with their scan, the
  // pick, and the whole walk.
  long long cycles[4] = {0, 0, 0, 0};
#ifdef EBT_PHASE_CLOCK
  const long long t_walk = clock64();
  long long t_mark = t_walk;
#define EBT_STAMP(i)                  \
  {                                   \
    const long long now = clock64();  \
    cycles[i] += now - t_mark;        \
    t_mark = now;                     \
  }
#else
#define EBT_STAMP(i)
#endif
  // The uniforms: lane gl holds the Philox block of moves [4 G q, 4 G (q + 1))
  // numbered q, words (4 gl .. 4 gl + 3) of it; move s takes word s % 4 of
  // lane (s / 4) % G.
  Philox4 rnd{0u, 0u, 0u, 0u};
  int32_t prev = -1, curr = start;
  int prev_ext = 0, prev_iters = 0;
  bool prev_sorted = true;
  int cur = 0;  // curr's row starts at rows + cur * ell_cap, prev's after the other
  for (int t = 1; t < walk_length; ++t) {
    const int s = t - 1;
    if (s % (4 * G) == 0) {
      rnd = draw(b, static_cast<uint32_t>(s / (4 * G)), static_cast<uint32_t>(gl), offset, k0,
                 k1);
    }
    const uint32_t word = (s & 3) == 0 ? rnd.x : (s & 3) == 1 ? rnd.y : (s & 3) == 2 ? rnd.z
                                                                                     : rnd.w;
    const float unit = unit_float(__shfl_sync(kFull, word, (s / 4) % G, G));
    const bool first = t == 1;
    int32_t* row = rows + cur * ell_cap;
    const int32_t* prow = rows + (cur ^ 1) * ell_cap;
    const int64_t base = static_cast<int64_t>(curr) * ell_cap;
    const int width = first ? ell_cap : cap_eff;
    bool sorted;
    const int ext = load_row<G, kFirst>(ell_cols, ell_w, base, ell_cap, width, row, wrow, gl,
                                         lane, &sorted);
    EBT_STAMP(0);
    const int n = width < ext ? width : ext;
    const int per_round = G * kMaxPer;
    const int rounds = __reduce_max_sync(kFull, (n + per_round - 1) / per_round);
    const int S = rounds <= 1 ? (n + G - 1) / G : kMaxPer;
    const int iters = __reduce_max_sync(kFull, prev_iters);
    const bool search = !first && prev_sorted && prev_ext > 0;
    // The weights of slots r * G * S + gl * S + i, i < S, into w[].
    float w[kMaxPer];
    auto weigh = [&](int r) {
      int32_t c[kMaxPer];
      bool common[kMaxPer];
#pragma unroll
      for (int i = 0; i < kMaxPer; ++i) {
        const int j = r * G * S + gl * S + i;
        c[i] = i < S && j < n ? row[j] : -1;
        common[i] = false;
      }
      if (!first) {
        // The lower-bound searches of the run, in lockstep; a row shorter
        // than the warp's longest is done early (m reaches 1, half 0).
        int pos[kMaxPer];
#pragma unroll
        for (int i = 0; i < kMaxPer; ++i) pos[i] = 0;
        int m = search ? prev_ext : 1;
        for (int it = 0; it < iters; ++it) {
          const int half = m >> 1;
#pragma unroll
          for (int i = 0; i < kMaxPer; ++i) {
            if (i < S) pos[i] = prow[pos[i] + half] < c[i] ? pos[i] + half : pos[i];
          }
          m -= half;
        }
#pragma unroll
        for (int i = 0; i < kMaxPer; ++i) {
          if (i < S && c[i] >= 0 && c[i] != prev) {
            if (search) {
              const int q = pos[i] + (prow[pos[i]] < c[i]);
              common[i] = q < prev_ext && prow[q] == c[i];
            } else {
              common[i] = scan_member(prow, prev_ext, c[i]);
            }
          }
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPer; ++i) {
        const int j = r * G * S + gl * S + i;
        float x = 0.f;
        if (c[i] >= 0) {
          x = first ? 1.f : (c[i] == prev ? return_weight : common[i] ? 1.f : explore_weight);
          if (weighted) x *= wrow[j];
        }
        w[i] = x;
        sum += x;
      }
      return sum;
    };
    float total = 0.f, excl = 0.f;
    if (rounds <= 1) {
      const float lsum = weigh(0);
      const float incl = group_scan<G>(lsum, gl);
      excl = incl - lsum;
      total = __shfl_sync(kFull, incl, G - 1, G);
    } else {
      for (int r = 0; r < rounds; ++r) total += group_sum<G>(weigh(r));
    }
    EBT_STAMP(1);
    const float u = unit * total;
    int count = 0, last = -1;
    float carry = 0.f;
    for (int r = 0; r < (rounds > 1 ? rounds : 1); ++r) {
      float run = excl;
      if (rounds > 1) {
        const float lsum = weigh(r);
        const float incl = group_scan<G>(lsum, gl);
        run = carry + incl - lsum;
        carry += __shfl_sync(kFull, incl, G - 1, G);
      }
#pragma unroll
      for (int i = 0; i < kMaxPer; ++i) {
        const int j = r * G * S + gl * S + i;
        if (i < S && j < n) {
          run += w[i];
          count += run <= u;
          if (w[i] > 0.f) last = j;
        }
      }
    }
    count = group_sum<G>(count);
    last = group_max<G>(last);
    // No candidate of positive weight: stay.
    const int32_t nxt = total > 0.f && last >= 0 ? row[count < last ? count : last] : curr;
    EBT_STAMP(2);
    if (writer) out[t] = nxt;
    prev = curr;
    curr = nxt;
    prev_ext = ext;
    prev_sorted = sorted;
    prev_iters = 0;
    for (int m = ext; m > 1; m -= m >> 1) ++prev_iters;
    cur ^= 1;
    // The next step's copy overwrites the row read here.
    __syncwarp();
  }
#undef EBT_STAMP
#ifdef EBT_PHASE_CLOCK
  cycles[3] = clock64() - t_walk;
  if (writer) {
    for (int i = 0; i < 4; ++i) clocks[4 * b + i] = cycles[i];
  }
#endif
}

// A first-order step (K1's): uniform or alias over curr's CSR row.
__device__ __forceinline__ int32_t first_order_step(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const float* __restrict__ alias_prob, const int32_t* __restrict__ alias_idx,
    int32_t curr, const Philox4& r) {
  const int32_t base = row_ptr[curr];
  const uint32_t deg = static_cast<uint32_t>(row_ptr[curr + 1] - base);
  if (deg == 0) return curr;
  int32_t off = static_cast<int32_t>(bounded(r.x, deg));
  if (alias_prob != nullptr && !(unit_float(r.y) < alias_prob[base + off])) {
    off = alias_idx[base + off];
  }
  return col_idx[base + off];
}

template <int T>
__global__ void rejection_walks_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const float* __restrict__ alias_prob, const int32_t* __restrict__ alias_idx,
    const int32_t* __restrict__ starts, int32_t* __restrict__ walks, int64_t n_walkers,
    int walk_length, float return_weight, float explore_weight, uint32_t k0, uint32_t k1,
    uint32_t offset) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t b = tid / T;
  const int g = static_cast<int>(tid % T);  // this lane's proposal
  if (b >= n_walkers) return;  // whole groups leave together
  const int lane = threadIdx.x & 31;
  const unsigned mask = ((T == 32 ? kFull : ((1u << T) - 1u)) << (lane & ~(T - 1)));
  const float w_max = fmaxf(fmaxf(return_weight, 1.f), explore_weight);
  int32_t* out = walks + b * walk_length;
  const int32_t start = starts[b];
  if (g == 0) out[0] = start;
  if (walk_length == 1) return;
  int32_t prev = start;
  int32_t curr = first_order_step(row_ptr, col_idx, alias_prob, alias_idx, start,
                                  draw(b, 1, 0, offset, k0, k1));
  if (g == 0) out[1] = curr;
  for (int t = 2; t < walk_length; ++t) {
    const int32_t base = row_ptr[curr];
    const uint32_t deg = static_cast<uint32_t>(row_ptr[curr + 1] - base);
    int32_t nxt = curr;  // a zero-degree node is a trap
    if (deg > 0) {
      const Philox4 r = draw(b, static_cast<uint32_t>(t), static_cast<uint32_t>(g), offset,
                             k0, k1);
      int32_t off = static_cast<int32_t>(bounded(r.x, deg));
      if (alias_prob != nullptr && !(unit_float(r.y) < alias_prob[base + off])) {
        off = alias_idx[base + off];
      }
      const int32_t c = col_idx[base + off];
      float w = return_weight;
      if (c != prev) {
        bool found = false;
        ebt::arc_lower_bound(row_ptr, col_idx, prev, c, &found);
        w = found ? 1.f : explore_weight;
      }
      const unsigned acc = __ballot_sync(mask, unit_float(r.z) * w_max < w) & mask;
      int pick;
      if (acc != 0u) {
        pick = __ffs(acc >> (lane & ~(T - 1))) - 1;
      } else {
        // Sampling-importance-resampling among the T proposals.
        float cdf = w;
#pragma unroll
        for (int o = 1; o < T; o <<= 1) {
          const float v = __shfl_up_sync(mask, cdf, o, T);
          if (g >= o) cdf += v;
        }
        const float total = __shfl_sync(mask, cdf, T - 1, T);
        const float u = unit_float(__shfl_sync(mask, r.w, 0, T)) * total;
        pick = __popc(__ballot_sync(mask, cdf <= u) & mask);
        pick = pick < T - 1 ? pick : T - 1;
      }
      nxt = __shfl_sync(mask, c, pick, T);
    }
    if (g == 0) out[t] = nxt;
    prev = curr;
    curr = nxt;
  }
}

}  // namespace

extern "C" {

// cap_eff (<= ell_cap) slots of a row are candidates after the first step;
// membership runs over prev's real slots. ell_w may be NULL. The lanes per
// walker: 8 up to 64 candidates (the fastest of 4, 8, 16 and 32 at the S5
// shapes), 16 up to 128, else 32; a row of more than 4 per lane is weighed
// in rounds. A block holds as many whole warps of walkers (up to 256 lanes)
// as their rows fit its shared memory; rows too wide for one warp are an
// invalid-value error.
int ebt_ell_walks(const void* ell_cols, const void* ell_w, int ell_cap, int cap_eff,
                  const void* starts, void* walks, long long n_walkers, int walk_length,
                  float return_weight, float explore_weight, unsigned long long seed,
                  unsigned int offset, void* clocks, void* stream) {
  if (n_walkers == 0) return 0;
  if (ell_cap < 1 || cap_eff < 1 || cap_eff > ell_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = cap_eff <= 64 ? 8 : (cap_eff <= 128 ? 16 : 32);
  const auto kernel = group == 8 ? ell_walks_kernel<8>
                      : group == 16 ? ell_walks_kernel<16> : ell_walks_kernel<32>;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Whole warps: as many walkers as fit, a multiple of the walkers a warp
  // holds.
  const long long per_walker = 4LL * ell_walker_ints(ell_cap, ell_w != nullptr);
  const long long per_warp = 32 / group;
  long long per_block = smem_max / per_walker;
  if (per_block > 256 / group) per_block = 256 / group;
  per_block -= per_block % per_warp;
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(per_block * per_walker);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_walkers + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(group * per_block), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell_cols), static_cast<const float*>(ell_w), ell_cap,
      cap_eff, static_cast<const int32_t*>(starts), static_cast<int32_t*>(walks), n_walkers,
      walk_length, return_weight, explore_weight, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset, static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

// n_tries is 8 or 16 (the lanes of a walker's group); alias tables may be
// NULL (uniform proposals).
int ebt_rejection_walks(const void* row_ptr, const void* col_idx, const void* alias_prob,
                        const void* alias_idx, const void* starts, void* walks,
                        long long n_walkers, int walk_length, float return_weight,
                        float explore_weight, int n_tries, unsigned long long seed,
                        unsigned int offset, void* stream) {
  if (n_walkers == 0) return 0;
  if (n_tries != 8 && n_tries != 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = n_walkers * n_tries;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(col_idx);
  const auto* ap = static_cast<const float*>(alias_prob);
  const auto* ai = static_cast<const int32_t*>(alias_idx);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* wk = static_cast<int32_t*>(walks);
  const auto k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  if (n_tries == 8) {
    rejection_walks_kernel<8><<<blocks, kThreads, 0, s>>>(rp, ci, ap, ai, st, wk, n_walkers,
                                                          walk_length, return_weight,
                                                          explore_weight, k0, k1, offset);
  } else {
    rejection_walks_kernel<16><<<blocks, kThreads, 0, s>>>(rp, ci, ap, ai, st, wk, n_walkers,
                                                           walk_length, return_weight,
                                                           explore_weight, k0, k1, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
