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
// curr's ELL row (cap_eff ints, and as many weights), and the next step
// cannot start before the pick; a K10 step reads T proposals' arcs and runs
// T lower-bound searches of log2(deg) dependent reads each. The arithmetic
// (K9's cap_eff x ell_cap membership compares) is small beside the memory
// latency of each step.
//
// What the designs do about it:
//   - K9: a warp per walker. The row of curr is read once, coalesced, into
//     the warp's shared memory, where it stays as the next step's previous
//     row (the JAX scan carry): membership compares a lane's candidates
//     against prev's row in shared memory (every lane reads the same word, a
//     broadcast), and nothing of prev is read again. The weights' inclusive
//     CDF is a warp scan, 32 slots at a time, kept in shared memory; the pick
//     #(cdf <= u) is a warp count. Any cap works: a warp holds 12 bytes per
//     slot of shared memory, and fewer warps share a block when rows are
//     wide. The pick is at most the last slot of positive weight, so a u
//     that rounds up to the total cannot land on padding.
//   - K10: a group of T (8 or 16) lanes per walker, one proposal per lane,
//     so the T proposals and their searches run at once; a ballot finds the
//     first accepted, and where all reject, a group scan of the weights
//     picks among them (SIR, as the JAX version does). A search ends after
//     at most ceil(log2(deg + 1)) steps, the JAX `_bsearch_iters` bound.
// Randomness is Philox keyed by the wrapper's seed with counter (walker,
// step, lane or 0, offset), so no generator state is read or written.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"
#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;

__device__ __forceinline__ Philox4 draw(int64_t walker, uint32_t step, uint32_t lane,
                                        uint32_t offset, uint32_t k0, uint32_t k1) {
  return philox4x32_10(Philox4{static_cast<uint32_t>(walker),
                               static_cast<uint32_t>(walker >> 32),
                               (step << 5) | lane, offset},
                       k0, k1);
}

// Inclusive warp scan of v.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One warp's pick over slots [0, width) of `row` with weights from
// weight(j): writes the inclusive CDF into cdf[], draws u in [0, total) and
// returns row[min(#(cdf <= u), last slot of positive weight)], or `stay`
// when the total is 0.
template <typename Weight>
__device__ int32_t warp_pick(const int32_t* row, float* cdf, int width, Weight weight,
                             float unit, int32_t stay, int lane) {
  float carry = 0.f;
  int last = -1;
  for (int base = 0; base < width; base += 32) {
    const int j = base + lane;
    const float w = j < width ? weight(j) : 0.f;
    const float c = warp_scan(w, lane) + carry;
    if (j < width) cdf[j] = c;
    const unsigned pos = __ballot_sync(kFull, w > 0.f);
    if (pos != 0u) last = base + 31 - __clz(pos);
    carry = __shfl_sync(kFull, c, 31);
  }
  if (!(carry > 0.f)) return stay;
  __syncwarp();
  const float u = unit * carry;
  int count = 0;
  for (int base = 0; base < width; base += 32) {
    const int j = base + lane;
    count += __popc(__ballot_sync(kFull, j < width && cdf[j] <= u));
  }
  const int pick = count < last ? count : last;
  return row[pick];
}

__global__ void ell_walks_kernel(const int32_t* __restrict__ ell_cols,
                                 const float* __restrict__ ell_w, int ell_cap, int cap_eff,
                                 const int32_t* __restrict__ starts,
                                 int32_t* __restrict__ walks, int64_t n_walkers,
                                 int walk_length, float return_weight,
                                 float explore_weight, uint32_t k0, uint32_t k1,
                                 uint32_t offset) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= n_walkers) return;  // the whole warp leaves together
  // This warp's two rows (prev's and curr's, swapped each step) and CDF.
  int32_t* prev_row = smem + static_cast<int64_t>(warp) * 3 * ell_cap;
  int32_t* curr_row = prev_row + ell_cap;
  float* cdf = reinterpret_cast<float*>(curr_row + ell_cap);
  int32_t* out = walks + b * walk_length;
  const int32_t start = starts[b];
  if (lane == 0) out[0] = start;
  if (walk_length == 1) return;
  // First step: first-order over the start's whole ELL row.
  const int64_t s_base = static_cast<int64_t>(start) * ell_cap;
  for (int j = lane; j < ell_cap; j += 32) prev_row[j] = ell_cols[s_base + j];
  __syncwarp();
  const float unit0 = unit_float(draw(b, 1, 0, offset, k0, k1).x);
  int32_t prev = start;
  int32_t curr = warp_pick(
      prev_row, cdf, ell_cap,
      [&](int j) {
        return prev_row[j] < 0 ? 0.f : (ell_w != nullptr ? ell_w[s_base + j] : 1.f);
      },
      unit0, start, lane);
  if (lane == 0) out[1] = curr;
  for (int t = 2; t < walk_length; ++t) {
    __syncwarp();
    const int64_t c_base = static_cast<int64_t>(curr) * ell_cap;
    for (int j = lane; j < ell_cap; j += 32) curr_row[j] = ell_cols[c_base + j];
    __syncwarp();
    const float unit = unit_float(draw(b, static_cast<uint32_t>(t), 0, offset, k0, k1).x);
    const int32_t p = prev;
    const int32_t* pr = prev_row;
    const int32_t* cr = curr_row;
    const int32_t nxt = warp_pick(
        cr, cdf, cap_eff,
        [&](int j) {
          const int32_t c = cr[j];
          if (c < 0) return 0.f;
          float w;
          if (c == p) {
            w = return_weight;
          } else {
            bool common = false;
            for (int i = 0; i < ell_cap; ++i) {
              if (pr[i] == c) {
                common = true;
                break;
              }
            }
            w = common ? 1.f : explore_weight;
          }
          return ell_w != nullptr ? w * ell_w[c_base + j] : w;
        },
        unit, curr, lane);
    if (lane == 0) out[t] = nxt;
    prev = curr;
    curr = nxt;
    int32_t* swap = prev_row;
    prev_row = curr_row;
    curr_row = swap;
  }
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
// membership runs over all ell_cap slots of prev's row. ell_w may be NULL.
// The block holds as many warps (up to 8) as their rows fit its shared
// memory; a row too wide for one warp is an invalid-value error.
int ebt_ell_walks(const void* ell_cols, const void* ell_w, int ell_cap, int cap_eff,
                  const void* starts, void* walks, long long n_walkers, int walk_length,
                  float return_weight, float explore_weight, unsigned long long seed,
                  unsigned int offset, void* stream) {
  if (n_walkers == 0) return 0;
  if (ell_cap < 1 || cap_eff < 1 || cap_eff > ell_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_warp = 12LL * ell_cap;
  long long warps = smem_max / per_warp;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = static_cast<size_t>(warps * per_warp);
  err = cudaFuncSetAttribute(ell_walks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_walkers + warps - 1) / warps;
  ell_walks_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * warps), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell_cols), static_cast<const float*>(ell_w), ell_cap,
      cap_eff, static_cast<const int32_t*>(starts), static_cast<int32_t*>(walks), n_walkers,
      walk_length, return_weight, explore_weight, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset);
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
