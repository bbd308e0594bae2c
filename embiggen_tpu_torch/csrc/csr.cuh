// Device helpers over a CSR whose rows are sorted, shared by the kernels
// that search it (K5 and K6 in edges.cu, K8 in edge_metrics.cu, K14 in
// batches.cu, K19 in walks2.cu).
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace ebt {

// Lower bound of dst in src's CSR row: the arc id of (src, dst) when
// *found, else where dst would go.
__device__ __forceinline__ int32_t arc_lower_bound(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    int32_t src, int32_t dst, bool* found) {
  int32_t lo = row_ptr[src];
  int32_t hi = row_ptr[src + 1];
  const int32_t end = hi;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (col_idx[mid] < dst) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  *found = lo < end && col_idx[lo] == dst;
  return lo;
}

// Whether a is among col_idx[lo_a, hi_a) and b among col_idx[lo_b, hi_b),
// each range sorted (an empty range: no): two lower-bound searches in lock
// step, so each step's two reads are in flight together and the chain is
// as long as the longer search alone.
__device__ __forceinline__ void sorted_ranges_contain(const int32_t* __restrict__ col_idx,
                                                      int32_t lo_a, int32_t hi_a, int32_t a,
                                                      int32_t lo_b, int32_t hi_b, int32_t b,
                                                      bool* in_a, bool* in_b) {
  const int32_t end_a = hi_a, end_b = hi_b;
  while (lo_a < hi_a || lo_b < hi_b) {
    const int32_t mid_a = lo_a + ((hi_a - lo_a) >> 1);
    const int32_t mid_b = lo_b + ((hi_b - lo_b) >> 1);
    const int32_t x_a = lo_a < hi_a ? __ldg(col_idx + mid_a) : 0;
    const int32_t x_b = lo_b < hi_b ? __ldg(col_idx + mid_b) : 0;
    if (lo_a < hi_a) {
      if (x_a < a) {
        lo_a = mid_a + 1;
      } else {
        hi_a = mid_a;
      }
    }
    if (lo_b < hi_b) {
      if (x_b < b) {
        lo_b = mid_b + 1;
      } else {
        hi_b = mid_b;
      }
    }
  }
  const int32_t y_a = lo_a < end_a ? __ldg(col_idx + lo_a) : 0;
  const int32_t y_b = lo_b < end_b ? __ldg(col_idx + lo_b) : 0;
  *in_a = lo_a < end_a && y_a == a;
  *in_b = lo_b < end_b && y_b == b;
}

// Source node of an arc id: the last row whose start is <= arc.
__device__ __forceinline__ int32_t arc_source(
    const int32_t* __restrict__ row_ptr, int32_t n_nodes, int32_t arc) {
  int32_t lo = 0, hi = n_nodes;  // answer in [lo, hi)
  while (hi - lo > 1) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (row_ptr[mid] <= arc) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The guided lower-bound search (K5, and K6's redraw check). What bounds a
// search on the H100 is the number of random 32-byte sectors it fetches
// from device memory, not the chain of loads: enough searches are in flight
// to hide each load's latency. A row's heads are node ids in [0, n_ids), so
// dst's place in a row of n heads is about n dst / n_ids when the heads are
// spread evenly (an Erdos-Renyi row, a hub's random neighbours). The search
// reads the whole sector (8 ids, two 16-byte loads) at that place and
// settles there when the sector brackets dst; else it knows a head on one
// side of dst, narrows the range to that side and interpolates again
// between the heads it knows, up to kGuidedSteps sectors, then bisects what
// is left. On the slice graph's rows of about 20 heads one sector settles
// nearly every search (a bisection touches 2-3 sectors); a 65,536-head
// row takes about three. Rows far from even (heads bunched in a few id
// ranges) cost at most kGuidedSteps sectors more than a bisection.
constexpr int kGuidedSteps = 3;

// The index of the first id of the 32-byte sector that holds col_idx[i]
// (the array may start at any 4-byte boundary).
__device__ __forceinline__ int64_t sector_start(const int32_t* col_idx, int64_t i) {
  const int64_t shift = (reinterpret_cast<uintptr_t>(col_idx) >> 2) & 7;
  return ((i + shift) & ~int64_t{7}) - shift;
}

// dst's lower bound in the sorted col_idx[lo, hi) (the arc id of its first
// arc when *found, else where it would go), heads in [0, n_ids). Only the
// sectors that hold an id of the range are read, so no load leaves the
// array's 32-byte-aligned granules, which lie inside its allocation.
__device__ __forceinline__ int32_t guided_lower_bound(const int32_t* __restrict__ col_idx,
                                                      int32_t lo, int32_t hi, int32_t dst,
                                                      uint32_t n_ids, bool* found) {
  const int32_t end = hi;
  // Every head of [lo, hi) lies in [v_lo, v_hi], and so does dst.
  uint32_t v_lo = 0, v_hi = n_ids - 1;
#pragma unroll 1
  for (int step = 0; step < kGuidedSteps && lo < hi; ++step) {
    const uint32_t span = v_hi - v_lo + 1;
    const int32_t guess = lo + static_cast<int32_t>(
        static_cast<uint64_t>(hi - lo) * (static_cast<uint32_t>(dst) - v_lo) / span);
    const int64_t c = sector_start(col_idx, guess < hi ? guess : hi - 1);
    int32_t ids[8];
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      const int4 v = c + h + 3 >= lo && c + h < hi
                         ? __ldg(reinterpret_cast<const int4*>(col_idx + c + h))
                         : make_int4(0, 0, 0, 0);
      ids[h] = v.x;
      ids[h + 1] = v.y;
      ids[h + 2] = v.z;
      ids[h + 3] = v.w;
    }
    const int32_t first = static_cast<int32_t>(c > lo ? c : lo);
    const int32_t last = static_cast<int32_t>(c + 8 < hi ? c + 8 : hi);
    int less = 0;
    bool eq = false;
    int32_t first_id = 0, last_id = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool valid = c + q >= lo && c + q < hi;
      less += valid && ids[q] < dst;
      eq |= valid && ids[q] == dst;
      if (c + q == first) first_id = ids[q];
      if (c + q == last - 1) last_id = ids[q];
    }
    if (less < last - first && (less > 0 || first == lo)) {
      // The first head at least dst is in this sector.
      *found = eq;
      return first + less;
    }
    if (less == 0) {
      hi = first;  // the answer is in [lo, first], and col_idx[first] >= dst
      v_hi = static_cast<uint32_t>(first_id);
    } else {
      lo = last;  // every head before `last` is below dst
      v_lo = static_cast<uint32_t>(last_id);
    }
  }
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(col_idx + mid) < dst) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  *found = lo < end && __ldg(col_idx + lo) == dst;
  return lo;
}

}  // namespace ebt
