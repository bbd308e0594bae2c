// Device helpers over a CSR whose rows are sorted, shared by the kernels
// that search it (K5 and K6 in edges.cu, K8 in edge_metrics.cu, K14 in
// batches.cu).
#pragma once

#include <cuda_runtime.h>

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

}  // namespace ebt
