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
