// K7 `csr_spmm`: out[r] = row_scale[r] * sum over the arcs (r, c, w) of the
// CSR kernel of w * col_scale[c] * x[c], for the GCN's graph convolution.
//
// Replaces embiggen_tpu/ops/spmm.py::_spmm_padded_impl (_ell_spmm plus the
// COO overflow) and its custom VJP _spmm_padded_bwd. The forward pass runs
// over the kernel's CSR with row_scale = 1 / den (mean, sqrtn) or none
// (sum); the backward pass is the same kernel over the transposed CSR with
// col_scale = 1 / den, which is Aᵀ (g / den) without a separate [N, D]
// scaling pass. The TPU layout (single-K ELLPACK plus overflow, chosen by
// measured v5e gather rates) is not carried over: the CSR itself is the
// layout.
//
// What bounds it on the H100: gathered bytes. At the bench shape (1M rows,
// 20M arcs, D = 128 f32) one pass reads 20M random rows of 512 bytes,
// 10.2 GB, about 3 ms at the card's 3.35 TB/s; the CSR, the weights and
// the [N, D] output add about 0.8 GB. There are two FLOPs per gathered
// float.
//
// What the design does about it: one warp per output row, each lane
// holding 4 columns (one 16-byte load per row and lane, a warp reads a
// whole 512-byte row per arc), the row's arcs read 32 at a time and
// broadcast by shuffles. Rows are independent, so there are no atomics and
// the result does not depend on the schedule; arcs are summed in CSR
// order. x is indexed with 64-bit offsets: at 20M arcs, arc * D passes
// 2^31.
//
// Gathering from feature slices of x small enough to stay in L2 instead
// (scripts/spmm_slices.py measures it) is slower at the bench shape: a
// slice that every SM reads stays resident only up to about 20 MB, and
// each pass pays again for every row and arc of the CSR.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void fma(float* acc, float w, float4 v) {
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  __device__ static void store(float* p, const float* acc, float s) {
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0] * s, acc[1] * s, acc[2] * s, acc[3] * s);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void fma(float* acc, float w, float v) { acc[0] += w * v; }
  __device__ static void store(float* p, const float* acc, float s) {
    *p = acc[0] * s;
  }
};

template <int VEC>
__global__ void csr_spmm_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ x,
    const float* __restrict__ row_scale, const float* __restrict__ col_scale,
    float* __restrict__ out, int64_t n_out, int d) {
  const int64_t row =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_out) return;  // uniform across the warp
  const int32_t start = row_ptr[row], end = row_ptr[row + 1];
  const float rs = row_scale != nullptr ? row_scale[row] : 1.0f;
  for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < d;
    float acc[VEC] = {};
    for (int32_t base = start; base < end; base += 32) {
      int32_t col = 0;
      float w = 0.0f;
      if (base + lane < end) {
        col = cols[base + lane];
        w = vals[base + lane];
        if (col_scale != nullptr) w *= col_scale[col];
      }
      const int count = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const int32_t cj = __shfl_sync(kFull, col, j);
        const float wj = __shfl_sync(kFull, w, j);
        if (active) {
          Vec<VEC>::fma(acc, wj, Vec<VEC>::load(x + static_cast<int64_t>(cj) * d + c));
        }
      }
    }
    if (active) Vec<VEC>::store(out + row * d + c, acc, rs);
  }
}

}  // namespace

extern "C" {

// row_scale ([n_out]) and col_scale ([n_in]) may be NULL. vec4 != 0 needs
// d % 4 == 0 and 16-byte aligned x and out.
int ebt_csr_spmm(const void* row_ptr, const void* cols, const void* vals,
                 const void* x, const void* row_scale, const void* col_scale,
                 void* out, long long n_out, int d, int vec4, void* stream) {
  if (n_out == 0 || d == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_out * 32 + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* xp = static_cast<const float*>(x);
  const auto* rsc = static_cast<const float*>(row_scale);
  const auto* csc = static_cast<const float*>(col_scale);
  auto* o = static_cast<float*>(out);
  if (vec4) {
    csr_spmm_kernel<4><<<blocks, kThreads, 0, s>>>(rp, ci, v, xp, rsc, csc, o,
                                                   n_out, d);
  } else {
    csr_spmm_kernel<1><<<blocks, kThreads, 0, s>>>(rp, ci, v, xp, rsc, csc, o,
                                                   n_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
