// K17a `halo_spmm`: one shard's rows of the row-sharded graph convolution,
//   out[r] = row_scale[r] * sum over the shard's arcs (r, c, w) of
//            w * col_scale[c] * src(c),
// where src(c) is x_local[c] for c < split and halo[c - split] otherwise.
//
// Replaces embiggen_tpu/parallel/halo.py::halo_spmm_local (the local and
// halo ELL contractions, their COO overflow and the mean / sqrtn division,
// :266-318). The shard's CSR lists every arc of its S output rows once, its
// columns in one space: [0, S) are the shard's own input rows and [S, S +
// P * H) the rows of the halo buffer that the all-to-all filled (peer q's
// boundary rows at q * H + slot). So one launch reads both tables by
// column range, with the combiner's 1 / den fused as row_scale. The
// backward pass is the same kernel over the transposed CSR (S + P * H
// output rows, the S gradient rows as its one table) with col_scale =
// 1 / den: rows [0, S) of its output are the local input gradient, rows
// [S, S + P * H) the halo gradients that go back to their owners.
//
// What bounds it on the H100: gathered bytes, as for K7 (csrc/spmm.cu): one
// random row of D floats per arc, plus the CSR and the [S, D] output. At
// S3's graph cut in 4 shards (250k rows, about 5M arcs a shard, D 128) a
// shard reads 2.6 GB of rows, about 0.8 ms at 3.35 TB/s.
//
// What the design does about it: K7's layout. One warp per output row,
// each lane 4 columns (a 16-byte load; a warp reads a 512-byte row per
// arc), the row's arcs read 32 at a time and broadcast by shuffles. Rows
// are independent: no atomics, and the sums follow the CSR's order, so the
// result does not depend on the schedule. The table is picked per arc from
// its column, a uniform branch across the warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void fma(float* acc, float w, const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
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
  __device__ static void fma(float* acc, float w, const float* p) {
    acc[0] += w * __ldg(p);
  }
  __device__ static void store(float* p, const float* acc, float s) {
    *p = acc[0] * s;
  }
};

template <int VEC>
__global__ void halo_spmm_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ x,
    const float* __restrict__ halo, int32_t split,
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
        const float* src = cj < split
                               ? x + static_cast<int64_t>(cj) * d
                               : halo + static_cast<int64_t>(cj - split) * d;
        if (active) Vec<VEC>::fma(acc, wj, src + c);
      }
    }
    if (active) Vec<VEC>::store(out + row * d + c, acc, rs);
  }
}

}  // namespace

extern "C" {

// Columns below `split` read x ([split, d]), the others halo (may be NULL
// when no column reaches it). row_scale ([n_out]) and col_scale (one entry
// a column) may be NULL. vec4 != 0 needs d % 4 == 0 and 16-byte aligned x,
// halo and out.
int ebt_halo_spmm(const void* row_ptr, const void* cols, const void* vals,
                  const void* x, const void* halo, int split,
                  const void* row_scale, const void* col_scale, void* out,
                  long long n_out, int d, int vec4, void* stream) {
  if (n_out == 0 || d == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_out * 32 + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* xp = static_cast<const float*>(x);
  const auto* hp = static_cast<const float*>(halo);
  const auto* rsc = static_cast<const float*>(row_scale);
  const auto* csc = static_cast<const float*>(col_scale);
  auto* o = static_cast<float*>(out);
  if (vec4) {
    halo_spmm_kernel<4><<<blocks, kThreads, 0, s>>>(rp, ci, v, xp, hp, split,
                                                    rsc, csc, o, n_out, d);
  } else {
    halo_spmm_kernel<1><<<blocks, kThreads, 0, s>>>(rp, ci, v, xp, hp, split,
                                                    rsc, csc, o, n_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
