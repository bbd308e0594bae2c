// K15a `min_plus_step`: one min-plus relaxation of the multi-source
// distances behind SPINE,
//   out[r, j] = min(dist[r, j], min over the arcs (r -> c) of dist[c, j] + w)
// with w = 1 (hop distances) or the arc's weight.
//
// Replaces one iteration of the lax.scan in
// embiggen_tpu/ops/bfs.py::multi_source_distances (a segment_min of
// dist[cols] + w into the arcs' rows, then a minimum with dist). The
// wrapper launches it max_depth times, swapping two buffers, as the scan
// runs max_depth bodies. Each row pulls from the heads of its own out-arcs,
// as the reference's segment reduction does, so a directed graph relaxes
// forward exactly as there.
//
// Exactness: each candidate is one float add, as in the reference, and a
// minimum does not depend on the order it is taken in, so the distances
// equal the JAX package's bit for bit (unreached entries stay at 1e9,
// where 1e9 + 1 rounds back to 1e9).
//
// What bounds it on the H100: gathered bytes. At SPINE's default D 100 on
// the 20M-arc slice graph an iteration gathers 20M rows of 400 bytes (8
// GB) against the 0.8 GB that a pass over dist in and out must move; two
// operations per gathered float.
//
// What the design does about it: a thread per (row, 4 columns), so the
// threads of a row read neighbouring 16-byte pieces of each gathered row
// (float4 where D and alignment allow, scalar otherwise); each thread
// walks its row's arcs, whose column index is one broadcast load for the
// row's threads. Rows are independent: no atomics. When `changed` is not
// NULL, a thread whose minimum moved stores 1 there (every writer stores
// the same value), so the wrapper can tell after which iteration nothing
// changed without a pass of its own.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Lanes;
template <>
struct Lanes<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Lanes<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <int VEC>
__global__ void min_plus_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ weights, const float* __restrict__ dist,
    float* __restrict__ out, int32_t* __restrict__ changed, int64_t n_rows,
    int d) {
  const int per_row = d / VEC;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / per_row;
  if (row >= n_rows) return;
  const int64_t c = (t - row * per_row) * VEC;
  float acc[VEC], v[VEC];
  Lanes<VEC>::load(dist + row * d + c, acc);
  bool moved = false;
  const int32_t end = row_ptr[row + 1];
  for (int32_t a = row_ptr[row]; a < end; ++a) {
    const int64_t col = __ldg(cols + a);
    const float w = weights != nullptr ? __ldg(weights + a) : 1.0f;
    Lanes<VEC>::load(dist + col * d + c, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float cand = v[k] + w;
      if (cand < acc[k]) {
        acc[k] = cand;
        moved = true;
      }
    }
  }
  Lanes<VEC>::store(out + row * d + c, acc);
  if (moved && changed != nullptr) *changed = 1;
}

}  // namespace

extern "C" {

// weights ([n_arcs]) and changed (one int32) may be NULL. vec4 != 0 needs
// d % 4 == 0 and 16-byte aligned dist and out.
int ebt_min_plus_step(const void* row_ptr, const void* cols,
                      const void* weights, const void* dist, void* out,
                      void* changed, long long n_rows, int d, int vec4,
                      void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const int vec = vec4 ? 4 : 1;
  const long long threads = n_rows * (d / vec);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* w = static_cast<const float*>(weights);
  const auto* in = static_cast<const float*>(dist);
  auto* o = static_cast<float*>(out);
  auto* ch = static_cast<int32_t*>(changed);
  if (vec4) {
    min_plus_kernel<4><<<blocks, kThreads, 0, s>>>(rp, ci, w, in, o, ch, n_rows, d);
  } else {
    min_plus_kernel<1><<<blocks, kThreads, 0, s>>>(rp, ci, w, in, o, ch, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
