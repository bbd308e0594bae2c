// K15a `min_plus_step`: one min-plus relaxation of the multi-source
// distances behind SPINE,
//   out[r, j] = min(dist[r, j], min over the arcs (r -> c) of dist[c, j] + w)
// with w = 1 (hop distances) or the arc's weight.
//
// Replaces one iteration of the lax.scan in
// embiggen_tpu/ops/bfs.py::multi_source_distances (a segment_min of
// dist[cols] + w into the arcs' rows, then a minimum with dist). The
// wrapper launches it once a relaxation, swapping two buffers, and stops
// after the first relaxation whose change flag stays 0, at most max_depth:
// a relaxation that moves nothing moves nothing after it, so that is the
// scan's result after max_depth bodies, bit for bit. Each row pulls from
// the heads of its own out-arcs, as the reference's segment reduction
// does, so a directed graph relaxes forward exactly as there.
//
// Exactness: each candidate is one float add, as in the reference, and a
// minimum does not depend on the order it is taken in, so the distances
// equal the JAX package's bit for bit (unreached entries stay at 1e9,
// where 1e9 + 1 rounds back to 1e9).
//
// What bounds it on the H100: gathered bytes. At SPINE's default D 100 on
// the 20M-arc slice graph a relaxation gathers 20M rows of 400 bytes (8
// GB) against the 0.8 GB that a pass over dist in and out must move; two
// operations per gathered float. A 400-byte row starts at any 16-byte
// offset, so it spans 13 or 14 sectors of 32 bytes: about 8.6 GB move.
//
// What the design does about it: a warp a row, each lane holding 4
// columns (float4 where D and alignment allow, scalar otherwise), so a
// warp reads a whole gathered row per arc in 16-byte pieces. The row's arc
// ids (and weights) are read 32 at a time in one coalesced load and
// broadcast by shuffles, and kUnroll arcs' rows are loaded before any is
// compared, so each lane has kUnroll independent 16-byte gathers in
// flight. Rows are independent: no atomics. When `changed` is not NULL,
// the block stores 1 there once (__syncthreads_or) if any of its rows'
// minima moved, so the wrapper can tell after which relaxation nothing
// changed without a pass of its own, for the cost of one store a block.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

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
__global__ void __launch_bounds__(kThreads) min_plus_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ weights, const float* __restrict__ dist,
    float* __restrict__ out, int32_t* __restrict__ changed, int64_t n_rows,
    int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5);
  bool moved = false;
  if (row < n_rows) {  // uniform across the warp
    const int32_t start = row_ptr[row], end = row_ptr[row + 1];
    for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
      const int c = c0 + lane * VEC;
      const bool active = c < d;
      float own[VEC], acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) own[k] = 0.0f;
      if (active) Lanes<VEC>::load(dist + row * d + c, own);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = own[k];
      for (int32_t base = start; base < end; base += 32) {
        int32_t col = 0;
        float w = 1.0f;
        if (base + lane < end) {
          col = __ldg(cols + base + lane);
          if (weights != nullptr) w = __ldg(weights + base + lane);
        }
        const int count = min(32, end - base);
        for (int j = 0; j < count; j += kUnroll) {
          float v[kUnroll][VEC], wj[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int64_t cj = __shfl_sync(kFull, col, (j + u) & 31);
            wj[u] = __shfl_sync(kFull, w, (j + u) & 31);
            if (active && j + u < count) {
              Lanes<VEC>::load(dist + cj * d + c, v[u]);
            } else {
#pragma unroll
              for (int k = 0; k < VEC; ++k) v[u][k] = INFINITY;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float cand = v[u][k] + wj[u];
              if (cand < acc[k]) acc[k] = cand;
            }
          }
        }
      }
      if (active) {
        Lanes<VEC>::store(out + row * d + c, acc);
#pragma unroll
        for (int k = 0; k < VEC; ++k) moved |= acc[k] < own[k];
      }
    }
  }
  if (changed != nullptr && __syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
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
  const unsigned blocks = static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
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
