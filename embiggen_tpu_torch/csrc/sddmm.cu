// K20a `sddmm`: out[e] = a[rows[e]] . b[cols[e]], the sampled dense-dense
// product (per-edge scores).
//
// Replaces embiggen_tpu/ops/spmm.py::sddmm (a jnp gather of both rows, a
// product and a sum over D). Its gradient stays plain torch (two
// index_add_ passes in `ops/spmm.py`), as the JAX function has no backward
// of its own.
//
// What bounds it on the H100: gathered bytes. At the slice shape (20M arcs,
// D = 128 f32, tables of 1M rows) the ids are 160 MB, the output 80 MB, and
// each table's distinct rows 512 MB, about 1.3 GB in all, 0.38 ms at the
// card's 3.35 TB/s; but each edge reads two random 512-byte rows, 20 GB of
// row reads against L2 and HBM, so the kernel runs at the random-gather
// rate (K7's) and not at the bound. Two FLOPs per gathered float pair.
//
// What the design does about it: a group of G lanes an edge (G = 32 at
// D = 128, fewer for narrow rows, so a warp scores 32 / G edges at once),
// each lane holding 4 columns: one 16-byte load per lane and table, so a
// group reads whole rows in coalesced 512-byte pieces; a warp's edge ids
// come in one coalesced load a tile of 32 edges, and each lane keeps the
// gathers of 4 edges in flight (on an H100 the first version, a group an
// edge with its ids loaded before its rows, took 6.59 ms at the slice
// shape against cuSPARSE's 4.21 in the same run); then a shuffle
// reduction inside the group. A float4 load needs 16-byte aligned rows:
// the launcher takes the scalar route for D % 4 != 0 or a table at an odd
// storage offset. Edges are independent: no atomics, and the result does
// not depend on the schedule. Row offsets are 64-bit (rows * D passes 2^31
// at 1M rows of 4096 floats).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kUnroll = 4;

template <int VEC>
__device__ __forceinline__ float dot_piece(const float* a, const float* b);

template <>
__device__ __forceinline__ float dot_piece<4>(const float* a, const float* b) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(a));
  const float4 y = __ldg(reinterpret_cast<const float4*>(b));
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

template <>
__device__ __forceinline__ float dot_piece<1>(const float* a, const float* b) {
  return __ldg(a) * __ldg(b);
}

// A warp takes a tile of 32 consecutive edges: lane l loads edge t0 + l's
// two ids (one coalesced load each), then the warp's 32 / G groups of G
// lanes take the tile's edges in turns, kUnroll turns at once. A lane
// issues the loads of its pieces of all kUnroll edges before it adds any,
// so each lane keeps 2 kUnroll independent gathers in flight and no gather
// waits on an id load. Each group reduces its sums by xor shuffles, and
// each edge's score moves to the lane of its place in the tile, so the 32
// scores leave in one coalesced store. The tile's lanes past the last edge
// read row 0 (inside the tables) and store nothing.
template <typename Id, int VEC, int G>
__global__ void sddmm_kernel(const Id* __restrict__ rows,
                             const Id* __restrict__ cols,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ out, int64_t n_edges, int d) {
  constexpr int kGroups = 32 / G;  // edges a turn
  static_assert(G % kUnroll == 0, "a tile's G turns run kUnroll at a time");
  const int lane = threadIdx.x & 31;
  const int group = lane / G, glane = lane % G;
  const int64_t t0 =
      ((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5) * 32;
  if (t0 >= n_edges) return;  // uniform across the warp
  const int64_t e = t0 + lane;
  const bool real = e < n_edges;
  const int64_t my_row = real ? static_cast<int64_t>(rows[e]) : 0;
  const int64_t my_col = real ? static_cast<int64_t>(cols[e]) : 0;
  float result = 0.0f;
  for (int k0 = 0; k0 < G; k0 += kUnroll) {
    int64_t r[kUnroll], c[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int place = (k0 + u) * kGroups + group;
      r[u] = __shfl_sync(kFull, my_row, place) * d;
      c[u] = __shfl_sync(kFull, my_col, place) * d;
      acc[u] = 0.0f;
    }
    for (int p = glane * VEC; p < d; p += G * VEC) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] += dot_piece<VEC>(a + r[u] + p, b + c[u] + p);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float sum = acc[u];
#pragma unroll
      for (int m = G / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(kFull, sum, m, G);
      // Lane l's edge is place l: turn l / kGroups, group l % kGroups.
      const float mine = __shfl_sync(kFull, sum, (lane % kGroups) * G);
      if (lane / kGroups == k0 + u) result = mine;
    }
  }
  if (real) out[e] = result;
}

template <typename Id, int VEC, int G>
int launch(const void* rows, const void* cols, const void* a, const void* b,
           void* out, long long n, int d, cudaStream_t s) {
  const long long threads = (n + 31) / 32 * 32;  // a warp a tile of 32 edges
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  sddmm_kernel<Id, VEC, G><<<blocks, kThreads, 0, s>>>(
      static_cast<const Id*>(rows), static_cast<const Id*>(cols),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

// The group width: the lanes that one row's VEC-wide pieces fill, a power
// of two from 4 to 32.
template <typename Id, int VEC>
int dispatch(const void* rows, const void* cols, const void* a, const void* b,
             void* out, long long n, int d, cudaStream_t s) {
  const int pieces = (d + VEC - 1) / VEC;
  if (pieces <= 4) return launch<Id, VEC, 4>(rows, cols, a, b, out, n, d, s);
  if (pieces <= 8) return launch<Id, VEC, 8>(rows, cols, a, b, out, n, d, s);
  if (pieces <= 16) return launch<Id, VEC, 16>(rows, cols, a, b, out, n, d, s);
  return launch<Id, VEC, 32>(rows, cols, a, b, out, n, d, s);
}

}  // namespace

extern "C" {

// rows and cols: n ids each, int64 when ids64 != 0, else int32. vec4 != 0
// needs d % 4 == 0 and 16-byte aligned a and b.
int ebt_sddmm(const void* rows, const void* cols, const void* a, const void* b,
              void* out, long long n, int d, int ids64, int vec4, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (ids64) {
    return vec4 ? dispatch<int64_t, 4>(rows, cols, a, b, out, n, d, s)
                : dispatch<int64_t, 1>(rows, cols, a, b, out, n, d, s);
  }
  return vec4 ? dispatch<int32_t, 4>(rows, cols, a, b, out, n, d, s)
              : dispatch<int32_t, 1>(rows, cols, a, b, out, n, d, s);
}

}  // extern "C"
