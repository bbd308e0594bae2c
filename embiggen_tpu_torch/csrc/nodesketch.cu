// K18 `sketch_race_step`: one round of NodeSketch's min-hash race. For
// each row r and column j, over the arcs (r -> c):
//   cand  = fma(race[c, j], inv_decay, noise[c, j])
//   best  = min over the arcs of cand (+inf for a row without arcs)
//   win   = the smallest sketch[c, j] among the arcs whose cand == best
//   race_out[r, j]   = min(race[r, j], best)
//   sketch_out[r, j] = best < race[r, j] ? win : sketch[r, j]
//
// Replaces one iteration of the lax.scan in
// embiggen_tpu/models/embedders/factorization.py::NodeSketch._fit_transform.run
// (a gather of race[dst] / decay + noise[dst] over the arcs, a segment_min
// into the arcs' sources, then a second segment_min of the sketch ids of
// the arcs that reached it). The wrapper launches it once per round,
// swapping two pairs of buffers, as the scan runs `iterations` bodies.
//
// Exactness. XLA folds the reference's `race[dst] / decay + noise[dst]`,
// with decay a constant of the jitted function, into one fused
// multiply-add with float32(1) / float32(decay); the kernel forms the same
// fma, so each candidate is the reference's bit for bit. The reference
// counts an arc a winner when cand <= best + 1e-30; best + 1e-30 rounds to
// best for any best above 2e-23, and no Exp(1) draw of float32 gives a
// nonzero candidate below that at any decay under 1e15, so a winner is an
// arc whose cand equals best. A minimum and a minimum over the tied ids do
// not depend on the order they are taken in, so the kernel keeps the pair
// (best, win) in registers in one pass where the reference makes two, and
// the result equals the JAX package's exactly.
//
// What bounds it on the H100: gathered bytes. At the reference's D 100 on
// the 20M-arc slice graph a round gathers 20M rows of race, noise and
// sketch, 1,200 bytes an arc (24 GB), against the 2.1 GB that a pass over
// the distinct rows in and out must move; an fma and two compares per
// gathered element.
//
// What the design does about it: a warp per row, each lane holding 4
// columns (16-byte loads of each gathered row where D and alignment allow,
// scalar otherwise; D above 128 (32) takes several passes of the row), the
// row's arcs read 32 at a time and broadcast by shuffles, as K7 does. Rows
// are independent: no atomics, and the result does not depend on the
// schedule.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
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
  __device__ static void load(const int32_t* p, int32_t* v) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store(int32_t* p, const int32_t* v) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Lanes<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void load(const int32_t* p, int32_t* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
  __device__ static void store(int32_t* p, const int32_t* v) { *p = v[0]; }
};

template <int VEC>
__global__ void sketch_race_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ race, const int32_t* __restrict__ sketch,
    const float* __restrict__ noise, float* __restrict__ race_out,
    int32_t* __restrict__ sketch_out, int64_t n_rows, int d, float inv_decay) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int32_t begin = row_ptr[row];
  const int32_t end = row_ptr[row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < d;
    float best[VEC], r[VEC], e[VEC];
    int32_t win[VEC], s[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      best[k] = INFINITY;
      win[k] = INT_MAX;
    }
    for (int32_t a0 = begin; a0 < end; a0 += 32) {
      const int n = min(32, end - a0);
      const int32_t mine = lane < n ? __ldg(cols + a0 + lane) : 0;
      for (int j = 0; j < n; ++j) {
        const int64_t base = static_cast<int64_t>(__shfl_sync(kFull, mine, j)) * d + c;
        if (!active) continue;
        Lanes<VEC>::load(race + base, r);
        Lanes<VEC>::load(noise + base, e);
        Lanes<VEC>::load(sketch + base, s);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float cand = __fmaf_rn(r[k], inv_decay, e[k]);
          if (cand < best[k]) {
            best[k] = cand;
            win[k] = s[k];
          } else if (cand == best[k] && s[k] < win[k]) {
            win[k] = s[k];
          }
        }
      }
    }
    if (!active) continue;
    const int64_t own = row * d + c;
    Lanes<VEC>::load(race + own, r);
    Lanes<VEC>::load(sketch + own, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (best[k] < r[k]) {
        r[k] = best[k];
        s[k] = win[k];
      }
    }
    Lanes<VEC>::store(race_out + own, r);
    Lanes<VEC>::store(sketch_out + own, s);
  }
}

}  // namespace

extern "C" {

// vec4 != 0 needs d % 4 == 0 and 16-byte aligned race, sketch, noise,
// race_out and sketch_out.
int ebt_sketch_race_step(const void* row_ptr, const void* cols, const void* race,
                         const void* sketch, const void* noise, void* race_out,
                         void* sketch_out, long long n_rows, int d, float inv_decay,
                         int vec4, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const long long threads = n_rows * 32;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* ra = static_cast<const float*>(race);
  const auto* sk = static_cast<const int32_t*>(sketch);
  const auto* no = static_cast<const float*>(noise);
  auto* ro = static_cast<float*>(race_out);
  auto* so = static_cast<int32_t*>(sketch_out);
  if (vec4) {
    sketch_race_kernel<4><<<blocks, kThreads, 0, s>>>(rp, ci, ra, sk, no, ro, so, n_rows, d,
                                                       inv_decay);
  } else {
    sketch_race_kernel<1><<<blocks, kThreads, 0, s>>>(rp, ci, ra, sk, no, ro, so, n_rows, d,
                                                       inv_decay);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
