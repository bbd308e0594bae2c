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
// the arcs that reached it). The wrapper launches two kernels a round:
// `sketch_candidates_kernel` forms every node's candidates once, and
// `sketch_race_kernel` takes the minima over the arcs; it swaps two pairs
// of buffers, as the scan runs `iterations` bodies.
//
// Exactness. XLA folds the reference's `race[dst] / decay + noise[dst]`,
// with decay a constant of the jitted function, into one fused
// multiply-add with float32(1) / float32(decay); the candidate pass forms
// the same fma, so each candidate is the reference's bit for bit. The
// reference counts an arc a winner when cand <= best + 1e-30; best + 1e-30
// rounds to best for any best above 2e-23, and no Exp(1) draw of float32
// gives a nonzero candidate below that at any decay under 1e15, so a
// winner is an arc whose cand equals best. Floats compare with < and ==,
// so +0.0 and -0.0 tie as there. A minimum and a minimum over the tied ids
// do not depend on the order they are taken in, so the race kernel keeps
// (best, the head that gave it) in registers in one pass where the
// reference makes two, and the result equals the JAX package's exactly.
//
// What bounds it on the H100: gathered bytes. A candidate depends on the
// arc's head alone, so forming it per node moves 12 bytes an (node,
// column) once (1.2 GB at D 100 on the slice graph's 1M nodes), and the
// race then gathers 4 bytes an (arc, column): 8 GB a round on the 20M
// arcs, where gathering race, noise and sketch per arc took 24 GB. A
// sketch id is read once for each column whose race the round lowers, the
// winning head's, and for a tie in such a column the tied heads' ids.
//
// What the design does about it: the candidates go to a workspace whose
// rows start on 32-byte sectors (a pitch of D rounded up to 8 floats, so a
// D-100 row is 13 whole sectors where a 400-byte row at a 16-byte offset
// spans 13 or 14). The race kernel runs a warp a row, each lane holding 4
// columns of a gathered candidate row in one 16-byte load, the row's arc
// ids read 32 at a time and broadcast by shuffles, kUnroll gathers in
// flight a lane, keeping (best, head) and a bit for a tie; a warp with a
// tie in a column its round lowers walks the row's arcs a second time for
// the tied heads' ids; D above 128 takes several passes of the row. Rows
// are independent: no atomics, and the result does not depend on the
// schedule.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Rows of d values at row pitch d, read and written 4 columns at a time:
// one 16-byte access when VEC (d % 4 == 0 and the base 16-byte aligned),
// else scalar accesses masked at d.
template <bool VEC, typename T>
__device__ __forceinline__ void load4(const T* p, int valid, T* v) {
  if (VEC) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const T* q = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = q[k];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < valid) v[k] = __ldg(p + k);
    }
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store4(T* p, int valid, const T* v) {
  if (VEC) {
    uint4 t;
    T* q = reinterpret_cast<T*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = v[k];
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < valid) p[k] = v[k];
    }
  }
}

// cand[r, c] = fma(race[r, c], inv_decay, noise[r, c]) for c < d, at row
// pitch `pitch` (a multiple of 4); the padding columns are written 0 and
// never read. A thread per 4 columns.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) sketch_candidates_kernel(
    const float* __restrict__ race, const float* __restrict__ noise,
    float* __restrict__ cand, int64_t n_rows, int d, int pitch, float inv_decay) {
  const int quads = pitch / 4;
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t row = t / quads;
  if (row >= n_rows) return;
  const int c = static_cast<int>(t - row * quads) * 4;
  const int valid = min(4, d - c);
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, e[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[4];
  if (valid > 0) {
    load4<VEC>(race + row * d + c, valid, r);
    load4<VEC>(noise + row * d + c, valid, e);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = k < valid ? __fmaf_rn(r[k], inv_decay, e[k]) : 0.0f;
  *reinterpret_cast<float4*>(cand + row * pitch + c) = make_float4(o[0], o[1], o[2], o[3]);
}

// One round over the candidates at row pitch `pitch` (a multiple of 4,
// 16-byte aligned rows). VEC: race, sketch and the outputs are read and
// written 16 bytes at a time (d % 4 == 0, aligned). At most 64 registers a
// thread, so four blocks fit an SM (measured a little faster than the
// compiler's own choice, 77 without VEC).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4) sketch_race_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
    const float* __restrict__ cand, int pitch, const float* __restrict__ race,
    const int32_t* __restrict__ sketch, float* __restrict__ race_out,
    int32_t* __restrict__ sketch_out, int64_t n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int32_t begin = row_ptr[row], end = row_ptr[row + 1];
  for (int c0 = 0; c0 < d; c0 += 128) {
    const int c = c0 + lane * 4;
    const int valid = min(4, d - c);
    const bool active = valid > 0;
    // head[k] names the arc that gave best[k] once best[k] < +inf, the only
    // case in which it is read. tied bit k: another arc's candidate equals
    // best[k] (or the same head's again, through a repeated arc).
    float best[4];
    int32_t head[4];
    unsigned tied = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      best[k] = INFINITY;
      head[k] = 0;
    }
    for (int32_t a0 = begin; a0 < end; a0 += 32) {
      const int n = min(32, end - a0);
      const int32_t mine = lane < n ? __ldg(cols + a0 + lane) : 0;
      for (int j = 0; j < n; j += kUnroll) {
        float4 v[kUnroll];
        int32_t hj[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          hj[u] = __shfl_sync(kFull, mine, (j + u) & 31);
          if (active && j + u < n) {
            v[u] = __ldg(reinterpret_cast<const float4*>(
                cand + static_cast<int64_t>(hj[u]) * pitch + c));
          }
        }
        if (!active) continue;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u >= n) break;
          const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (x[k] < best[k]) {
              best[k] = x[k];
              head[k] = hj[u];
              tied &= ~(1u << k);
            } else if (x[k] == best[k]) {
              tied |= 1u << k;
            }
          }
        }
      }
    }
    const int64_t own = row * d + c;
    float r[4];
    int32_t s[4], win[4];
    unsigned improved = 0;
    if (active) {
      load4<VEC>(race + own, valid, r);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < valid && best[k] < r[k]) improved |= 1u << k;
        win[k] = INT_MAX;
      }
      tied &= improved;
    }
    // A tie only matters where the round lowers the race: then the least
    // sketch id among the tied heads wins. Rare on continuous draws, so a
    // warp with such a column walks its arcs again, reading the ids of the
    // heads that tie, 4 bytes each.
    if (__any_sync(kFull, tied != 0)) {
      for (int32_t a0 = begin; a0 < end; a0 += 32) {
        const int n = min(32, end - a0);
        const int32_t mine = lane < n ? __ldg(cols + a0 + lane) : 0;
        for (int j = 0; j < n; ++j) {
          const int32_t hj = __shfl_sync(kFull, mine, j);
          if (tied == 0) continue;
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              cand + static_cast<int64_t>(hj) * pitch + c));
          const float x[4] = {v.x, v.y, v.z, v.w};
          unsigned match = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) match |= (x[k] == best[k] ? 1u : 0u) << k;
          match &= tied;
          if (match == 0) continue;
          int32_t ids[4];
          load4<VEC>(sketch + static_cast<int64_t>(hj) * d + c, valid, ids);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (match >> k & 1u) win[k] = min(win[k], ids[k]);
          }
        }
      }
    }
    if (!active) continue;
    load4<VEC>(sketch + own, valid, s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (improved >> k & 1u) {
        r[k] = best[k];
        s[k] = (tied >> k & 1u) ? win[k]
                                : __ldg(sketch + static_cast<int64_t>(head[k]) * d + c + k);
      }
    }
    store4<VEC>(race_out + own, valid, r);
    store4<VEC>(sketch_out + own, valid, s);
  }
}

}  // namespace

extern "C" {

// cand: [n_rows, pitch] float32, pitch a multiple of 4 at least d,
// 16-byte aligned. vec4 != 0 needs d % 4 == 0 and 16-byte aligned race and
// noise.
int ebt_sketch_candidates(const void* race, const void* noise, void* cand, long long n_rows,
                          int d, int pitch, float inv_decay, int vec4, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const long long threads = n_rows * (pitch / 4);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ra = static_cast<const float*>(race);
  const auto* no = static_cast<const float*>(noise);
  auto* ca = static_cast<float*>(cand);
  if (vec4) {
    sketch_candidates_kernel<true><<<blocks, kThreads, 0, s>>>(ra, no, ca, n_rows, d, pitch,
                                                                inv_decay);
  } else {
    sketch_candidates_kernel<false><<<blocks, kThreads, 0, s>>>(ra, no, ca, n_rows, d, pitch,
                                                                 inv_decay);
  }
  return static_cast<int>(cudaGetLastError());
}

// cand as ebt_sketch_candidates writes it. vec4 != 0 needs d % 4 == 0 and
// 16-byte aligned race, sketch, race_out and sketch_out.
int ebt_sketch_race_step(const void* row_ptr, const void* cols, const void* cand, int pitch,
                         const void* race, const void* sketch, void* race_out,
                         void* sketch_out, long long n_rows, int d, int vec4, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* ca = static_cast<const float*>(cand);
  const auto* ra = static_cast<const float*>(race);
  const auto* sk = static_cast<const int32_t*>(sketch);
  auto* ro = static_cast<float*>(race_out);
  auto* so = static_cast<int32_t*>(sketch_out);
  if (vec4) {
    sketch_race_kernel<true><<<blocks, kThreads, 0, s>>>(rp, ci, ca, pitch, ra, sk, ro, so,
                                                          n_rows, d);
  } else {
    sketch_race_kernel<false><<<blocks, kThreads, 0, s>>>(rp, ci, ca, pitch, ra, sk, ro, so,
                                                           n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
