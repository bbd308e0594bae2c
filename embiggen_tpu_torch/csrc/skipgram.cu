// K3: the banded NCE step of SkipGram.
//
// Replaces embiggen_tpu/models/embedders/walk_based.py::SkipGram._gathered_grads
// (and _st_clip) and the scatter half of _mean_scatter as
// SkipGram._apply_table_grads uses it. For every walk b, every centre l in
// [w, L - w) is scored against the contexts j with 0 < |j - l| <= w and
// against the walk's K negatives; scores take context_bias, are clipped at
// +-clip for the forward value, and the loss is softplus(s) - s / (2w) for a
// context and softplus(s) for a negative, each times the centre weight. The
// gradients are the closed form of that loss with a straight-through clip:
//   d loss / d s = sigmoid(clip(s)) - 1 / (2w)   (context)
//   d loss / d s = sigmoid(clip(s))              (negative)
// taken with respect to the gathered rows:
//   g_w[l] = sum_j g_lj c_j + sum_k g_lk n_k,   g_c[j] = sum_l g_lj w_l,
//   g_b[j] = sum_l g_lj,   g_neg[k] = sum_l g_lk w_l,   g_nb[k] = sum_l g_lk.
// Each row is added into persistent sums at its node id (sums_w, sums_c
// [N, D]; sums_b [N]) and counted (counts_w: +1 per walk position, centre or
// not; counts_c: +1 per walk position and per negative), so that K4's
// combine (csrc/scatter.cu) applies the per-row mean step. No gradient row
// reaches device memory.
//
// What bounds it on the H100: gathered-row bytes and the reductions into
// the sums. A walk reads 2 L + K rows of D
// floats at random places (about 70 KB at L 64, K 10, D 128) and adds as
// many rows into the sums; its 6 D (2w + K)(L - 2w) flops (0.8 MFLOP) are
// far below the fp32 rate. The design, for every L > 2w, K >= 1 and D:
//   - persistent blocks (two per SM where they fit) loop over walks;
//   - a ring of shared-memory stages, two where two blocks of two still fit
//     an SM (the harness's D 64, L 16), else one (the flagship's D 128,
//     L 64, where the other block's work hides the copies): walk
//     i + stages - 1's rows are copied with cp.async (16 bytes a copy when
//     D % 4 == 0 and the rows are 16-byte aligned, else 4) while walk i
//     computes;
//   - scores: each thread owns one centre and up to kMaxPartners partners of
//     its band and negatives, and loops over D with float4 reads of shared
//     memory (rows padded by 4 floats, so the lanes' different rows fall in
//     different banks); each thread computes the clip, sigmoid and softplus
//     of its own scores, with no shuffle;
//   - gradients: a thread per (kRows walk positions or negatives, 4 d),
//     which reads each shared row once for its kRows outputs; the score
//     gradients sit in a zero-padded band and the walk's rows between zero
//     rows, so its loops run without bounds tests;
//   - the rows go out as float4 reductions (red.global.add.v4.f32) into the
//     sums, scalar atomics when D % 4 != 0. Float atomics add in no fixed
//     order, so sums differ from run to run by rounding.
// With EBT_PHASE_CLOCK defined, thread 0 of each block adds up clock64()
// cycles per phase (gather wait, scores, gradients with the reductions, and
// the total) into clocks[block, 0..3].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPartners = 8;  // scores per thread in the score pass
constexpr int kRows = 2;         // outputs per thread in the gradient pass
// The persistent grid: kBlocksPerSm blocks per SM where they fit, each with
// the deepest ring of row copies, up to kStages stages, at which they still
// fit. Chosen by measurement at the flagship and harness shapes.
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 2;

// Offsets in floats of one stage's parts, and of the parts shared by the
// stages, in dynamic shared memory. The walk's two row regions have zero
// rows before (w) and after (w + kRows - 1) them, and the band of score
// gradients has zero rows and columns around it, so that the gradient
// pass's loops over a window need no bounds tests: a term outside the band
// is 0 times a finite row.
struct Layout {
  int D4;     // float4 columns of a row: ceil(D / 4)
  int Dp;     // row stride: 4 D4 + 4 (the 4 spread rows over banks)
  int rows;   // rows of a padded walk region: L + 2w + kRows - 1
  int w_rows; // node_embedding row 0 of the walk
  int c_rows; // context_embedding row 0 of the walk
  int n_rows; // [K] the negatives' context_embedding rows
  int bias;   // [L + K] context biases of the walk rows, then the negatives
  int cw;     // [L] centre weights
  int ids;    // [L + K] int32 node ids: the walk, then the negatives
  int stage;  // floats per stage (a multiple of 4)
  int band;   // row 0 of A [rows, Wa]: A[l][o + kRows - 1] = d loss / d score
              // of centre l with context l - w + o; 0 off the band
  int Wa;     // A's width: 2w + 2 kRows - 1
  int g_ng;   // [L + kRows - 1, K] of the negatives; 0 but for centres
  int loss;   // [kWarps] per-warp loss sums
  int total;
};

__host__ __device__ Layout layout(int L, int K, int D, int window, int stages) {
  Layout s;
  s.D4 = (D + 3) / 4;
  s.Dp = 4 * s.D4 + 4;
  s.rows = L + 2 * window + kRows - 1;
  s.w_rows = window * s.Dp;
  s.c_rows = (s.rows + window) * s.Dp;
  s.n_rows = 2 * s.rows * s.Dp;
  s.bias = s.n_rows + K * s.Dp;
  s.cw = s.bias + L + K;
  s.ids = s.cw + L;
  s.stage = (s.ids + L + K + 3) / 4 * 4;
  s.Wa = 2 * window + 2 * kRows - 1;
  s.band = stages * s.stage + window * s.Wa;
  s.g_ng = stages * s.stage + s.rows * s.Wa;
  s.loss = s.g_ng + (L + kRows - 1) * K;
  s.total = s.loss + kWarps;
  return s;
}

struct Params {
  const float* node_emb;
  const float* ctx_emb;
  const float* ctx_bias;
  const int32_t* walks;
  const int32_t* negs;
  const float* center_w;  // [B, L] or null
  float* loss;            // [B]
  float* sums_w;
  float* sums_c;
  float* sums_b;
  float* counts_w;
  float* counts_c;
  long long* clocks;
  int64_t B;
  int L, K, D, window, stages, partners;
  bool vec;
  float clip;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float g, const float4& v) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
}

// Node id of shared row r: the walk's rows twice (node, then context
// table), then the negatives.
__device__ __forceinline__ int64_t row_id(const Params& p, int64_t walk, int r) {
  if (r < 2 * p.L) {
    return p.walks[walk * p.L + (r < p.L ? r : r - p.L)];
  }
  return p.negs[walk * p.K + r - 2 * p.L];
}

// Offset in a stage of shared row r (numbered as in row_id).
__device__ __forceinline__ int row_offset(const Layout& s, int L, int r) {
  return r < L ? s.w_rows + r * s.Dp
               : (r < 2 * L ? s.c_rows + (r - L) * s.Dp : s.n_rows + (r - 2 * L) * s.Dp);
}

// Start the copies of one walk's ids, centre weights, biases and rows into
// `st`.
__device__ void issue_loads(const Params& p, const Layout& s, int64_t walk,
                            float* st) {
  const int L = p.L, K = p.K, D = p.D, tid = threadIdx.x;
  int32_t* ids = reinterpret_cast<int32_t*>(st + s.ids);
  for (int i = tid; i < L + K; i += kThreads) {
    const int32_t* src = i < L ? p.walks + walk * L + i : p.negs + walk * K + (i - L);
    cp_async4(ids + i, src);
    cp_async4(st + s.bias + i, p.ctx_bias + row_id(p, walk, i < L ? i : i + L));
  }
  if (p.center_w != nullptr) {
    for (int i = tid; i < L; i += kThreads) {
      cp_async4(st + s.cw + i, p.center_w + walk * L + i);
    }
  }
  const int rows = 2 * L + K;
  if (p.vec) {
#pragma unroll 4
    for (int q = tid; q < rows * s.D4; q += kThreads) {
      const int r = q / s.D4, c = q - r * s.D4;
      cp_async16(st + row_offset(s, L, r) + 4 * c,
                 (r < L ? p.node_emb : p.ctx_emb) + row_id(p, walk, r) * D + 4 * c);
    }
  } else {
    for (int q = tid; q < rows * D; q += kThreads) {
      const int r = q / D, c = q - r * D;
      cp_async4(st + row_offset(s, L, r) + c,
                (r < L ? p.node_emb : p.ctx_emb) + row_id(p, walk, r) * D + c);
    }
  }
}

// Add v (columns 4 c4 .. 4 c4 + 3 of a row) into row `id` of `sums`.
__device__ __forceinline__ void add_row4(const Params& p, float* sums, int64_t id,
                                         int c4, const float4& v) {
  float* dst = sums + id * p.D + 4 * c4;
  if (p.vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4 && 4 * c4 + i < p.D; ++i) atomicAdd(dst + i, a[i]);
  }
}

// Scores of one walk (stage `st`) and their loss gradients into the band A
// and g_ng; returns this thread's share of the walk's loss.
__device__ float score_pass(const Params& p, const Layout& s, const float* st,
                            float* A, float* g_ng) {
  const int L = p.L, K = p.K, w = p.window, tid = threadIdx.x;
  const int C = L - 2 * w, R = 2 * w + K, P = p.partners;
  const int G = (R + P - 1) / P;
  const float inv_2w = 1.f / static_cast<float>(2 * w);
  const float* c_bias = st + s.bias;
  const float* cw = st + s.cw;
  float my_loss = 0.f;
  // Consecutive threads take consecutive centres of one partner group: their
  // centre and context rows are consecutive rows, their negatives shared.
  for (int item = tid; item < C * G; item += kThreads) {
    const int g = item / C, l = item - g * C + w;
    int off[kMaxPartners];
#pragma unroll
    for (int i = 0; i < kMaxPartners; ++i) {
      const int r = g * P + i;
      off[i] = i >= P || r >= R ? -1
               : r < 2 * w     ? s.c_rows + (l - w + (r < w ? r : r + 1)) * s.Dp
                               : s.n_rows + (r - 2 * w) * s.Dp;
    }
    float acc[kMaxPartners];
#pragma unroll
    for (int i = 0; i < kMaxPartners; ++i) acc[i] = 0.f;
    const float* centre = st + s.w_rows + l * s.Dp;
    for (int c4 = 0; c4 < s.D4; ++c4) {
      const float4 a = ld4(centre + 4 * c4);
#pragma unroll
      for (int i = 0; i < kMaxPartners; ++i) {
        if (off[i] >= 0) {
          const float4 b = ld4(st + off[i] + 4 * c4);
          acc[i] = fmaf(a.x, b.x, acc[i]);
          acc[i] = fmaf(a.y, b.y, acc[i]);
          acc[i] = fmaf(a.z, b.z, acc[i]);
          acc[i] = fmaf(a.w, b.w, acc[i]);
        }
      }
    }
    const float weight = cw[l];
#pragma unroll
    for (int i = 0; i < kMaxPartners; ++i) {
      if (off[i] < 0) continue;
      const int r = g * P + i;
      const bool positive = r < 2 * w;
      const float sc = acc[i] + (positive ? c_bias[l - w + (r < w ? r : r + 1)]
                                          : c_bias[L + r - 2 * w]);
      // Straight-through clip: the forward value is clipped, the gradient
      // passes through unscaled.
      const float c = fminf(fmaxf(sc, -p.clip), p.clip);
      const float sig = 1.f / (1.f + expf(-c));
      const float softplus = fmaxf(c, 0.f) + log1pf(expf(-fabsf(c)));
      if (positive) {
        A[l * s.Wa + (r < w ? r : r + 1) + kRows - 1] = (sig - inv_2w) * weight;
        my_loss += (softplus - c * inv_2w) * weight;
      } else {
        g_ng[l * K + r - 2 * w] = sig * weight;
        my_loss += softplus * weight;
      }
    }
  }
  return my_loss;
}

// Gradient rows of one walk, added into the sums.
__device__ void gradient_pass(const Params& p, const Layout& s, const float* st,
                              const float* A, const float* g_ng) {
  const int L = p.L, K = p.K, w = p.window, tid = threadIdx.x, D4 = s.D4;
  const int C = L - 2 * w, Wa = s.Wa;
  const int32_t* ids = reinterpret_cast<const int32_t*>(st + s.ids);
  const float* w_rows = st + s.w_rows;
  const float* c_rows = st + s.c_rows;
  const float* n_rows = st + s.n_rows;
  const int row_groups = (L + kRows - 1) / kRows;
  const int neg_groups = (K + kRows - 1) / kRows;
  for (int item = tid; item < (row_groups + neg_groups) * D4; item += kThreads) {
    const int grp = item / D4, c4 = item - grp * D4;
    if (grp < row_groups) {
      // Walk positions l0 .. l0 + kRows - 1: as centres (g_w, against the
      // contexts j = l0 - w + u and the negatives) and as contexts of the
      // centres j (g_c, g_b). A is 0 off the band and for non-centres, and
      // the rows outside the walk are 0, so no term needs a test.
      const int l0 = grp * kRows;
      float4 gw[kRows], gc[kRows];
      float gb[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        gw[a] = gc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
        gb[a] = 0.f;
      }
      for (int u = 0; u < 2 * w + kRows; ++u) {
        const int j = l0 - w + u;
        const float4 cj = ld4(c_rows + j * s.Dp + 4 * c4);
        const float4 wj = ld4(w_rows + j * s.Dp + 4 * c4);
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          fma4(gw[a], A[(l0 + a) * Wa + u - a + kRows - 1], cj);
          const float g = A[j * Wa + a + 2 * w - u + kRows - 1];
          fma4(gc[a], g, wj);
          gb[a] += g;
        }
      }
      for (int k = 0; k < K; ++k) {
        const float4 nk = ld4(n_rows + k * s.Dp + 4 * c4);
#pragma unroll
        for (int a = 0; a < kRows; ++a) fma4(gw[a], g_ng[(l0 + a) * K + k], nk);
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int l = l0 + a;
        if (l >= L) break;
        const int64_t id = ids[l];
        if (l >= w && l < L - w) add_row4(p, p.sums_w, id, c4, gw[a]);
        add_row4(p, p.sums_c, id, c4, gc[a]);
        if (c4 == 0) {
          atomicAdd(p.sums_b + id, gb[a]);
          atomicAdd(p.counts_w + id, 1.f);
          atomicAdd(p.counts_c + id, 1.f);
        }
      }
    } else {
      // Negatives k0 .. k0 + kRows - 1 (a slot past K reads the next row's
      // finite gradients and is dropped).
      const int k0 = (grp - row_groups) * kRows;
      float4 gn[kRows];
      float gnb[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        gn[a] = make_float4(0.f, 0.f, 0.f, 0.f);
        gnb[a] = 0.f;
      }
      for (int l = w; l < w + C; ++l) {
        const float4 wl = ld4(w_rows + l * s.Dp + 4 * c4);
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const float g = g_ng[l * K + k0 + a];
          fma4(gn[a], g, wl);
          gnb[a] += g;
        }
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int k = k0 + a;
        if (k >= K) break;
        const int64_t id = ids[L + k];
        add_row4(p, p.sums_c, id, c4, gn[a]);
        if (c4 == 0) {
          atomicAdd(p.sums_b + id, gnb[a]);
          atomicAdd(p.counts_c + id, 1.f);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) skipgram_nce_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout s = layout(p.L, p.K, p.D, p.window, p.stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* A = smem + s.band;
  float* g_ng = smem + s.g_ng;
  float* warp_loss = smem + s.loss;
  // Everything starts at 0: the rows around the walk, the padding columns
  // (the float4 reads run over them) and A and g_ng off the band stay so,
  // as neither the copies nor the score pass write them; the centre weights
  // stay 1 when there are none.
  for (int i = tid; i < s.total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  if (p.center_w == nullptr) {
    for (int st = 0; st < p.stages; ++st) {
      for (int i = tid; i < p.L; i += kThreads) smem[st * s.stage + s.cw + i] = 1.f;
    }
  }
#ifdef EBT_PHASE_CLOCK
  long long cycles[4] = {0, 0, 0, 0};
#endif
  for (int i = 0; i < p.stages - 1; ++i) {
    const int64_t ahead = blockIdx.x + static_cast<int64_t>(i) * gridDim.x;
    if (ahead < p.B) issue_loads(p, s, ahead, smem + i * s.stage);
    cp_async_commit();
  }
  int it = 0;
  for (int64_t walk = blockIdx.x; walk < p.B; walk += gridDim.x, ++it) {
#ifdef EBT_PHASE_CLOCK
    const long long c0 = clock64();
#endif
    const int64_t ahead = walk + static_cast<int64_t>(p.stages - 1) * gridDim.x;
    if (ahead < p.B) {
      issue_loads(p, s, ahead, smem + ((it + p.stages - 1) % p.stages) * s.stage);
    }
    cp_async_commit();
    cp_async_wait(p.stages - 1);
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c1 = clock64();
#endif
    const float* st = smem + (it % p.stages) * s.stage;
    float my_loss = score_pass(p, s, st, A, g_ng);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) my_loss += __shfl_xor_sync(0xffffffffu, my_loss, o);
    if (lane == 0) warp_loss[warp] = my_loss;
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c2 = clock64();
#endif
    if (tid == 0) {
      float total = 0.f;
      for (int i = 0; i < kWarps; ++i) total += warp_loss[i];
      p.loss[walk] = total;
    }
    gradient_pass(p, s, st, A, g_ng);
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c3 = clock64();
    cycles[0] += c1 - c0;
    cycles[1] += c2 - c1;
    cycles[2] += c3 - c2;
    cycles[3] += c3 - c0;
#endif
  }
  cp_async_wait(0);
#ifdef EBT_PHASE_CLOCK
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) p.clocks[4 * static_cast<int64_t>(blockIdx.x) + i] = cycles[i];
  }
#endif
}

}  // namespace

extern "C" {

// The grid is min(B, kBlocksPerSm x SMs) persistent blocks, with the
// deepest ring of at most kStages stages at which kBlocksPerSm blocks still
// fit an SM; when even one stage does not let them fit, one stage and as
// many blocks as fit. A shape whose one stage does not fit a block fails,
// and that error is returned like a launch error.
int ebt_skipgram_nce(const void* node_emb, const void* ctx_emb,
                     const void* ctx_bias, const void* walks, const void* negs,
                     const void* center_w, void* loss, void* sums_w, void* sums_c,
                     void* sums_b, void* counts_w, void* counts_c, void* clocks,
                     long long B, int L, int K, int D, int window, float clip, void* stream) {
  if (B == 0) return 0;
  const auto kernel = skipgram_nce_kernel;
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = 0, stages = kStages;
  for (; stages >= 1; --stages) {
    const size_t bytes = static_cast<size_t>(layout(L, K, D, window, stages).total) * sizeof(float);
    fit = 0;
    if (bytes <= static_cast<size_t>(smem_max)) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (fit >= kBlocksPerSm || stages == 1) break;
  }
  if (fit == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(layout(L, K, D, window, stages).total) * sizeof(float);
  const int C = L - 2 * window, R = 2 * window + K;
  int partners = (C * R + kThreads - 1) / kThreads;
  partners = partners < 1 ? 1 : (partners > kMaxPartners ? kMaxPartners : partners);
  Params p{static_cast<const float*>(node_emb), static_cast<const float*>(ctx_emb),
           static_cast<const float*>(ctx_bias), static_cast<const int32_t*>(walks),
           static_cast<const int32_t*>(negs), static_cast<const float*>(center_w),
           static_cast<float*>(loss), static_cast<float*>(sums_w), static_cast<float*>(sums_c),
           static_cast<float*>(sums_b), static_cast<float*>(counts_w),
           static_cast<float*>(counts_c), static_cast<long long*>(clocks), B, L, K, D,
           window, stages, partners, false, clip};
  // 16-byte copies and float4 atomics need every row 16-byte aligned.
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(node_emb) | reinterpret_cast<uintptr_t>(ctx_emb) |
      reinterpret_cast<uintptr_t>(sums_w) | reinterpret_cast<uintptr_t>(sums_c);
  p.vec = D % 4 == 0 && align % 16 == 0;
  const int per_sm = kBlocksPerSm < fit ? kBlocksPerSm : fit;
  const long long grid =
      B < static_cast<long long>(per_sm) * sms ? B : static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
