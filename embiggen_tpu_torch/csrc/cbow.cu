// K11: the CBOW step.
//
// Replaces embiggen_tpu/models/embedders/walk_based.py::CBOW._gathered_grads
// (and _st_clip) and the scatter half of _mean_scatter as
// CBOW._apply_table_grads uses it. For every walk b and every centre l in
// [w, L - w), the hidden row is the mean of the input rows (node_embedding)
// at the positions m with 0 < |m - l| <= w, h_l = sum_m x_m / (2w); it is
// scored against the centre's output row and the walk's K negatives' output
// rows, each logit with its output_bias, clipped at +-clip for the forward
// value; the loss is the sampled softmax's -log p(centre) times the centre
// weight. Its closed-form gradients with a straight-through clip, with
// p = softmax(clip(z)) and G_lj = cw_l (p_lj - [j == 0]):
//   g_out[l] = G_l0 h_l,  g_ob[l] = G_l0,
//   g_neg[k] = sum_l G_lk h_l,  g_nb[k] = sum_l G_lk,
//   g_h[l] = G_l0 o_l + sum_k G_lk n_k,  g_in[m] = sum_l g_h[l] / (2w)
// over the centres l with 0 < |m - l| <= w. Each row is added into the
// persistent sums at its node id (SkipGram's `SkipGramSums`: sums_w for
// node_embedding, sums_c and sums_b for output_embedding and output_bias)
// and counted (counts_w and counts_c: +1 per walk position, centre or not;
// counts_c: +1 per negative), so that K4's SkipGram combine
// (csrc/scatter.cu) applies CBOW's per-row mean step unchanged.
//
// What bounds it on the H100: gathered-row bytes and the reductions into
// the sums, as for K3. A walk reads L + (L - 2w) + K rows of D floats at
// random places (about 65 KB at L 64, K 10, D 128) and adds as many rows
// into the sums; its flops (the window sums, (L - 2w)(K + 1) dot products
// and their gradients, about 0.6 MFLOP) are far below the fp32 rate.
//
// The design, simple first: one block per walk. The walk's rows are read
// once into shared memory (float4 when D % 4 == 0 and the tables are 16-byte
// aligned, rows padded by 4 floats so the lanes' rows fall in different
// banks); the hidden rows, the logits, the softmax gradients G and the
// hidden gradients (in place over the output rows) stay there; the rows go
// out as float4 reductions (red.global.add.v4.f32) into the sums, scalar
// atomics when D % 4 != 0. No [B, L, D] gradient reaches device memory.
// Float atomics add in no fixed order, so sums differ from run to run by
// rounding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {
  int D4;     // float4 columns of a row: ceil(D / 4)
  int Dp;     // row stride: 4 D4 + 4
  int in;     // [L] input rows of the walk
  int out;    // [C] output rows of the centres; their hidden gradients later
  int neg;    // [K] output rows of the negatives
  int hid;    // [C] hidden rows
  int G;      // [C, K + 1] logits, then their loss gradients
  int out_b;  // [C] output biases of the centres
  int neg_b;  // [K] output biases of the negatives
  int cw;     // [C] centre weights
  int ids;    // [L + K] int32 node ids: the walk, then the negatives
  int loss;   // [kWarps] per-warp loss sums
  int total;
};

__host__ __device__ Layout layout(int L, int K, int D, int window) {
  const int C = L - 2 * window;
  Layout s;
  s.D4 = (D + 3) / 4;
  s.Dp = 4 * s.D4 + 4;
  s.in = 0;
  s.out = s.in + L * s.Dp;
  s.neg = s.out + C * s.Dp;
  s.hid = s.neg + K * s.Dp;
  s.G = s.hid + C * s.Dp;
  s.out_b = s.G + C * (K + 1);
  s.neg_b = s.out_b + C;
  s.cw = s.neg_b + K;
  s.ids = s.cw + C;
  s.loss = s.ids + L + K;
  s.total = s.loss + kWarps;
  return s;
}

struct Params {
  const float* node_emb;
  const float* out_emb;
  const float* out_bias;
  const int32_t* walks;
  const int32_t* negs;
  const float* center_w;  // [B, L] or null
  float* loss;            // [B]
  float* sums_w;
  float* sums_c;
  float* sums_b;
  float* counts_w;
  float* counts_c;
  int L, K, D, window;
  bool vec;
  float clip;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float g, const float4& v) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Add v (columns 4 c4 .. 4 c4 + 3 of a row) into row `id` of `sums`.
__device__ __forceinline__ void add_row4(const Params& p, float* sums, int64_t id, int c4,
                                         const float4& v) {
  float* dst = sums + id * p.D + 4 * c4;
  if (p.vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4 && 4 * c4 + i < p.D; ++i) atomicAdd(dst + i, a[i]);
  }
}

// Columns 4 c4 .. 4 c4 + 3 of a table row, zero past D.
__device__ __forceinline__ float4 load_cols(const Params& p, const float* row, int c4) {
  if (p.vec) return ld4(row + 4 * c4);
  float a[4];
  for (int i = 0; i < 4; ++i) a[i] = 4 * c4 + i < p.D ? row[4 * c4 + i] : 0.f;
  return make_float4(a[0], a[1], a[2], a[3]);
}

__global__ void __launch_bounds__(kThreads) cbow_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, K = p.K, D = p.D, w = p.window, C = L - 2 * w, K1 = K + 1;
  const Layout s = layout(L, K, D, w);
  const int D4 = s.D4, Dp = s.Dp, tid = threadIdx.x;
  const int64_t walk = blockIdx.x;
  const float inv_2w = 1.f / static_cast<float>(2 * w);
  int32_t* ids = reinterpret_cast<int32_t*>(smem + s.ids);
  for (int i = tid; i < L + K; i += kThreads) {
    ids[i] = i < L ? p.walks[walk * L + i] : p.negs[walk * K + i - L];
  }
  __syncthreads();
  for (int i = tid; i < C + K; i += kThreads) {
    if (i < C) {
      smem[s.out_b + i] = p.out_bias[ids[w + i]];
      smem[s.cw + i] = p.center_w == nullptr ? 1.f : p.center_w[walk * L + w + i];
    } else {
      smem[s.neg_b + i - C] = p.out_bias[ids[L + i - C]];
    }
  }
  // The rows: the walk's input rows, the centres' output rows, the
  // negatives' output rows.
  for (int q = tid; q < (L + C + K) * D4; q += kThreads) {
    const int r = q / D4, c4 = q - r * D4;
    const float* src;
    if (r < L) {
      src = p.node_emb + static_cast<int64_t>(ids[r]) * D;
    } else if (r < L + C) {
      src = p.out_emb + static_cast<int64_t>(ids[w + r - L]) * D;
    } else {
      src = p.out_emb + static_cast<int64_t>(ids[L + r - L - C]) * D;
    }
    *reinterpret_cast<float4*>(smem + s.in + r * Dp + 4 * c4) = load_cols(p, src, c4);
  }
  __syncthreads();
  // Hidden rows: the window means of the input rows.
  for (int q = tid; q < C * D4; q += kThreads) {
    const int i = q / D4, c4 = q - i * D4, l = w + i;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int o = 1; o <= w; ++o) {
      add4(acc, ld4(smem + s.in + (l - o) * Dp + 4 * c4));
      add4(acc, ld4(smem + s.in + (l + o) * Dp + 4 * c4));
    }
    *reinterpret_cast<float4*>(smem + s.hid + i * Dp + 4 * c4) =
        make_float4(acc.x * inv_2w, acc.y * inv_2w, acc.z * inv_2w, acc.w * inv_2w);
  }
  __syncthreads();
  // Logits: centre i against its output row (j = 0) and the negatives.
  for (int q = tid; q < C * K1; q += kThreads) {
    const int i = q / K1, j = q - i * K1;
    const float* h = smem + s.hid + i * Dp;
    const float* o = j == 0 ? smem + s.out + i * Dp : smem + s.neg + (j - 1) * Dp;
    float acc = 0.f;
    for (int c4 = 0; c4 < D4; ++c4) {
      const float4 a = ld4(h + 4 * c4), b = ld4(o + 4 * c4);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
    smem[s.G + q] = acc + (j == 0 ? smem[s.out_b + i] : smem[s.neg_b + j - 1]);
  }
  __syncthreads();
  // Sampled softmax per centre, on the clipped logits; the straight-through
  // clip passes the gradient unscaled.
  float my_loss = 0.f;
  for (int i = tid; i < C; i += kThreads) {
    float* g = smem + s.G + i * K1;
    float m = -p.clip;  // every clipped logit is at least this
    for (int j = 0; j < K1; ++j) {
      g[j] = fminf(fmaxf(g[j], -p.clip), p.clip);
      m = fmaxf(m, g[j]);
    }
    float sum = 0.f;
    for (int j = 0; j < K1; ++j) sum += expf(g[j] - m);
    const float lse = m + logf(sum), cw = smem[s.cw + i];
    my_loss += (lse - g[0]) * cw;
    for (int j = 0; j < K1; ++j) g[j] = cw * (expf(g[j] - lse) - (j == 0 ? 1.f : 0.f));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) my_loss += __shfl_xor_sync(0xffffffffu, my_loss, o);
  if ((tid & 31) == 0) smem[s.loss + (tid >> 5)] = my_loss;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < kWarps; ++i) total += smem[s.loss + i];
    p.loss[walk] = total;
  }
  // Output and negative rows' gradients; the hidden gradients in place over
  // the output rows (each thread reads and writes only its own columns).
  const float* G = smem + s.G;
  for (int q = tid; q < (C + K) * D4; q += kThreads) {
    const int r = q / D4, c4 = q - r * D4;
    if (r < C) {
      const float* gi = G + r * K1;
      float* o = smem + s.out + r * Dp + 4 * c4;
      const float4 h = ld4(smem + s.hid + r * Dp + 4 * c4);
      add_row4(p, p.sums_c, ids[w + r], c4,
               make_float4(gi[0] * h.x, gi[0] * h.y, gi[0] * h.z, gi[0] * h.w));
      float4 gh = make_float4(0.f, 0.f, 0.f, 0.f);
      fma4(gh, gi[0], ld4(o));
      for (int k = 0; k < K; ++k) fma4(gh, gi[k + 1], ld4(smem + s.neg + k * Dp + 4 * c4));
      *reinterpret_cast<float4*>(o) = gh;
    } else {
      const int k = r - C;
      float4 gn = make_float4(0.f, 0.f, 0.f, 0.f);
      float gnb = 0.f;
      for (int i = 0; i < C; ++i) {
        const float g = G[i * K1 + k + 1];
        fma4(gn, g, ld4(smem + s.hid + i * Dp + 4 * c4));
        gnb += g;
      }
      const int64_t id = ids[L + k];
      add_row4(p, p.sums_c, id, c4, gn);
      if (c4 == 0) {
        atomicAdd(p.sums_b + id, gnb);
        atomicAdd(p.counts_c + id, 1.f);
      }
    }
  }
  for (int m = tid; m < L; m += kThreads) {
    const int64_t id = ids[m];
    if (m >= w && m < L - w) atomicAdd(p.sums_b + id, G[(m - w) * K1]);
    atomicAdd(p.counts_w + id, 1.f);
    atomicAdd(p.counts_c + id, 1.f);
  }
  __syncthreads();
  // Input rows' gradients: the hidden gradients of the centres whose window
  // holds the position, over 2w.
  for (int q = tid; q < L * D4; q += kThreads) {
    const int m = q / D4, c4 = q - m * D4;
    const int lo = m - w > w ? m - w : w;
    const int hi = m + w < L - w - 1 ? m + w : L - w - 1;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    bool any = false;
    for (int l = lo; l <= hi; ++l) {
      if (l == m) continue;
      add4(acc, ld4(smem + s.out + (l - w) * Dp + 4 * c4));
      any = true;
    }
    if (any) {
      add_row4(p, p.sums_w, ids[m], c4,
               make_float4(acc.x * inv_2w, acc.y * inv_2w, acc.z * inv_2w, acc.w * inv_2w));
    }
  }
}

}  // namespace

extern "C" {

// One block of kThreads per walk; a shape whose walk does not fit a block's
// shared memory is an invalid-value error, returned like a launch error.
int ebt_cbow_update(const void* node_emb, const void* out_emb, const void* out_bias,
                    const void* walks, const void* negs, const void* center_w, void* loss,
                    void* sums_w, void* sums_c, void* sums_b, void* counts_w,
                    void* counts_c, long long B, int L, int K, int D, int window,
                    float clip, void* stream) {
  if (B == 0) return 0;
  if (window < 1 || L <= 2 * window || K < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(layout(L, K, D, window).total) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cbow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const float*>(node_emb), static_cast<const float*>(out_emb),
           static_cast<const float*>(out_bias), static_cast<const int32_t*>(walks),
           static_cast<const int32_t*>(negs), static_cast<const float*>(center_w),
           static_cast<float*>(loss), static_cast<float*>(sums_w), static_cast<float*>(sums_c),
           static_cast<float*>(sums_b), static_cast<float*>(counts_w),
           static_cast<float*>(counts_c), L, K, D, window, false, clip};
  // float4 loads and float4 atomics need every row 16-byte aligned.
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(node_emb) | reinterpret_cast<uintptr_t>(out_emb) |
      reinterpret_cast<uintptr_t>(sums_w) | reinterpret_cast<uintptr_t>(sums_c);
  p.vec = D % 4 == 0 && align % 16 == 0;
  cbow_kernel<<<static_cast<unsigned>(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
