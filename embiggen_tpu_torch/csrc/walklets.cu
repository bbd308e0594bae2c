// K12: the Walklets update.
//
// Replaces embiggen_tpu/models/embedders/walklets.py::_WalkletsBase._step
// with WalkletsSkipGram._walklet_updates and WalkletsCBOW._walklet_updates
// (the per-power losses, their gradients and the scatter half of the mean
// updates). For each power p = 1..P (stride s = p, m = L - s pairs a
// direction) the pairs of a walk are (a_t, c_t) = (walk[t], walk[t + s]) in
// both directions: pair q < m has input walk[q] and target walk[q + s], pair
// m + q has input walk[q + s] and target walk[q]. Each pair scores its input
// row (node_embedding[p]) against its target row and the walk's K negatives
// (context_embedding[p]) plus their context_bias[p]:
//   z_0 = in . tgt + b_tgt,  z_k = in . neg_k + b_neg_k,
// with the loss, by mode,
//   skipgram (NCE):             softplus(z_0) - z_0 + sum_k softplus(z_k),
//                               dz_0 = sigmoid(z_0) - 1, dz_k = sigmoid(z_k);
//   cbow (sampled softmax):     -log_softmax(z)[0],
//                               dz_0 = softmax_0 - 1,    dz_k = softmax_k.
// The gradients with respect to the gathered rows are added into sums of
// P * N rows of width sub (row p * N + node), as SkipGramSums holds them:
// the input rows into sums_w (counts_w +1 a pair), the target rows and
// biases into sums_c and sums_b (counts_c +1 a pair), each negative's
// gradient summed over the walk's 2m pairs into sums_c and sums_b once per
// walk slot (counts_c +1 a slot). That is the reference's mean-mode
// `Update`s on the stacked tables; K4's SkipGram combine (csrc/scatter.cu)
// over the flat [P * N, sub] views then applies the per-row mean step for
// all powers at once. The loss of each (walk, power) goes to loss[b * P + p].
//
// What bounds it on the H100: gathered-row bytes and the reductions into the
// sums. A (walk, power) reads 2L + K rows of sub floats at random places and
// adds as many rows into the sums (at the bench's L 64, K 10, sub 32, P 4
// and 32768 walks: 4.6 GB of rows read and reduced), while its flops (about
// 270 K a (walk, power)) are far below the fp32 rate.
//
// What the design does about it:
//   - a block per (walk, power) stages the walk's node ids, its K negatives,
//     and the rows it needs (the input rows and the target rows of its L
//     positions, the K negative rows) in shared memory, 32 columns at a time
//     (rows padded to 36 floats), so each row is read from device memory
//     once however many pairs use it; a sub over 32 takes several column
//     chunks: the logits add up over chunks, then the gradients take a
//     second pass over them;
//   - a thread per logit (pair, k) runs its dot product over the staged
//     columns; a thread per pair turns its K + 1 logits into the loss and
//     the logit gradients, kept in shared memory;
//   - each walk position's gradient rows are summed over its (at most two)
//     pairs in the block before they go out, so a (walk, power) adds one
//     input row and one target row per position and one row per negative:
//     2L + K row reductions rather than 4m + K;
//   - the rows go out as float4 reductions (red.global.add.v4.f32) when
//     sub % 4 == 0 and the tables and sums are 16-byte aligned, else as
//     scalar atomics, so any sub is taken. Float atomics add in no fixed
//     order, so the sums differ from run to run by rounding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;           // columns of a row staged at once
constexpr int kStride = kChunk + 4;  // padded row stride in shared memory

struct Params {
  const float* node_emb;   // [P, N, sub]
  const float* ctx_emb;    // [P, N, sub]
  const float* ctx_bias;   // [P, N]
  const int32_t* walks;    // [B, L]
  const int32_t* negs;     // [B, K]
  float* loss;             // [B, P]
  float* sums_w;           // [P * N, sub]
  float* sums_c;           // [P * N, sub]
  float* sums_b;           // [P * N]
  float* counts_w;         // [P * N]
  float* counts_c;         // [P * N]
  long long n;
  int L, K, sub, power, mode;
  bool vec;
};

// Offsets in 4-byte words of the block's parts in dynamic shared memory.
struct Layout {
  int ids;    // [L + K] the walk's node ids, then its negatives
  int rows;   // [2L + K, kStride] input rows, target rows, negative rows
  int bias;   // [L + K] context biases of the walk's nodes, then negatives
  int z;      // [2(L - 1), K + 1] logits, then their gradients
  int red;    // [kWarps] the loss reduction
  int total;
};

__host__ __device__ inline Layout layout(int L, int K) {
  Layout s;
  s.ids = 0;
  s.rows = ((L + K + 3) / 4) * 4;
  s.bias = s.rows + (2 * L + K) * kStride;
  s.z = s.bias + L + K;
  s.red = s.z + 2 * (L - 1) * (K + 1);
  s.total = s.red + kWarps;
  return s;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Columns c0 .. c0 + cols of the block's 2L + K rows into shared memory;
// columns past `cols` are zeros, so the gradient pass reads whole groups of
// four without bounds tests.
__device__ void stage(const Params& p, float* rows, const int32_t* ids,
                      long long base, int c0, int cols) {
  const int R = 2 * p.L + p.K;
  for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i - r * kChunk;
    float v = 0.f;
    if (c < cols) {
      const float* table = r < p.L ? p.node_emb : p.ctx_emb;
      const long long id = ids[r < p.L ? r : r - p.L];
      v = __ldg(table + (base + id) * p.sub + c0 + c);
    }
    rows[r * kStride + c] = v;
  }
}

// Add v, columns col .. col + 3 of row `row`, into `sums`.
__device__ __forceinline__ void add4(const Params& p, float* sums, long long row,
                                     int col, int cols_left, const float4& v) {
  float* dst = sums + row * p.sub + col;
  if (p.vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4 && i < cols_left; ++i) atomicAdd(dst + i, a[i]);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float g, const float* r) {
  acc.x = fmaf(g, r[0], acc.x);
  acc.y = fmaf(g, r[1], acc.y);
  acc.z = fmaf(g, r[2], acc.z);
  acc.w = fmaf(g, r[3], acc.w);
}

__global__ void __launch_bounds__(kThreads) walklets_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout s = layout(p.L, p.K);
  const long long b = blockIdx.x / p.power;
  const int pw = static_cast<int>(blockIdx.x - b * p.power);
  const int L = p.L, K = p.K, Z = K + 1, tid = threadIdx.x;
  const int stride = pw + 1, m = L - stride, pairs = 2 * m;
  const long long base = static_cast<long long>(pw) * p.n;
  int32_t* ids = reinterpret_cast<int32_t*>(smem + s.ids);
  float* rows = smem + s.rows;
  float* bias = smem + s.bias;
  float* z = smem + s.z;

  for (int i = tid; i < L + K; i += kThreads) {
    ids[i] = i < L ? p.walks[b * L + i] : p.negs[b * K + (i - L)];
  }
  for (int i = tid; i < pairs * Z; i += kThreads) z[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < L + K; i += kThreads) bias[i] = __ldg(p.ctx_bias + base + ids[i]);

  // Logits, summed over column chunks. Pair q's input is position
  // q (q < m) or q - m + s, its target q + s or q - m.
  const int chunks = (p.sub + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * kChunk;
    const int cols = p.sub - c0 < kChunk ? p.sub - c0 : kChunk;
    if (ch > 0) __syncthreads();
    stage(p, rows, ids, base, c0, cols);
    __syncthreads();
    for (int i = tid; i < pairs * Z; i += kThreads) {
      const int q = i / Z, k = i - q * Z;
      const int in = q < m ? q : q - m + stride;
      const int tgt = q < m ? q + stride : q - m;
      const float* x = rows + in * kStride;
      const float* y = rows + (k == 0 ? L + tgt : 2 * L + k - 1) * kStride;
      float acc = 0.f;
      for (int c = 0; c < cols; ++c) acc = fmaf(x[c], y[c], acc);
      z[i] += acc;
    }
  }
  __syncthreads();

  // Each pair's loss and logit gradients, in place of its logits.
  float part = 0.f;
  for (int q = tid; q < pairs; q += kThreads) {
    float* zq = z + q * Z;
    const int tgt = q < m ? q + stride : q - m;
    zq[0] += bias[tgt];
    for (int k = 1; k < Z; ++k) zq[k] += bias[L + k - 1];
    if (p.mode == 0) {
      part += softplus(zq[0]) - zq[0];
      zq[0] = 1.f / (1.f + expf(-zq[0])) - 1.f;
      for (int k = 1; k < Z; ++k) {
        part += softplus(zq[k]);
        zq[k] = 1.f / (1.f + expf(-zq[k]));
      }
    } else {
      float mx = zq[0];
      for (int k = 1; k < Z; ++k) mx = fmaxf(mx, zq[k]);
      float total = 0.f;
      for (int k = 0; k < Z; ++k) total += expf(zq[k] - mx);
      const float lse = mx + logf(total);
      part += lse - zq[0];
      for (int k = 0; k < Z; ++k) zq[k] = expf(zq[k] - lse);
      zq[0] -= 1.f;
    }
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) smem[s.red + tid / 32] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += smem[s.red + w];
    p.loss[b * p.power + pw] = total;
  }

  // Counts and bias gradients: position t is the input of pairs t (t < m)
  // and m + t - s (t >= s), the target of pairs t - s (t >= s) and m + t
  // (t < m); a position in no pair (L < 2s) is left out.
  for (int i = tid; i < L + K; i += kThreads) {
    const long long row = base + ids[i];
    if (i < L) {
      const int cnt = (i < m) + (i >= stride);
      if (cnt == 0) continue;
      float g = 0.f;
      if (i >= stride) g += z[(i - stride) * Z];
      if (i < m) g += z[(m + i) * Z];
      atomicAdd(p.counts_w + row, static_cast<float>(cnt));
      atomicAdd(p.counts_c + row, static_cast<float>(cnt));
      atomicAdd(p.sums_b + row, g);
    } else {
      const int k = i - L + 1;
      float g = 0.f;
      for (int q = 0; q < pairs; ++q) g += z[q * Z + k];
      atomicAdd(p.counts_c + row, 1.f);
      atomicAdd(p.sums_b + row, g);
    }
  }

  // Gradient rows, four columns a thread: input rows of the L positions,
  // target rows of the L positions, then the K negative rows.
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * kChunk;
    const int cols = p.sub - c0 < kChunk ? p.sub - c0 : kChunk;
    if (chunks > 1) {
      __syncthreads();
      stage(p, rows, ids, base, c0, cols);
      __syncthreads();
    }
    const int groups = (cols + 3) / 4;
    for (int i = tid; i < (2 * L + K) * groups; i += kThreads) {
      const int r = i / groups, c = 4 * (i - r * groups);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float* sums;
      int id;
      if (r < 2 * L) {
        const int t = r < L ? r : r - L;
        if ((t < m) + (t >= stride) == 0) continue;
        id = ids[t];
        if (r < L) {
          sums = p.sums_w;
          for (int dir = 0; dir < 2; ++dir) {
            if (dir == 0 ? t >= m : t < stride) continue;
            const int q = dir == 0 ? t : m + t - stride;
            const int tgt = dir == 0 ? t + stride : t - stride;
            const float* zq = z + q * Z;
            fma4(acc, zq[0], rows + (L + tgt) * kStride + c);
            for (int k = 1; k < Z; ++k) fma4(acc, zq[k], rows + (2 * L + k - 1) * kStride + c);
          }
        } else {
          sums = p.sums_c;
          if (t >= stride) fma4(acc, z[(t - stride) * Z], rows + (t - stride) * kStride + c);
          if (t < m) fma4(acc, z[(m + t) * Z], rows + (t + stride) * kStride + c);
        }
      } else {
        const int k = r - 2 * L + 1;
        sums = p.sums_c;
        id = ids[L + k - 1];
        for (int q = 0; q < pairs; ++q) {
          const int in = q < m ? q : q - m + stride;
          fma4(acc, z[q * Z + k], rows + in * kStride + c);
        }
      }
      add4(p, sums, base + id, c0 + c, cols - c, acc);
    }
  }
}

}  // namespace

extern "C" {

// One launch of B * power blocks; see walklets_kernel. mode 0 is SkipGram's
// NCE, 1 CBOW's sampled softmax. Needs L > power (every power has a pair;
// the wrapper checks it) and the block's shared memory, about
// 4 (76 L + 36 K + 2 L K) bytes, within the SM's 227 KB (else the attribute
// call fails and its error is returned).
int ebt_walklets_update(const void* node_emb, const void* ctx_emb, const void* ctx_bias,
                        const void* walks, const void* negs, void* loss, void* sums_w,
                        void* sums_c, void* sums_b, void* counts_w, void* counts_c,
                        long long n, long long B, int L, int K, int sub, int power,
                        int mode, void* stream) {
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(layout(L, K).total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      walklets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(node_emb) | reinterpret_cast<uintptr_t>(ctx_emb) |
      reinterpret_cast<uintptr_t>(sums_w) | reinterpret_cast<uintptr_t>(sums_c);
  Params p{static_cast<const float*>(node_emb), static_cast<const float*>(ctx_emb),
           static_cast<const float*>(ctx_bias), static_cast<const int32_t*>(walks),
           static_cast<const int32_t*>(negs), static_cast<float*>(loss),
           static_cast<float*>(sums_w), static_cast<float*>(sums_c),
           static_cast<float*>(sums_b), static_cast<float*>(counts_w),
           static_cast<float*>(counts_c), n, L, K, sub, power, mode,
           sub % 4 == 0 && align % 16 == 0};
  walklets_kernel<<<static_cast<unsigned>(B * power), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
