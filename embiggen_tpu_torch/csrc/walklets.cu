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
// and 32768 walks: 2.3 GB of rows read and as many reduced), while its
// flops (about 70 K multiply-adds a (walk, power) in this form) are far
// below the fp32 rate. So the work on chip has to stay under the
// reductions' time: few shared-memory loads a multiply-add, no serial tail,
// and the next rows in flight while this item computes.
//
// What the design does about it:
//   - persistent blocks, four an SM, loop over the (walk, power) items: an
//     item's biases and 2L + K rows are copied with cp.async (16 bytes a
//     copy when sub % 4 == 0 and the rows are aligned, else 4) while the
//     SM's other blocks compute. Its node ids were copied an item earlier,
//     so that no row's copy waits on the load of its id (waiting on them
//     took a fifth of the block's time). A second stage, to copy the next
//     item's rows while this one computes, measured slower: it leaves room
//     for three blocks an SM, not four. Rows are staged 32 columns at a
//     time, padded to 36 floats so that a warp's float4 reads of different
//     rows fall in different banks. A sub over 32 takes several column
//     chunks, each staged twice: once for the logits, once for the
//     gradients;
//   - a walk position is the input of at most two pairs, and both score it
//     against the same negatives, so the negative logits are taken once a
//     position: z_k(t) = in_t . neg_k, an [L, K] product, not [2m, K];
//   - kG = 2 lanes own a position, each holding half of its input row's
//     float4 columns in registers. They score it against the K negatives
//     (broadcast reads: every lane reads the same row), four rows at a time
//     so that four sums are in flight, and its two targets, then the same
//     lanes turn the position's logits into the loss, the two
//     pairs' target-logit gradients and the position's summed negative-logit
//     gradients C[t][k] (NCE's dz_k is the same in both pairs, and its
//     softplus and sigmoid share one exp; the softmax's pairs share
//     exp(z_k - max)), with no second pass over the staged rows;
//   - gradients: the same lanes form the position's input-row gradient
//     (sum_k C[t][k] neg_k plus its targets' terms) and its target-row
//     gradient (the two pairs that end at it) in float4 registers; the
//     negative rows' gradients, sum_t C[t][k] in_t, are split over pairs of
//     negatives and float4 columns, each sum over positions shared by
//     several lanes and closed with shuffles, so no K-row tail sets the
//     block's length;
//   - a (walk, power) adds one input row and one target row per position
//     and one row per negative: 2L + K row reductions. The rows are written
//     to shared memory first and go out a row at a time, neighbouring lanes
//     on neighbouring pieces, so that one instruction's reductions cover
//     whole 128-byte rows (a row held by two lanes took four requests of 32
//     bytes). They are float4 reductions (red.global.add.v4.f32) when sub %
//     4 == 0 and the tables and sums are 16-byte aligned, else scalar
//     atomics, so any sub is taken. Float atomics add in no fixed order, so
//     the sums differ from run to run by rounding;
//   - the counts are a walk's, not a (walk, power)'s: position t is in
//     2 - [t < s] - [t >= L - s] pairs of stride s, and the negatives serve
//     every power. So only a walk's first power adds its walk counts (each
//     position's node, the end positions per power, the negatives' nodes)
//     into a zeroed scratch, and a second, dense launch forms every power's
//     counts from them: scalar atomics, which cost as much as the rows'
//     float4 reductions, fall from P (2L + K) to L + K + P (P + 1) a walk,
//     besides the L + K bias sums a (walk, power).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 2;                 // lanes per walk position
constexpr int kChunk = 32;            // columns of a row staged at once
constexpr int kC4 = kChunk / 4;       // float4 columns of a chunk
constexpr int kJ = kC4 / kG;          // float4 columns a lane holds
constexpr int kStride = kChunk + 4;   // padded row stride in shared memory
constexpr int kIdSlots = 2;           // ids of the unit computed, of the next

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
  float* occ;              // [N] zeros: walk positions per node
  float* neg_occ;          // [N] zeros: negative slots per node
  float* ends;             // [P, N] zeros: walk positions within p + 1 of
                           // either end, per power p
  long long n, items;      // items = B * P
  int L, K, sub, power, mode, chunks;
  bool vec;
};

// Offsets in 4-byte words of the block's parts in dynamic shared memory.
struct Layout {
  int rows;   // [2L + K, kStride] input rows, target rows, negative rows
  int bias;   // [L + K] context biases of the walk's nodes, then negatives
  int ids;    // [kIdSlots, L + K] int32 node ids of two units in a row: the
              // walk, then its negatives
  int z;      // [L, zs] per position: the K negative logits (then C[t][k]),
              // the forward and the backward pair's target logit
  int zs;
  int dz;     // [2, L] target-logit gradients of position t's forward pair
              // (t -> t + s) at t, of its backward pair (t -> t - s) at L + t
  int red;    // [kWarps] the loss reduction
  int out;    // [2L + K, kStride] the gradient rows of one column chunk:
              // input rows, target rows, negative rows
  int total;
};

__host__ __device__ inline Layout layout(int L, int K) {
  Layout s;
  s.rows = 0;
  s.bias = (2 * L + K) * kStride;
  s.ids = s.bias + L + K;
  s.zs = (K + 2) | 1;
  s.z = s.ids + kIdSlots * (L + K);
  s.dz = s.z + L * s.zs;
  s.red = s.dz + 2 * L;
  s.out = (s.red + kWarps + 3) / 4 * 4;
  s.total = s.out + (2 * L + K) * kStride;
  return s;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

// Wait until all of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float g, const float4& v) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
}

__device__ __forceinline__ float4 shfl_xor4(unsigned mask, const float4& v, int o) {
  return make_float4(__shfl_xor_sync(mask, v.x, o), __shfl_xor_sync(mask, v.y, o),
                     __shfl_xor_sync(mask, v.z, o), __shfl_xor_sync(mask, v.w, o));
}

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The (walk, power) of an item, and the first row of its power's tables.
struct Item {
  long long walk;
  int power, stride, m;
  long long base;
};

__device__ __forceinline__ Item item_of(const Params& p, long long item) {
  Item it;
  it.walk = item / p.power;
  it.power = static_cast<int>(item - it.walk * p.power);
  it.stride = it.power + 1;
  it.m = p.L - it.stride;
  it.base = static_cast<long long>(it.power) * p.n;
  return it;
}

// Start the copy of one item's node ids (the walk, then its negatives)
// into `ids`.
__device__ void issue_ids(const Params& p, long long item, int32_t* ids) {
  const Item it = item_of(p, item);
  for (int i = threadIdx.x; i < p.L + p.K; i += kThreads) {
    cp_async4(ids + i, i < p.L ? p.walks + it.walk * p.L + i
                               : p.negs + it.walk * p.K + (i - p.L));
  }
}

// Start the copies of one item's biases and the columns of column chunk
// `chunk` of its 2L + K rows into `st`, at the node ids in `ids` (already
// in shared memory, so no copy waits on an id's load). Columns of a partial
// last float4 past the row's end are set to 0 (the float4 reads run over
// them); the words past that stay 0 from the kernel's start.
__device__ void issue_rows(const Params& p, const Layout& s, long long item, int chunk,
                           const int32_t* ids, float* st) {
  const Item it = item_of(p, item);
  const int L = p.L, K = p.K, R = 2 * L + K, tid = threadIdx.x;
  for (int i = tid; i < L + K; i += kThreads) {
    cp_async4(st + s.bias + i, p.ctx_bias + it.base + ids[i]);
  }
  const int c0 = chunk * kChunk;
  const int cols = min(kChunk, p.sub - c0);
  float* rows = st + s.rows;
  if (p.vec) {
    const int c4n = cols / 4;
#pragma unroll 4
    for (int q = tid; q < R * c4n; q += kThreads) {
      const int r = q / c4n, c = q - r * c4n;
      const long long id = ids[r < L ? r : r - L];
      const float* table = r < L ? p.node_emb : p.ctx_emb;
      cp_async16(rows + r * kStride + 4 * c, table + (it.base + id) * p.sub + c0 + 4 * c);
    }
  } else {
    for (int q = tid; q < R * cols; q += kThreads) {
      const int r = q / cols, c = q - r * cols;
      const long long id = ids[r < L ? r : r - L];
      const float* table = r < L ? p.node_emb : p.ctx_emb;
      cp_async4(rows + r * kStride + c, table + (it.base + id) * p.sub + c0 + c);
    }
    const int pad = (4 - cols % 4) % 4;
    for (int q = tid; q < R * pad; q += kThreads) {
      rows[(q / pad) * kStride + cols + q % pad] = 0.f;
    }
  }
}

// The two lanes of a position.
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << ((threadIdx.x & 31) & ~1);
}

// The dot products of this lane's columns x of a position's input row
// with the four rows y (those `use` names), summed over the position's
// two lanes.
__device__ __forceinline__ void dot_tile(const float4 (&x)[kJ], const float* const (&y)[4],
                                         const bool (&use)[4], int c4n, float (&acc)[4]) {
  const int h = threadIdx.x % kG;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c4 = h + kG * j;
    if (c4 >= c4n) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (use[r]) acc[r] = dot4(x[j], ld4(y[r] + 4 * c4), acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += __shfl_xor_sync(pair_mask(), acc[r], 1);
}

// Logits of one column chunk, added into z: per position t (input of a
// pair), its K negative logits and its forward and backward target logits.
__device__ void logit_pass(const Params& p, const Layout& s, const float* st, const Item& it,
                           int chunk, float* z) {
  const int L = p.L, K = p.K, h = threadIdx.x % kG;
  const int cols = min(kChunk, p.sub - chunk * kChunk), c4n = (cols + 3) / 4;
  const float* in_rows = st + s.rows;
  const float* tgt_rows = in_rows + L * kStride;
  const float* neg_rows = in_rows + 2 * L * kStride;
  for (int t = threadIdx.x / kG; t < L; t += kThreads / kG) {
    const bool fwd = t < it.m, bwd = t >= it.stride;
    if (!fwd && !bwd) continue;
    float4 x[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c4 = h + kG * j;
      x[j] = c4 < c4n ? ld4(in_rows + t * kStride + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float* zt = z + t * s.zs;
    // Four negatives at a time, then the two targets: independent sums.
    for (int k0 = 0; k0 < K; k0 += 4) {
      const float* y[4];
      bool use[4];
      float acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        use[r] = k0 + r < K;
        y[r] = neg_rows + (use[r] ? k0 + r : 0) * kStride;
      }
      dot_tile(x, y, use, c4n, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (h == 0 && use[r]) zt[k0 + r] = chunk == 0 ? acc[r] : zt[k0 + r] + acc[r];
      }
    }
    const float* y[4] = {tgt_rows + (fwd ? t + it.stride : 0) * kStride,
                         tgt_rows + (bwd ? t - it.stride : 0) * kStride, tgt_rows, tgt_rows};
    const bool use[4] = {fwd, bwd, false, false};
    float acc[4];
    dot_tile(x, y, use, c4n, acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (h == 0 && use[r]) zt[K + r] = chunk == 0 ? acc[r] : zt[K + r] + acc[r];
    }
  }
}

// The loss of each position's pairs, their target-logit gradients (into dz)
// and the position's negative-logit gradients summed over its pairs (into
// z, in place of the logits; 0 for a position in no pair). Returns this
// thread's share of the item's loss.
__device__ float dz_pass(const Params& p, const Layout& s, const float* st, const Item& it,
                         float* z, float* dz) {
  const int L = p.L, K = p.K, h = threadIdx.x % kG;
  const float* bias = st + s.bias;
  const unsigned mask = pair_mask();
  float part = 0.f;
  for (int t = threadIdx.x / kG; t < L; t += kThreads / kG) {
    const bool fwd = t < it.m, bwd = t >= it.stride;
    float* zt = z + t * s.zs;
    if (!fwd && !bwd) {
      for (int k = h; k < K; k += kG) zt[k] = 0.f;
      continue;
    }
    if (p.mode == 0) {
      const float cnt = static_cast<float>(fwd + bwd);
      for (int k = h; k < K; k += kG) {
        // softplus and sigmoid from one exp(-|v|).
        const float v = zt[k] + bias[L + k];
        const float e = expf(-fabsf(v)), inv = 1.f / (1.f + e);
        part += cnt * (fmaxf(v, 0.f) + log1pf(e));
        zt[k] = cnt * (v >= 0.f ? inv : e * inv);
      }
      if (h == 0) {
        for (int dir = 0; dir < 2; ++dir) {
          if (dir == 0 ? !fwd : !bwd) continue;
          const float v = zt[K + dir] + bias[dir == 0 ? t + it.stride : t - it.stride];
          part += softplus(v) - v;
          dz[dir * L + t] = sigmoid(v) - 1.f;
        }
      }
    } else {
      // Both pairs share the negatives' exp(z_k - mx); each pair's
      // log-sum-exp adds its own target logit.
      float mx = -INFINITY;
      for (int k = h; k < K; k += kG) mx = fmaxf(mx, zt[k] + bias[L + k]);
      mx = fmaxf(mx, __shfl_xor_sync(mask, mx, 1));
      float e = 0.f;
      for (int k = h; k < K; k += kG) {
        const float v = expf(zt[k] + bias[L + k] - mx);
        zt[k] = v;
        e += v;
      }
      e += __shfl_xor_sync(mask, e, 1);
      float scale = 0.f;
      for (int dir = 0; dir < 2; ++dir) {
        if (dir == 0 ? !fwd : !bwd) continue;
        const float v = zt[K + dir] + bias[dir == 0 ? t + it.stride : t - it.stride];
        const float top = fmaxf(v, mx);
        const float lse = top + logf(expf(v - top) + e * expf(mx - top));
        if (h == 0) {
          part += lse - v;
          dz[dir * L + t] = expf(v - lse) - 1.f;
        }
        scale += expf(mx - lse);
      }
      for (int k = h; k < K; k += kG) zt[k] *= scale;
    }
  }
  return part;
}

// Gradient rows of one column chunk, added into the sums; with the bias
// gradients on the first chunk, and on the first chunk of a walk's first
// power its walk counts (occ, ends, neg_occ), from which
// walklets_counts_kernel forms every power's counts.
__device__ void grad_pass(const Params& p, const Layout& s, const float* st,
                          const int32_t* ids, const Item& it, int chunk, const float* z,
                          const float* dz, float* out) {
  const int L = p.L, K = p.K, tid = threadIdx.x, h = tid % kG;
  const int c0 = chunk * kChunk;
  const int cols = min(kChunk, p.sub - c0), c4n = (cols + 3) / 4;
  const bool first = chunk == 0, walk_counts = first && it.power == 0;
  const float* in_rows = st + s.rows;
  const float* tgt_rows = in_rows + L * kStride;
  const float* neg_rows = in_rows + 2 * L * kStride;
  const int stride = it.stride;

  // Position t: its input row (sum_k C[t][k] neg_k, plus the target rows of
  // its forward and backward pairs) and its target row (the input rows of
  // the pairs that end at t: t - s's forward pair, t + s's backward pair).
  for (int t = tid / kG; t < L; t += kThreads / kG) {
    const bool fwd = t < it.m, bwd = t >= stride;
    if (!fwd && !bwd) continue;
    const float in_f = fwd ? dz[t] : 0.f, in_b = bwd ? dz[L + t] : 0.f;
    const float tg_f = bwd ? dz[t - stride] : 0.f, tg_b = fwd ? dz[L + t + stride] : 0.f;
    float4 gi[kJ], gt[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) gi[j] = gt[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* zt = z + t * s.zs;
    for (int k = 0; k < K; ++k) {
      const float c = zt[k];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c4 = h + kG * j;
        if (c4 < c4n) fma4(gi[j], c, ld4(neg_rows + k * kStride + 4 * c4));
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c4 = h + kG * j;
      if (c4 >= c4n) continue;
      if (fwd) {
        fma4(gi[j], in_f, ld4(tgt_rows + (t + stride) * kStride + 4 * c4));
        fma4(gt[j], tg_b, ld4(in_rows + (t + stride) * kStride + 4 * c4));
      }
      if (bwd) {
        fma4(gi[j], in_b, ld4(tgt_rows + (t - stride) * kStride + 4 * c4));
        fma4(gt[j], tg_f, ld4(in_rows + (t - stride) * kStride + 4 * c4));
      }
      st4(out + t * kStride + 4 * c4, gi[j]);
      st4(out + (L + t) * kStride + 4 * c4, gt[j]);
    }
    if (first && h == 0) {
      const long long v = ids[t];
      atomicAdd(p.sums_b + it.base + v, tg_f + tg_b);
      if (walk_counts) {
        // Position t is in 2 - [t < s] - [t >= L - s] pairs of stride s.
        atomicAdd(p.occ + v, 1.f);
        for (int q = 0; q < p.power; ++q) {
          const int e = (t <= q) + (t >= L - 1 - q);
          if (e) atomicAdd(p.ends + q * p.n + v, static_cast<float>(e));
        }
      }
    }
  }

  // Negatives k0, k0 + 1 at float4 column c4: sum over positions of
  // C[t][k] in_t, the positions split over `lanes` neighbouring lanes and
  // their partial sums closed with shuffles. Every lane runs the same
  // rounds, so the shuffles see the whole warp.
  const int pairs = (K + 1) / 2, work = pairs * c4n;
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * work <= kThreads) lanes *= 2;
  const int rounds = (lanes * work + kThreads - 1) / kThreads;
  for (int r = 0; r < rounds; ++r) {
    const int q = r * kThreads + tid, w = q / lanes, part = q % lanes;
    const bool valid = w < work;
    const int k0 = 2 * (w / c4n), c4 = w % c4n;
    const bool two = k0 + 1 < K;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    float b0 = 0.f, b1 = 0.f;
    if (valid) {
#pragma unroll 4
      for (int t = part; t < L; t += lanes) {
        const float4 x = ld4(in_rows + t * kStride + 4 * c4);
        const float g0 = z[t * s.zs + k0];
        const float g1 = two ? z[t * s.zs + k0 + 1] : 0.f;
        fma4(a0, g0, x);
        fma4(a1, g1, x);
        b0 += g0;
        b1 += g1;
      }
    }
    for (int o = lanes / 2; o > 0; o /= 2) {
      add_to(a0, shfl_xor4(0xffffffffu, a0, o));
      add_to(a1, shfl_xor4(0xffffffffu, a1, o));
      b0 += __shfl_xor_sync(0xffffffffu, b0, o);
      b1 += __shfl_xor_sync(0xffffffffu, b1, o);
    }
    if (!valid || part != 0) continue;
    for (int i = 0; i < (two ? 2 : 1); ++i) {
      st4(out + (2 * L + k0 + i) * kStride + 4 * c4, i == 0 ? a0 : a1);
      if (first && c4 == 0) {
        const long long v = ids[L + k0 + i];
        atomicAdd(p.sums_b + it.base + v, i == 0 ? b0 : b1);
        if (walk_counts) atomicAdd(p.neg_occ + v, 1.f);
      }
    }
  }

  // The rows go out a row at a time: neighbouring lanes add neighbouring
  // pieces of one row, so an instruction's reductions cover whole rows.
  __syncthreads();
  const int R = 2 * L + K, piece = p.vec ? 4 : 1, pieces = p.vec ? c4n : cols;
  for (int q = tid; q < R * pieces; q += kThreads) {
    const int r = q / pieces, c = piece * (q - r * pieces);
    const int t = r < L ? r : r - L;
    if (r < 2 * L && t >= it.m && t < stride) continue;  // in no pair
    float* sums = r < L ? p.sums_w : p.sums_c;
    float* dst = sums + (it.base + ids[r < 2 * L ? t : r - L]) * p.sub + c0 + c;
    if (p.vec) {
      atomicAdd(reinterpret_cast<float4*>(dst), ld4(out + r * kStride + c));
    } else {
      atomicAdd(dst, out[r * kStride + c]);
    }
  }
}

// Every power's counts from the walk counts: position t of a walk is in
// 2 - [t < s] - [t >= L - s] pairs of stride s = p + 1 (as input, and as
// target), so counts_w[p N + v] gains 2 occ[v] - ends[p, v], and
// counts_c[p N + v] that plus neg_occ[v] (a walk's negatives serve every
// power).
__global__ void walklets_counts_kernel(Params p) {
  const long long total = p.n * p.power;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long v = i % p.n;
    const float c = 2.f * p.occ[v] - p.ends[i], cc = c + p.neg_occ[v];
    if (c != 0.f) p.counts_w[i] += c;
    if (cc != 0.f) p.counts_c[i] += cc;
  }
}

__global__ void __launch_bounds__(kThreads, 4) walklets_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout s = layout(p.L, p.K);
  const int tid = threadIdx.x;
  int32_t* ids = reinterpret_cast<int32_t*>(smem + s.ids);
  float* z = smem + s.z;
  float* dz = smem + s.dz;
  float* warp_loss = smem + s.red;
  // Everything starts at 0: the rows' padding columns, which the float4
  // reads run over, stay so.
  for (int i = tid; i < s.total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  // The block's units, in order: its items blockIdx.x + i gridDim.x, each
  // one unit (logits and gradients) when sub fits one chunk, else its
  // chunks' logits, then its chunks' gradients. Unit n's ids sit in slot
  // n % kIdSlots; they are copied a unit before its rows, so that the rows'
  // copies read them from shared memory.
  const int units = p.chunks == 1 ? 1 : 2 * p.chunks;
  const long long total = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x * units;
  const auto item_of_unit = [&](long long n) { return blockIdx.x + n / units * gridDim.x; };
  const auto slot = [&](long long n) { return ids + (n % kIdSlots) * (p.L + p.K); };
  issue_ids(p, item_of_unit(0), slot(0));
  cp_async_commit();
  cp_async_wait_all();
  for (long long n = 0; n < total; ++n) {
    __syncthreads();
    const long long item = item_of_unit(n);
    const int u = static_cast<int>(n % units), chunk = u % p.chunks;
    issue_rows(p, s, item, chunk, slot(n), smem);
    if (n + 1 < total) issue_ids(p, item_of_unit(n + 1), slot(n + 1));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const Item it = item_of(p, item);
    if (units == 1 || u < p.chunks) {
      logit_pass(p, s, smem, it, chunk, z);
      if (chunk == p.chunks - 1) {
        __syncthreads();
        float part = dz_pass(p, s, smem, it, z, dz);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if ((tid & 31) == 0) warp_loss[tid / 32] = part;
        __syncthreads();
        if (tid == 0) {
          float sum = 0.f;
          for (int w = 0; w < kWarps; ++w) sum += warp_loss[w];
          p.loss[item] = sum;
        }
      }
    }
    if (units == 1 || u >= p.chunks) grad_pass(p, s, smem, slot(n), it, chunk, z, dz, smem + s.out);
  }
}

}  // namespace

extern "C" {

// One launch of min(B * power, blocks per SM x SMs) persistent blocks (see
// walklets_kernel), then one of walklets_counts_kernel, which turns the
// walk counts in `scratch` ((P + 2) N zeros: occ, neg_occ, ends) into every
// power's counts. mode 0 is SkipGram's NCE, 1 CBOW's sampled softmax. Needs
// L > power (every power has a pair; the wrapper checks it) and K >= 1.
// A shape whose block does not fit the SM's shared memory (about
// 4 (149 L + 75 K + L (K + 3)) bytes) fails, and that error is returned
// like a launch error.
int ebt_walklets_update(const void* node_emb, const void* ctx_emb, const void* ctx_bias,
                        const void* walks, const void* negs, void* loss, void* sums_w,
                        void* sums_c, void* sums_b, void* counts_w, void* counts_c,
                        void* scratch, long long n, long long B, int L, int K, int sub,
                        int power, int mode, void* stream) {
  if (B == 0) return 0;
  const auto kernel = walklets_kernel;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(layout(L, K).total) * sizeof(float);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(node_emb) | reinterpret_cast<uintptr_t>(ctx_emb) |
      reinterpret_cast<uintptr_t>(sums_w) | reinterpret_cast<uintptr_t>(sums_c);
  const long long items = B * power;
  float* occ = static_cast<float*>(scratch);
  Params p{static_cast<const float*>(node_emb), static_cast<const float*>(ctx_emb),
           static_cast<const float*>(ctx_bias), static_cast<const int32_t*>(walks),
           static_cast<const int32_t*>(negs), static_cast<float*>(loss),
           static_cast<float*>(sums_w), static_cast<float*>(sums_c),
           static_cast<float*>(sums_b), static_cast<float*>(counts_w),
           static_cast<float*>(counts_c), occ, occ + n, occ + 2 * n, n, items, L, K, sub,
           power, mode, (sub + kChunk - 1) / kChunk, sub % 4 == 0 && align % 16 == 0};
  const long long grid = items < static_cast<long long>(per_sm) * sms
                             ? items : static_cast<long long>(per_sm) * sms;
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = n * power, count_blocks = (rows + 255) / 256;
  walklets_counts_kernel<<<static_cast<unsigned>(count_blocks < 8LL * sms ? count_blocks : 8LL * sms),
                           256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
