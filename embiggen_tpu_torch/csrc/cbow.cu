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
// and their gradients, about 0.6 MFLOP) are far below the fp32 rate. The
// simple design (one block per walk, every product a loop of float4 reads
// of shared memory) spent most of its time reading shared memory: about
// 130,000 float4 reads a walk.
//
// The design:
//   - persistent blocks (as many per SM as fit) loop over walks. A walk's
//     rows sit in shared memory (rows padded by 4 floats, so that lanes
//     reading different rows fall in different banks): its input rows, its
//     centres' and negatives' output rows, and the hidden rows. They come
//     as cp.async copies (16 bytes a copy when D % 4 == 0 and the tables
//     are 16-byte aligned, else 4) that overlap the walk before: the next
//     walk's ids as this walk starts, its input rows as soon as this walk's
//     hidden rows exist, its output rows and biases once this walk's last
//     phase has read them; every copy reads its ids from shared memory;
//   - hidden rows and input gradients as running window sums: a thread
//     owns a run of positions at 4 d and slides the window along it, about
//     3 reads of shared memory per row it writes instead of 2w;
//   - logits and softmax in one pass: 4 lanes per centre, each over a
//     quarter of D, every lane holding all K + 1 partial dot products (the
//     negatives' rows are read once per lane for all centres of its warp, a
//     broadcast), summed by two shuffles; the 4 lanes then take the clip,
//     the softmax and its gradients G straight from those sums;
//   - gradients as register tiles: a thread owns kRowTile centres (their
//     g_out and g_h; each negative row it reads serves all of them) or
//     kNegTile negatives (their g_neg; each hidden row serves all of them)
//     at 4 d; the hidden gradients go in place over the output rows;
//   - the rows go out as float4 reductions (red.global.add.v4.f32) into the
//     sums, scalar atomics when D % 4 != 0. Float atomics add in no fixed
//     order, so sums differ from run to run by rounding.
// With EBT_PHASE_CLOCK defined, thread 0 of each block adds up clock64()
// cycles per phase (gather wait, hidden rows, logits and softmax, output
// and negative gradients, input gradients with the reductions, and the
// total) into clocks[block, 0..5].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 4;    // lanes per centre in the logit pass
constexpr int kChunk = 12;    // logits per lane per pass over D
constexpr int kRowTile = 8;   // centres per thread in the gradient pass
constexpr int kNegTile = 4;   // negatives per thread in the gradient pass

// Offsets in floats of the parts of dynamic shared memory. The rows are
// written only by the copies and by the phases, at columns below 4 D4, so
// the columns past D stay 0 from the first fill. The small per-walk parts
// come twice, one for this walk and one for the next.
struct Layout {
  int D4;     // float4 columns of a row: ceil(D / 4)
  int Dp;     // row stride: 4 D4 + 4
  int in;     // [L] input rows of the walk
  int out;    // [C] output rows of the centres; their hidden gradients later
  int neg;    // [K] output rows of the negatives
  int hid;    // [C] hidden rows
  int G;      // [C, K + 1] clipped logits, then their loss gradients
  int small;  // two copies of: out_b [C], neg_b [K], cw [C], ids [L + K]
  int per;    // floats per copy of the small parts
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
  s.small = s.G + C * (K + 1);
  s.per = C + K + C + L + K;
  s.loss = s.small + 2 * s.per;
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
  long long* clocks;
  int64_t B;
  int L, K, D, window;
  bool vec;
  float clip;
};

// One walk's small parts in shared memory.
struct Small {
  float* out_b;
  float* neg_b;
  float* cw;
  int32_t* ids;  // the walk, then the negatives
};

__device__ __forceinline__ Small small_parts(float* smem, const Layout& s, int C, int K,
                                             int buf) {
  float* base = smem + s.small + buf * s.per;
  return Small{base, base + C, base + C + K, reinterpret_cast<int32_t*>(base + 2 * C + K)};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one of this thread's groups is in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
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

__device__ __forceinline__ void sub4(float4& acc, const float4& v) {
  acc.x -= v.x;
  acc.y -= v.y;
  acc.z -= v.z;
  acc.w -= v.w;
}

__device__ __forceinline__ float4 scale4(const float4& v, float a) {
  return make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// Start copying `rows` table rows into shared memory at `dst` (stride Dp):
// row r is row id_of(r) of `table`.
template <typename IdOf>
__device__ void copy_rows(const Params& p, const Layout& s, const float* table, int rows,
                          IdOf id_of, float* dst) {
  const int tid = threadIdx.x;
  if (p.vec) {
#pragma unroll 4
    for (int q = tid; q < rows * s.D4; q += kThreads) {
      const int r = q / s.D4, c = q - r * s.D4;
      cp_async16(dst + r * s.Dp + 4 * c, table + id_of(r) * p.D + 4 * c);
    }
  } else {
    for (int q = tid; q < rows * p.D; q += kThreads) {
      const int r = q / p.D, c = q - r * p.D;
      cp_async4(dst + r * s.Dp + c, table + id_of(r) * p.D + c);
    }
  }
}

// A walk's ids (the walk, then its negatives) and centre weights, copied
// into `sm`: they need no other read first.
__device__ void issue_ids(const Params& p, int64_t walk, const Small& sm) {
  const int L = p.L, K = p.K, w = p.window, tid = threadIdx.x;
  for (int i = tid; i < L + K; i += kThreads) {
    cp_async4(sm.ids + i, i < L ? p.walks + walk * L + i : p.negs + walk * K + (i - L));
  }
  if (p.center_w != nullptr) {
    for (int i = tid; i < L - 2 * w; i += kThreads) {
      cp_async4(sm.cw + i, p.center_w + walk * L + w + i);
    }
  }
}

// A walk's input rows into the input region, at the ids in `sm`.
__device__ void issue_inputs(const Params& p, const Layout& s, float* smem, const Small& sm) {
  copy_rows(p, s, p.node_emb, p.L, [&](int r) { return static_cast<int64_t>(sm.ids[r]); },
            smem + s.in);
}

// A walk's centres' and negatives' output rows and biases, at the ids in
// `sm`.
__device__ void issue_outputs(const Params& p, const Layout& s, float* smem, const Small& sm) {
  const int L = p.L, K = p.K, w = p.window, C = L - 2 * w;
  const int32_t* ids = sm.ids;
  for (int i = threadIdx.x; i < C + K; i += kThreads) {
    if (i < C) {
      cp_async4(sm.out_b + i, p.out_bias + ids[w + i]);
    } else {
      cp_async4(sm.neg_b + i - C, p.out_bias + ids[L + i - C]);
    }
  }
  copy_rows(p, s, p.out_emb, C + K, [&](int r) {
    return static_cast<int64_t>(r < C ? ids[w + r] : ids[L + r - C]);
  }, smem + s.out);
}

// Hidden rows: h_l = (S_l - x_l) / 2w with S_l the sum of the input rows
// l - w .. l + w, slid along a run of `seg` centres per thread.
__device__ void hidden_pass(const Params& p, const Layout& s, float* smem) {
  const int L = p.L, w = p.window, C = L - 2 * w, D4 = s.D4, Dp = s.Dp;
  const float inv_2w = 1.f / static_cast<float>(2 * w);
  const int seg = (C * D4 + kThreads - 1) / kThreads;
  const int nseg = (C + seg - 1) / seg;
  const float* x = smem + s.in;
  float* hid = smem + s.hid;
  for (int item = threadIdx.x; item < nseg * D4; item += kThreads) {
    const int g = item / D4, c4 = item - g * D4;
    const int l0 = w + g * seg, l1 = min(l0 + seg, L - w);
    float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = l0 - w; m <= l0 + w; ++m) add4(S, ld4(x + m * Dp + 4 * c4));
    for (int l = l0; l < l1; ++l) {
      float4 h = S;
      sub4(h, ld4(x + l * Dp + 4 * c4));
      st4(hid + (l - w) * Dp + 4 * c4, scale4(h, inv_2w));
      if (l + 1 < l1) {
        add4(S, ld4(x + (l + w + 1) * Dp + 4 * c4));
        sub4(S, ld4(x + (l - w) * Dp + 4 * c4));
      }
    }
  }
}

// Logits, softmax and their gradients G: kSlices lanes per centre, each
// over the columns c4 = slice, slice + kSlices, ...; returns this thread's
// share of the walk's loss.
__device__ float logit_pass(const Params& p, const Layout& s, float* smem, const Small& sm) {
  const int L = p.L, K = p.K, w = p.window, C = L - 2 * w, K1 = K + 1, D4 = s.D4,
            Dp = s.Dp;
  const int lane = threadIdx.x & 31;
  const unsigned mask = 0xfu << (lane & ~(kSlices - 1));
  const float* hid = smem + s.hid;
  const float* out = smem + s.out;
  const float* neg = smem + s.neg;
  float* G = smem + s.G;
  float my_loss = 0.f;
  // kThreads is a multiple of kSlices, so a centre's lanes iterate together.
  for (int item = threadIdx.x; item < C * kSlices; item += kThreads) {
    const int i = item / kSlices, slice = item - i * kSlices;
    const float* h = hid + i * Dp;
    for (int j0 = 0; j0 < K1; j0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) acc[jj] = 0.f;
      // Slice s reads columns 2s, 2s + 1, 2s + 2 kSlices, ...: a
      // quarter-warp's 8 lanes (two centres, rows 4 banks apart) then touch
      // 8 different 16-byte bank groups.
      for (int c0 = 2 * slice; c0 < D4; c0 += 2 * kSlices) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c4 = c0 + e;
          if (c4 >= D4) break;
          const float4 a = ld4(h + 4 * c4);
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const int j = j0 + jj;
            if (j < K1) {
              const float* o = j == 0 ? out + i * Dp : neg + (j - 1) * Dp;
              acc[jj] = dot4(a, ld4(o + 4 * c4), acc[jj]);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int o = 1; o < kSlices; o <<= 1) acc[jj] += __shfl_xor_sync(mask, acc[jj], o);
        const int j = j0 + jj;
        if (j < K1 && jj % kSlices == slice) {
          const float z = acc[jj] + (j == 0 ? sm.out_b[i] : sm.neg_b[j - 1]);
          G[i * K1 + j] = fminf(fmaxf(z, -p.clip), p.clip);
        }
      }
    }
    __syncwarp(mask);
    // Sampled softmax on the clipped logits; the straight-through clip
    // passes the gradient unscaled.
    float* g = G + i * K1;
    float m = -p.clip;  // every clipped logit is at least this
    for (int j = 0; j < K1; ++j) m = fmaxf(m, g[j]);
    float sum = 0.f;
    for (int j = 0; j < K1; ++j) sum += expf(g[j] - m);
    const float lse = m + logf(sum), cw = sm.cw[i];
    const float z0 = g[0];
    __syncwarp(mask);
    if (slice == 0) my_loss += (lse - z0) * cw;
    for (int j = slice; j < K1; j += kSlices) {
      g[j] = cw * (expf(g[j] - lse) - (j == 0 ? 1.f : 0.f));
    }
  }
  return my_loss;
}

// Output and negative rows' gradients, and the hidden gradients in place
// over the output rows (each thread reads and writes only its own columns
// of its own centres); the biases' sums and the counts.
__device__ void gradient_pass(const Params& p, const Layout& s, float* smem, const Small& sm) {
  const int L = p.L, K = p.K, w = p.window, C = L - 2 * w, K1 = K + 1, D4 = s.D4,
            Dp = s.Dp;
  const float* hid = smem + s.hid;
  float* out = smem + s.out;
  const float* neg = smem + s.neg;
  const float* G = smem + s.G;
  const int row_groups = (C + kRowTile - 1) / kRowTile;
  const int neg_groups = (K + kNegTile - 1) / kNegTile;
  for (int item = threadIdx.x; item < (row_groups + neg_groups) * D4; item += kThreads) {
    const int grp = item / D4, c4 = item - grp * D4;
    if (grp < row_groups) {
      const int i0 = grp * kRowTile;
      float4 gh[kRowTile];
#pragma unroll
      for (int a = 0; a < kRowTile; ++a) {
        const int i = i0 + a;
        gh[a] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < C) {
          const float g0 = G[i * K1];
          fma4(gh[a], g0, ld4(out + i * Dp + 4 * c4));
          add_row4(p, p.sums_c, sm.ids[w + i], c4, scale4(ld4(hid + i * Dp + 4 * c4), g0));
        }
      }
      for (int k = 0; k < K; ++k) {
        const float4 nk = ld4(neg + k * Dp + 4 * c4);
#pragma unroll
        for (int a = 0; a < kRowTile; ++a) {
          if (i0 + a < C) fma4(gh[a], G[(i0 + a) * K1 + k + 1], nk);
        }
      }
#pragma unroll
      for (int a = 0; a < kRowTile; ++a) {
        if (i0 + a < C) st4(out + (i0 + a) * Dp + 4 * c4, gh[a]);
      }
    } else {
      const int k0 = (grp - row_groups) * kNegTile;
      float4 gn[kNegTile];
      float gnb[kNegTile];
#pragma unroll
      for (int a = 0; a < kNegTile; ++a) {
        gn[a] = make_float4(0.f, 0.f, 0.f, 0.f);
        gnb[a] = 0.f;
      }
      for (int i = 0; i < C; ++i) {
        const float4 h = ld4(hid + i * Dp + 4 * c4);
#pragma unroll
        for (int a = 0; a < kNegTile; ++a) {
          // A slot past K reads another negative's finite gradient; dropped.
          const float g = G[i * K1 + 1 + min(k0 + a, K - 1)];
          fma4(gn[a], g, h);
          gnb[a] += g;
        }
      }
#pragma unroll
      for (int a = 0; a < kNegTile; ++a) {
        const int k = k0 + a;
        if (k >= K) break;
        const int64_t id = sm.ids[L + k];
        add_row4(p, p.sums_c, id, c4, gn[a]);
        if (c4 == 0) {
          atomicAdd(p.sums_b + id, gnb[a]);
          atomicAdd(p.counts_c + id, 1.f);
        }
      }
    }
  }
  for (int m = threadIdx.x; m < L; m += kThreads) {
    const int64_t id = sm.ids[m];
    if (m >= w && m < L - w) atomicAdd(p.sums_b + id, G[(m - w) * K1]);
    atomicAdd(p.counts_w + id, 1.f);
    atomicAdd(p.counts_c + id, 1.f);
  }
}

// Input rows' gradients: the hidden gradients of the centres l with
// 0 < |m - l| <= w, over 2w, as a window sum slid along a run of `seg`
// positions per thread.
__device__ void input_pass(const Params& p, const Layout& s, float* smem, const Small& sm) {
  const int L = p.L, w = p.window, C = L - 2 * w, D4 = s.D4, Dp = s.Dp;
  const float inv_2w = 1.f / static_cast<float>(2 * w);
  const int seg = (L * D4 + kThreads - 1) / kThreads;
  const int nseg = (L + seg - 1) / seg;
  const float* gh = smem + s.out;  // g_h of centre l at row l - w
  for (int item = threadIdx.x; item < nseg * D4; item += kThreads) {
    const int g = item / D4, c4 = item - g * D4;
    const int m0 = g * seg, m1 = min(m0 + seg, L);
    // T = the sum of g_h over the centres in [m - w, m + w].
    float4 T = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = max(m0 - w, w); l <= min(m0 + w, L - w - 1); ++l) {
      add4(T, ld4(gh + (l - w) * Dp + 4 * c4));
    }
    for (int m = m0; m < m1; ++m) {
      const int lo = max(m - w, w), hi = min(m + w, L - w - 1);
      const bool centre = m >= w && m < L - w;
      if (hi - lo + 1 - (centre ? 1 : 0) > 0) {
        float4 v = T;
        if (centre) sub4(v, ld4(gh + (m - w) * Dp + 4 * c4));
        add_row4(p, p.sums_w, sm.ids[m], c4, scale4(v, inv_2w));
      }
      if (m + 1 < m1) {
        const int in = m + w + 1, out = m - w;
        if (in >= w && in < L - w) add4(T, ld4(gh + (in - w) * Dp + 4 * c4));
        if (out >= w && out < L - w) sub4(T, ld4(gh + (out - w) * Dp + 4 * c4));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) cbow_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, K = p.K, w = p.window, C = L - 2 * w;
  const Layout s = layout(L, K, p.D, w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* warp_loss = smem + s.loss;
  // Everything starts at 0, the padding columns included; the centre
  // weights stay 1 when there are none.
  for (int i = tid; i < s.total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  if (p.center_w == nullptr) {
    for (int buf = 0; buf < 2; ++buf) {
      float* cw = small_parts(smem, s, C, K, buf).cw;
      for (int i = tid; i < C; i += kThreads) cw[i] = 1.f;
    }
  }
#ifdef EBT_PHASE_CLOCK
  long long cycles[6] = {0, 0, 0, 0, 0, 0};
#endif
  // The copies come in three groups a walk: its ids and centre weights,
  // issued at the start of the walk before it; its input rows, issued once
  // those ids are in and the walk before has built its hidden rows; its
  // output rows and biases, issued once the walk before is done.
  if (static_cast<int64_t>(blockIdx.x) < p.B) {
    const Small first = small_parts(smem, s, C, K, 0);
    issue_ids(p, blockIdx.x, first);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();
    issue_inputs(p, s, smem, first);
    cp_async_commit();
    issue_outputs(p, s, smem, first);
  }
  cp_async_commit();
  int it = 0;
  for (int64_t walk = blockIdx.x; walk < p.B; walk += gridDim.x, ++it) {
    const Small sm = small_parts(smem, s, C, K, it & 1);
    const Small next_sm = small_parts(smem, s, C, K, (it + 1) & 1);
    const int64_t next = walk + gridDim.x;
#ifdef EBT_PHASE_CLOCK
    const long long c0 = clock64();
#endif
    cp_async_wait1();  // this walk's input rows
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c1 = clock64();
#endif
    if (next < p.B) issue_ids(p, next, next_sm);
    cp_async_commit();
    hidden_pass(p, s, smem);
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c2 = clock64();
#endif
    cp_async_wait0();  // this walk's output rows, the next walk's ids
    __syncthreads();
    if (next < p.B) issue_inputs(p, s, smem, next_sm);
    cp_async_commit();
#ifdef EBT_PHASE_CLOCK
    const long long c3 = clock64();
#endif
    float my_loss = logit_pass(p, s, smem, sm);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) my_loss += __shfl_xor_sync(0xffffffffu, my_loss, o);
    if (lane == 0) warp_loss[warp] = my_loss;
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c4 = clock64();
#endif
    if (tid == 0) {
      float total = 0.f;
      for (int i = 0; i < kWarps; ++i) total += warp_loss[i];
      p.loss[walk] = total;
    }
    gradient_pass(p, s, smem, sm);
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c5 = clock64();
#endif
    input_pass(p, s, smem, sm);
    __syncthreads();
#ifdef EBT_PHASE_CLOCK
    const long long c6 = clock64();
#endif
    if (next < p.B) issue_outputs(p, s, smem, next_sm);
    cp_async_commit();
#ifdef EBT_PHASE_CLOCK
    const long long c7 = clock64();
    cycles[0] += (c1 - c0) + (c3 - c2) + (c7 - c6);
    cycles[1] += c2 - c1;
    cycles[2] += c4 - c3;
    cycles[3] += c5 - c4;
    cycles[4] += c6 - c5;
    cycles[5] += c7 - c0;
#endif
  }
  cp_async_wait0();
#ifdef EBT_PHASE_CLOCK
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) p.clocks[6 * static_cast<int64_t>(blockIdx.x) + i] = cycles[i];
  }
#endif
}

}  // namespace

extern "C" {

// The grid is min(B, blocks per SM x SMs) persistent blocks, as many per
// SM as fit; a shape whose walk does not fit a block's shared memory is an
// invalid-value error, returned like a launch error.
int ebt_cbow_update(const void* node_emb, const void* out_emb, const void* out_bias,
                    const void* walks, const void* negs, const void* center_w, void* loss,
                    void* sums_w, void* sums_c, void* sums_b, void* counts_w,
                    void* counts_c, void* clocks, long long B, int L, int K, int D, int window,
                    float clip, void* stream) {
  if (B == 0) return 0;
  if (window < 1 || L <= 2 * window || K < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(layout(L, K, D, window).total) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cbow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int fit = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, cbow_kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p{static_cast<const float*>(node_emb), static_cast<const float*>(out_emb),
           static_cast<const float*>(out_bias), static_cast<const int32_t*>(walks),
           static_cast<const int32_t*>(negs), static_cast<const float*>(center_w),
           static_cast<float*>(loss), static_cast<float*>(sums_w), static_cast<float*>(sums_c),
           static_cast<float*>(sums_b), static_cast<float*>(counts_w),
           static_cast<float*>(counts_c), static_cast<long long*>(clocks), B, L, K, D, window,
           false, clip};
  // 16-byte copies and float4 atomics need every row 16-byte aligned.
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(node_emb) | reinterpret_cast<uintptr_t>(out_emb) |
      reinterpret_cast<uintptr_t>(sums_w) | reinterpret_cast<uintptr_t>(sums_c);
  p.vec = D % 4 == 0 && align % 16 == 0;
  const long long grid =
      B < static_cast<long long>(fit) * sms ? B : static_cast<long long>(fit) * sms;
  cbow_kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
