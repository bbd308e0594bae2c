// K4: the per-row mean SGD update of the embedding tables.
//
// Replaces embiggen_tpu/models/embedders/walk_based.py::_mean_scatter as
// used by SkipGram._apply_table_grads: every row r touched by the index
// multiset takes one step  table[r] -= lr * sum(grads on r) / count(r).
//
// SkipGram's step (`skipgram_mean_combine`): K3 (csrc/skipgram.cu) has
// already added the gradient rows into persistent sums and counts; one
// pass over the rows of the three tables applies
//   node_embedding    -= lr * sums_w / max(counts_w, 1)
//   context_embedding -= lr * sums_c / max(counts_c, 1)
//   context_bias      -= lr * sums_b / max(counts_c, 1)
// and writes zeros back into the sums and counts it read, so they are zero
// for the next step and no step fills them. A row whose count is 0 has sums
// of 0 and is skipped whole (the update would subtract 0). A group of lanes
// (a power of two, at most a warp) takes a row, float4 columns when
// D % 4 == 0. What bounds it: the touched rows of the tables and the sums,
// each read once and written once, and the counts.
//
// The standalone `mean_scatter` (for any table and index multiset), two
// kernels launched in turn by the wrapper:
//   1. scatter_add_rows: for each segment (walk rows, then negatives),
//      atomically add every gradient row into a zeroed sums [N, D] and, when
//      the counts are not shared from an earlier call, 1.0 into counts [N];
//   2. mean_combine: table -= lr * sums / max(counts, 1), IN PLACE on the
//      table the caller passed (the JAX version returns a new table).
// The JAX version switches lowering at |idx| >= N / 8, a choice made for the
// TPU; both of its lowerings compute the same update, and this port keeps
// the one above.
//
// What bounds it on the H100: the atomics and one [N, D] pass. Step 1 issues
// one float atomic per gradient element (B L D + B K D of them per table)
// at random rows; step 2 streams table, sums and counts once
// (3 N D floats moved).
//
// What the design does about it: consecutive threads add consecutive d of
// one row, so a warp's atomics land in one or a few 32-byte sectors of L2
// and resolve there; the return value is unused, so they compile to
// fire-and-forget reductions. The combine is one coalesced elementwise pass.
// Float atomics add in no fixed order, so results differ from run to run by
// rounding only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_add_rows_kernel(float* __restrict__ sums,
                                        float* __restrict__ counts,
                                        const int32_t* __restrict__ idx,
                                        const float* __restrict__ grads,
                                        int64_t m, int d) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= m * d) return;
  const int64_t row = i / d;
  const int col = static_cast<int>(i - row * d);
  const int64_t r = idx[row];
  atomicAdd(&sums[r * d + col], grads[i]);
  if (counts != nullptr && col == 0) atomicAdd(&counts[r], 1.f);
}

__global__ void mean_combine_kernel(float* __restrict__ table,
                                    const float* __restrict__ sums,
                                    const float* __restrict__ counts, float lr,
                                    int64_t n, int d) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n * d) return;
  table[i] -= lr * (sums[i] / fmaxf(counts[i / d], 1.f));
}

__global__ void skipgram_combine_kernel(
    float* __restrict__ node_emb, float* __restrict__ sums_w,
    float* __restrict__ counts_w, float* __restrict__ ctx_emb,
    float* __restrict__ sums_c, float* __restrict__ ctx_bias,
    float* __restrict__ sums_b, float* __restrict__ counts_c, float lr,
    int64_t n, int d, int lanes, bool vec) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / lanes;
  const int lane = static_cast<int>(t - row * lanes);
  const bool active = row < n;
  const float cw = active ? counts_w[row] : 0.f;
  const float cc = active ? counts_c[row] : 0.f;
  // Every lane of the row has read its counts before one lane zeroes them.
  __syncwarp();
  const int64_t base = row * d;
  if (vec) {
    float4* table = reinterpret_cast<float4*>(node_emb + base);
    float4* sums = reinterpret_cast<float4*>(sums_w + base);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cw > 0.f) {
      for (int c = lane; c < d / 4; c += lanes) {
        const float4 s = sums[c];
        float4 v = table[c];
        v.x -= lr * (s.x / cw);
        v.y -= lr * (s.y / cw);
        v.z -= lr * (s.z / cw);
        v.w -= lr * (s.w / cw);
        table[c] = v;
        sums[c] = zero;
      }
    }
    table = reinterpret_cast<float4*>(ctx_emb + base);
    sums = reinterpret_cast<float4*>(sums_c + base);
    if (cc > 0.f) {
      for (int c = lane; c < d / 4; c += lanes) {
        const float4 s = sums[c];
        float4 v = table[c];
        v.x -= lr * (s.x / cc);
        v.y -= lr * (s.y / cc);
        v.z -= lr * (s.z / cc);
        v.w -= lr * (s.w / cc);
        table[c] = v;
        sums[c] = zero;
      }
    }
  } else {
    if (cw > 0.f) {
      for (int c = lane; c < d; c += lanes) {
        node_emb[base + c] -= lr * (sums_w[base + c] / cw);
        sums_w[base + c] = 0.f;
      }
    }
    if (cc > 0.f) {
      for (int c = lane; c < d; c += lanes) {
        ctx_emb[base + c] -= lr * (sums_c[base + c] / cc);
        sums_c[base + c] = 0.f;
      }
    }
  }
  if (lane == 0) {
    if (cw > 0.f) counts_w[row] = 0.f;
    if (cc > 0.f) {
      ctx_bias[row] -= lr * (sums_b[row] / cc);
      sums_b[row] = 0.f;
      counts_c[row] = 0.f;
    }
  }
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// counts == NULL leaves the counts alone (they were taken by an earlier
// call and are shared, e.g. context_bias reuses context_embedding's).
int ebt_scatter_add_rows(void* sums, void* counts, const void* idx,
                         const void* grads, long long m, int d, void* stream) {
  if (m == 0) return 0;
  scatter_add_rows_kernel<<<blocks_for(m * d), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<const int32_t*>(idx), static_cast<const float*>(grads), m, d);
  return static_cast<int>(cudaGetLastError());
}

int ebt_mean_combine(void* table, const void* sums, const void* counts,
                     float lr, long long n, int d, void* stream) {
  if (n == 0) return 0;
  mean_combine_kernel<<<blocks_for(n * d), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const float*>(sums),
      static_cast<const float*>(counts), lr, n, d);
  return static_cast<int>(cudaGetLastError());
}

// SkipGram's combine over n rows of width d; see skipgram_combine_kernel.
int ebt_skipgram_combine(void* node_emb, void* sums_w, void* counts_w,
                         void* ctx_emb, void* sums_c, void* ctx_bias,
                         void* sums_b, void* counts_c, float lr, long long n,
                         int d, void* stream) {
  if (n == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(node_emb) |
                          reinterpret_cast<uintptr_t>(sums_w) |
                          reinterpret_cast<uintptr_t>(ctx_emb) |
                          reinterpret_cast<uintptr_t>(sums_c);
  const bool vec = d % 4 == 0 && align % 16 == 0;
  const int cols = vec ? d / 4 : d;
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes *= 2;
  skipgram_combine_kernel<<<blocks_for(n * lanes), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(node_emb), static_cast<float*>(sums_w),
      static_cast<float*>(counts_w), static_cast<float*>(ctx_emb),
      static_cast<float*>(sums_c), static_cast<float*>(ctx_bias),
      static_cast<float*>(sums_b), static_cast<float*>(counts_c), lr, n, d,
      lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
