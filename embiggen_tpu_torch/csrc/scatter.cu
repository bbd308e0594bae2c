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
// The standalone `mean_scatter` (for any table and index multiset; LINE's
// updates), two kernels launched in turn by the wrapper:
//   1. scatter_rows: for each segment (e.g. LINE's context rows, then its
//      negatives), add every gradient row into sums [N, D] and, when the
//      counts are not the caller's, 1.0 into counts [N];
//   2. mean_rows_combine: table -= lr * sums / counts on the rows whose
//      count is not 0, IN PLACE on the table the caller passed (the JAX
//      version returns a new table), writing zeros back into those rows of
//      the sums and, when they are the call's own, of the counts.
// The sums and counts are a workspace the fit allocates once
// (`ops/scatter.py::MeanScatterSums`), zero between calls, so no call
// fills them. The JAX version switches lowering at |idx| >= N / 8, a choice
// made for the TPU; both of its lowerings compute the same update, and this
// port keeps the one above.
//
// What bounds it on the H100: bytes. The scatter reads the ids and the
// gradient rows and adds them into the touched rows of the sums; the
// combine reads all N counts to find the touched rows, then reads and
// writes only those rows of the table and the sums. At LINE's S6 shapes
// (N 1M, D 128, 393,216 context rows touching about 322k distinct) the
// combine moves 0.66 GB, where a pass over all N rows of table, sums and
// counts moves 1.5 GB, and no call fills a fresh [N, D] sums.
//
// What the design does about it: the scatter takes a group of lanes a
// gradient row (a power of two, at most a warp, covering D / 4 float4
// columns when D % 4 == 0 and the rows are 16-byte aligned, else D
// columns), each lane one float4 atomicAdd a column (sm_90 adds four
// floats in one global atomic; the result is unused, so they are
// fire-and-forget reductions), and one lane counts the row. The combine
// takes a warp 32 rows: each lane reads one count, the warp lists its
// touched rows in shared memory, and groups of lanes take one listed row
// each, float4 columns when they can. Float atomics add in no fixed order,
// so results differ from run to run by rounding only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_rows_kernel(float* __restrict__ sums,
                                    float* __restrict__ counts,
                                    const int32_t* __restrict__ idx,
                                    const float* __restrict__ grads, int64_t m,
                                    int d, int lanes, bool vec) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / lanes;
  const int lane = static_cast<int>(t - row * lanes);
  if (row >= m) return;
  const int64_t r = idx[row];
  if (vec) {
    const float4* g = reinterpret_cast<const float4*>(grads + row * d);
    float4* s = reinterpret_cast<float4*>(sums + r * d);
    for (int c = lane; c < d / 4; c += lanes) atomicAdd(s + c, __ldg(g + c));
  } else {
    for (int c = lane; c < d; c += lanes) {
      atomicAdd(sums + r * d + c, __ldg(grads + row * d + c));
    }
  }
  if (counts != nullptr && lane == 0) atomicAdd(counts + r, 1.f);
}

__global__ void mean_rows_combine_kernel(float* __restrict__ table,
                                         float* __restrict__ sums,
                                         float* __restrict__ counts, float lr,
                                         int64_t n, int d, int lanes, bool vec,
                                         bool zero_counts) {
  __shared__ int listed[kThreads];
  __shared__ float listed_count[kThreads];
  const int64_t first = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) & ~31ll;
  const int lane = threadIdx.x & 31;
  const int64_t own = first + lane;
  const float c = own < n ? counts[own] : 0.f;
  const unsigned touched = __ballot_sync(0xffffffffu, c != 0.f);
  int* rows = listed + (threadIdx.x & ~31);
  float* row_counts = listed_count + (threadIdx.x & ~31);
  if (c != 0.f) {
    const int rank = __popc(touched & ((1u << lane) - 1u));
    rows[rank] = lane;
    row_counts[rank] = c;
    if (zero_counts) counts[own] = 0.f;
  }
  __syncwarp();
  const int groups = 32 / lanes, group = lane / lanes, sub = lane - group * lanes;
  const int n_touched = __popc(touched);
  for (int k = group; k < n_touched; k += groups) {
    const int64_t row = first + rows[k];
    const float cnt = row_counts[k];
    const int64_t base = row * d;
    if (vec) {
      float4* tv = reinterpret_cast<float4*>(table + base);
      float4* sv = reinterpret_cast<float4*>(sums + base);
      for (int q = sub; q < d / 4; q += lanes) {
        const float4 s = sv[q];
        float4 v = tv[q];
        v.x -= lr * (s.x / cnt);
        v.y -= lr * (s.y / cnt);
        v.z -= lr * (s.z / cnt);
        v.w -= lr * (s.w / cnt);
        tv[q] = v;
        sv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int q = sub; q < d; q += lanes) {
        table[base + q] -= lr * (sums[base + q] / cnt);
        sums[base + q] = 0.f;
      }
    }
  }
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

// Lanes a row: a power of two covering cols, at most a warp.
int lanes_for(int cols) {
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes *= 2;
  return lanes;
}

}  // namespace

extern "C" {

// counts == NULL leaves the counts alone (they were taken by an earlier
// call and are shared, e.g. a second table updated from the same multiset).
int ebt_scatter_add_rows(void* sums, void* counts, const void* idx,
                         const void* grads, long long m, int d, void* stream) {
  if (m == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(sums) |
                          reinterpret_cast<uintptr_t>(grads);
  const bool vec = d % 4 == 0 && align % 16 == 0;
  const int lanes = lanes_for(vec ? d / 4 : d);
  scatter_rows_kernel<<<blocks_for(m * lanes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<const int32_t*>(idx), static_cast<const float*>(grads), m, d,
      lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

// table -= lr * sums / counts on the n rows whose count is not 0; those
// rows of sums are zeroed, and of counts when zero_counts.
int ebt_mean_combine(void* table, void* sums, void* counts, float lr,
                     long long n, int d, int zero_counts, void* stream) {
  if (n == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(sums);
  const bool vec = d % 4 == 0 && align % 16 == 0;
  mean_rows_combine_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(sums),
      static_cast<float*>(counts), lr, n, d, lanes_for(vec ? d / 4 : d), vec,
      zero_counts != 0);
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
  const int lanes = lanes_for(cols);
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
