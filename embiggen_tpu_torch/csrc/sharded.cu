// K17c and K17d: the owned-row gather and scatter of a row-sharded table.
// A rank holds rows [lo, lo + S) of a table (S = shard_rows, D floats a
// row); ids are global, int32.
//
// K17d `owned_gather` replaces embiggen_tpu/parallel/sharded_table.py::
// _gather_rows (:68-74), whose psum follows it in the wrapper:
//   out[m] = shard[idx[m] - lo] where lo <= idx[m] < lo + S, else 0.
// K17c `owned_scatter` replaces _scatter_add_owned (:77-81) and
// _mean_scatter_owned (:84-107): on owned rows only,
//   shard[idx[m] - lo] += scale * (grads[m] / max(den, 1)),
// with den the row's count (row_den [S], from `owned_count`), the entry's
// own count (entry_den [M]: a compact table's sums, one entry a row, where
// an entry of count 0 is skipped whole) or 1 ("sum" mode). The count
// launch adds 1 per owned entry into counts [S].
//
// What bounds them on the H100: bytes. The gather reads the ids and the
// owned rows and writes [M, D]; the scatter reads the ids, the gradient
// rows and the counts, and reads and writes the owned rows. At S1's batch
// (32768 walks of 64 and their 10 negatives, about 0.98M distinct ids of a
// 1M-node, D-128 table cut in 4 shards) one shard's gather moves about
// 0.63 GB.
//
// What the design does about it: a group of lanes a row (a power of two,
// at most a warp), float4 columns when D % 4 == 0 and the rows are 16-byte
// aligned. The scatter adds with atomics (an id may repeat; sm_90 adds
// four floats in one atomic), so repeated rows add in no fixed order; the
// compact tables name each row once, and then the result is fixed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void owned_gather_kernel(const float* __restrict__ shard,
                                    int64_t shard_rows, int64_t lo,
                                    const int32_t* __restrict__ idx, int64_t m,
                                    int d, float* __restrict__ out, int lanes,
                                    bool vec) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / lanes;
  const int lane = static_cast<int>(t - row * lanes);
  if (row >= m) return;
  const int64_t local = static_cast<int64_t>(idx[row]) - lo;
  const bool owned = local >= 0 && local < shard_rows;
  if (vec) {
    float4* o = reinterpret_cast<float4*>(out + row * d);
    const float4* s = reinterpret_cast<const float4*>(shard + local * d);
    for (int c = lane; c < d / 4; c += lanes) {
      o[c] = owned ? __ldg(s + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = lane; c < d; c += lanes) {
      out[row * d + c] = owned ? __ldg(shard + local * d + c) : 0.f;
    }
  }
}

__global__ void owned_count_kernel(float* __restrict__ counts,
                                   int64_t shard_rows, int64_t lo,
                                   const int32_t* __restrict__ idx,
                                   int64_t m) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= m) return;
  const int64_t local = static_cast<int64_t>(idx[t]) - lo;
  if (local >= 0 && local < shard_rows) atomicAdd(counts + local, 1.f);
}

__global__ void owned_scatter_kernel(float* __restrict__ shard,
                                     int64_t shard_rows, int64_t lo,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ grads,
                                     int64_t m, int d,
                                     const float* __restrict__ row_den,
                                     const float* __restrict__ entry_den,
                                     float scale, int lanes, bool vec) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / lanes;
  const int lane = static_cast<int>(t - row * lanes);
  if (row >= m) return;
  const int64_t local = static_cast<int64_t>(idx[row]) - lo;
  if (local < 0 || local >= shard_rows) return;
  float den = 1.f;
  if (row_den != nullptr) {
    den = row_den[local];
  } else if (entry_den != nullptr) {
    den = entry_den[row];
    if (den == 0.f) return;
  }
  den = fmaxf(den, 1.f);
  if (vec) {
    const float4* g = reinterpret_cast<const float4*>(grads + row * d);
    float4* s = reinterpret_cast<float4*>(shard + local * d);
    for (int c = lane; c < d / 4; c += lanes) {
      const float4 v = __ldg(g + c);
      atomicAdd(s + c, make_float4(scale * (v.x / den), scale * (v.y / den),
                                   scale * (v.z / den), scale * (v.w / den)));
    }
  } else {
    for (int c = lane; c < d; c += lanes) {
      atomicAdd(shard + local * d + c, scale * (__ldg(grads + row * d + c) / den));
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

bool aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16) == 0;
}

}  // namespace

extern "C" {

int ebt_owned_gather(const void* shard, long long shard_rows, long long lo,
                     const void* idx, long long m, int d, void* out,
                     void* stream) {
  if (m == 0 || d == 0) return 0;
  const bool vec = d % 4 == 0 && aligned(shard, out);
  const int lanes = lanes_for(vec ? d / 4 : d);
  owned_gather_kernel<<<blocks_for(m * lanes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(shard), shard_rows, lo,
      static_cast<const int32_t*>(idx), m, d, static_cast<float*>(out), lanes,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int ebt_owned_count(void* counts, long long shard_rows, long long lo,
                    const void* idx, long long m, void* stream) {
  if (m == 0) return 0;
  owned_count_kernel<<<blocks_for(m), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(counts), shard_rows, lo,
      static_cast<const int32_t*>(idx), m);
  return static_cast<int>(cudaGetLastError());
}

// row_den ([shard_rows]) or entry_den ([m]) or neither (den 1).
int ebt_owned_scatter(void* shard, long long shard_rows, long long lo,
                      const void* idx, const void* grads, long long m, int d,
                      const void* row_den, const void* entry_den, float scale,
                      void* stream) {
  if (m == 0 || d == 0) return 0;
  const bool vec = d % 4 == 0 && aligned(shard, grads);
  const int lanes = lanes_for(vec ? d / 4 : d);
  owned_scatter_kernel<<<blocks_for(m * lanes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(shard), shard_rows, lo,
      static_cast<const int32_t*>(idx), static_cast<const float*>(grads), m, d,
      static_cast<const float*>(row_den), static_cast<const float*>(entry_den),
      scale, lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
