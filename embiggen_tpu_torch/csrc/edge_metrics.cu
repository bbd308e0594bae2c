// K8 `edge_metrics`: Adamic-Adar, Jaccard, resource allocation and
// preferential attachment of (src, dst) pairs over a CSR with sorted rows.
//
// Replaces embiggen_tpu/ops/edge_metrics.py::edge_metrics. Semantics, held
// to the reference: the endpoint of lower degree (src on a tie) is expanded;
// its first min(degree, cap) arcs, in row order, are the candidates; a
// candidate counts once per arc (duplicate arcs of a multigraph each count)
// when a lower-bound search finds it anywhere in the other endpoint's whole
// row. A common neighbour c of degree cdeg adds 1 / log(cdeg) to Adamic-Adar
// when cdeg > 1 and 1 / cdeg to resource allocation. Jaccard is
// inter / (deg[src] + deg[dst] - inter) on the full, uncapped degrees (0
// when that is 0), and preferential attachment deg[src] * deg[dst] in f32.
// Degrees are row lengths.
//
// What bounds it on the H100: dependent loads. Each candidate costs one read
// of the expanded row, log2(deg[b]) + 2 reads of a search in the other row
// (each waiting on the one before) and, on a hit, two reads of row_ptr. The
// arithmetic is nothing beside that.
//
// What the design does about it: one warp per pair. Lane l takes candidates
// l, l + 32, ... so the expanded row is read coalesced, and all lanes search
// the same row b, so each search step's loads fall on the same few sectors
// and mostly hit in L1. Each lane accumulates its own sums in registers; a
// butterfly of warp shuffles reduces them, and lane 0 writes the pair's four
// floats as one 16-byte store. On a graph of average degree 20 a pair has
// about 20 candidates, so about a third of the warp idles; sub-warp groups
// for short rows are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void edge_metrics_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n, int32_t cap, float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) + (threadIdx.x >> 5);
  if (pair >= n) return;  // the whole warp leaves together
  const int32_t s = src[pair];
  const int32_t d = dst[pair];
  const int32_t s_start = row_ptr[s];
  const int32_t s_deg = row_ptr[s + 1] - s_start;
  const int32_t d_start = row_ptr[d];
  const int32_t d_deg = row_ptr[d + 1] - d_start;
  const bool swap = d_deg < s_deg;
  const int32_t a_start = swap ? d_start : s_start;
  const int32_t b = swap ? s : d;
  const int32_t n_cand = min(swap ? d_deg : s_deg, cap);

  float inter = 0.0f, aa = 0.0f, ra = 0.0f;
  for (int32_t k = lane; k < n_cand; k += 32) {
    const int32_t c = col_idx[a_start + k];
    bool hit;
    ebt::arc_lower_bound(row_ptr, col_idx, b, c, &hit);
    if (hit) {
      const float cdeg = static_cast<float>(row_ptr[c + 1] - row_ptr[c]);
      inter += 1.0f;
      if (cdeg > 1.0f) aa += 1.0f / logf(cdeg);
      if (cdeg > 0.0f) ra += 1.0f / cdeg;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    inter += __shfl_xor_sync(kFullMask, inter, offset);
    aa += __shfl_xor_sync(kFullMask, aa, offset);
    ra += __shfl_xor_sync(kFullMask, ra, offset);
  }
  if (lane == 0) {
    const float ds = static_cast<float>(s_deg);
    const float dd = static_cast<float>(d_deg);
    const float uni = ds + dd - inter;
    const float jac = uni > 0.0f ? inter / fmaxf(uni, 1.0f) : 0.0f;
    out[pair] = make_float4(aa, jac, ra, ds * dd);
  }
}

}  // namespace

extern "C" {

// out: [n, 4] float32, 16-byte aligned.
int ebt_edge_metrics(const void* row_ptr, const void* col_idx, const void* src,
                     const void* dst, long long n, int cap, void* out,
                     void* stream) {
  if (n == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  edge_metrics_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n, cap,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
