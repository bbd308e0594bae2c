// K8 `edge_metrics`: Adamic-Adar, Jaccard, resource allocation and
// preferential attachment of (src, dst) pairs over a CSR with sorted rows.
//
// Replaces embiggen_tpu/ops/edge_metrics.py::edge_metrics. Semantics, held
// to the reference: the endpoint of lower degree (src on a tie) is expanded;
// its first min(degree, cap) arcs, in row order, are the candidates; a
// candidate counts once per arc (duplicate arcs of a multigraph each count)
// when it occurs anywhere in the other endpoint's whole row. A common
// neighbour c of degree cdeg adds 1 / log(cdeg) to Adamic-Adar when
// cdeg > 1 and 1 / cdeg to resource allocation. Jaccard is
// inter / (deg[src] + deg[dst] - inter) on the full, uncapped degrees (0
// when that is 0), and preferential attachment deg[src] * deg[dst] in f32.
// Degrees are row lengths.
//
// What bounds it on the H100: dependent loads. A lower-bound search of each
// candidate in the other row from device memory is log2(deg) + 2 reads,
// each waiting on the one before, so a pair was a chain of about ten
// (ids, row_ptr, the expanded row, the search, the hit's degree). The
// arithmetic is nothing beside that.
//
// What the design does about it: a group of G = 8 lanes a pair, so four
// pairs share a warp (groups of 16 and 32 lanes measured slower on the
// slice graph and on its planted-hub twin; PERF.md). Once row_ptr is
// read, the group starts the loads of both rows together, coalesced: each
// lane its first candidate of the expanded
// row and kHeld ids of the other row (lane l ids l kHeld .. l kHeld +
// kHeld - 1, INT_MAX past the row's end). Membership is then a search over
// the registers: log2 G shuffle steps find the last lane whose first held
// id is at most the candidate, and kHeld shuffles compare the candidate
// with that lane's ids; no global read waits on another. A row longer
// than G kHeld ids (a hub's), chosen by its length, is held as G kHeld
// evenly spaced samples instead: the same search brackets the candidate
// between two samples, and a lower-bound search in device memory over the
// bracket (about log2(deg / (G kHeld)) reads) finishes it, two rounds'
// candidates in lock step (`ebt::sorted_ranges_contain`). The only
// dependent read left on a short row is a hit's degree. A lane takes two
// rounds' candidates at a time and loads the next two while these are
// searched. Each lane sums in registers, a butterfly of shuffles reduces
// the group, and its first lane writes the pair's four floats as one
// 16-byte store. The sums run in another order than the reference's.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "csr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // lanes a pair (G)
constexpr int kHeld = 8;  // ids of the other row a lane holds
constexpr unsigned kFullMask = 0xffffffffu;

// The group holds G kHeld ids of a sorted row, every `stride`-th (lane l
// ids l kHeld .. l kHeld + kHeld - 1 of the samples, INT_MAX past the
// row's end). Sets *hit when c is a held id, and returns the index of the
// last held id below c (-1 when none is): on a row held whole (stride 1)
// that settles c, else c can only lie between that sample and the next.
// Every lane of the warp calls it.
__device__ __forceinline__ int held_bracket(const int32_t (&held)[kHeld], int32_t c, bool* hit) {
  int lo = 0;  // the last lane whose first id is at most c (or lane 0)
#pragma unroll
  for (int step = kGroup / 2; step > 0; step >>= 1) {
    if (__shfl_sync(kFullMask, held[0], lo + step, kGroup) <= c) lo += step;
  }
  int below = 0;
  bool found = false;
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    const int32_t x = __shfl_sync(kFullMask, held[r], lo, kGroup);
    below += x < c;
    found |= x == c;
  }
  *hit = found;
  return lo * kHeld + below - 1;
}

__global__ void __launch_bounds__(kThreads) edge_metrics_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n, int32_t cap, float4* __restrict__ out) {
  const int sub = threadIdx.x & (kGroup - 1);
  const int64_t block_first = blockIdx.x * static_cast<int64_t>(kThreads / kGroup);
  if (block_first + (threadIdx.x >> 5) * (32 / kGroup) >= n) return;  // uniform across the warp
  // A group past the end works on the last pair and writes nothing.
  const int64_t mine = block_first + threadIdx.x / kGroup;
  const int64_t pair = mine < n ? mine : n - 1;
  const int32_t s = __ldg(src + pair);
  const int32_t d = __ldg(dst + pair);
  const int32_t s_start = __ldg(row_ptr + s);
  const int32_t s_deg = __ldg(row_ptr + s + 1) - s_start;
  const int32_t d_start = __ldg(row_ptr + d);
  const int32_t d_deg = __ldg(row_ptr + d + 1) - d_start;
  const bool swap = d_deg < s_deg;
  const int32_t a_start = swap ? d_start : s_start;
  const int32_t b_start = swap ? s_start : d_start;
  const int32_t b_deg = swap ? s_deg : d_deg;
  const int32_t n_cand = min(swap ? d_deg : s_deg, cap);
  // Every stride-th id of the other row: all of it when it fits.
  const int32_t stride = (b_deg + kGroup * kHeld - 1) / (kGroup * kHeld);

  // This lane's candidates of two rounds at a time (-1: none).
  int32_t next0 = sub < n_cand ? __ldg(col_idx + a_start + sub) : -1;
  int32_t next1 = kGroup + sub < n_cand ? __ldg(col_idx + a_start + kGroup + sub) : -1;
  int32_t held[kHeld];
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    const int32_t k = (sub * kHeld + r) * stride;
    held[r] = k < b_deg ? __ldg(col_idx + b_start + k) : INT_MAX;
  }
  const int rounds = __reduce_max_sync(kFullMask, (n_cand + kGroup - 1) / kGroup);
  float inter = 0.0f, aa = 0.0f, ra = 0.0f;
  for (int round = 0; round < rounds; round += 2) {
    const int32_t c0 = next0, c1 = next1;
    const int32_t k_next = (round + 2) * kGroup + sub;
    next0 = k_next < n_cand ? __ldg(col_idx + a_start + k_next) : -1;
    next1 = k_next + kGroup < n_cand ? __ldg(col_idx + a_start + k_next + kGroup) : -1;
    bool hit0, hit1;
    const int below0 = held_bracket(held, c0, &hit0);
    const int below1 = held_bracket(held, c1, &hit1);
    if (stride > 1) {
      // Between samples below and below + 1: ids below stride + 1 ..
      // below stride + stride - 1 (an empty range where that settles it).
      const bool open0 = !hit0 && below0 >= 0, open1 = !hit1 && below1 >= 0;
      const int32_t lo0 = below0 * stride + 1, lo1 = below1 * stride + 1;
      bool in0, in1;
      ebt::sorted_ranges_contain(
          col_idx, b_start + lo0, open0 ? b_start + min(lo0 + stride - 1, b_deg) : b_start + lo0,
          c0, b_start + lo1, open1 ? b_start + min(lo1 + stride - 1, b_deg) : b_start + lo1,
          c1, &in0, &in1);
      hit0 |= in0;
      hit1 |= in1;
    }
    const bool h0 = hit0 && c0 >= 0, h1 = hit1 && c1 >= 0;
    const int32_t d0 = h0 ? __ldg(row_ptr + c0 + 1) - __ldg(row_ptr + c0) : 0;
    const int32_t d1 = h1 ? __ldg(row_ptr + c1 + 1) - __ldg(row_ptr + c1) : 0;
    if (h0) {
      inter += 1.0f;
      if (d0 > 1) aa += 1.0f / logf(static_cast<float>(d0));
      if (d0 > 0) ra += 1.0f / static_cast<float>(d0);
    }
    if (h1) {
      inter += 1.0f;
      if (d1 > 1) aa += 1.0f / logf(static_cast<float>(d1));
      if (d1 > 0) ra += 1.0f / static_cast<float>(d1);
    }
  }
#pragma unroll
  for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
    inter += __shfl_xor_sync(kFullMask, inter, offset);
    aa += __shfl_xor_sync(kFullMask, aa, offset);
    ra += __shfl_xor_sync(kFullMask, ra, offset);
  }
  if (sub == 0 && mine < n) {
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
                     const void* dst, long long n, int cap, void* out, void* stream) {
  if (n == 0) return 0;
  constexpr long long kPairs = kThreads / kGroup;
  const unsigned blocks = static_cast<unsigned>((n + kPairs - 1) / kPairs);
  edge_metrics_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n, cap,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
