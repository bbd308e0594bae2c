// K5 `csr_edge_ids` and K6 `edge_prediction_mini_batch`: arc membership
// and the GCN's edge minibatch; K20b `edge_chunk` / `chunk_mask`: the arcs
// of one chunk in CSR order.
//
// K5 replaces embiggen_tpu/ops/walks.py::csr_has_edges / csr_edge_ids: for
// each (src, dst) query, the arc id of dst's first arc in src's sorted CSR
// row (the lower bound), or the sentinel n_arcs when dst is not there.
// K6 replaces embiggen_tpu/ops/negatives.py::edge_prediction_mini_batch
// (with arc_sources): the first n_pos slots are uniform arcs, the rest
// negatives with degree-proportional (or uniform) endpoints, each redrawn
// up to n_attempts times while it is an arc of the graph to avoid (by
// default the sampled graph) or a self-loop; the redraw after the last
// check is kept unchecked, as in the reference.
//
// What bounds them on the H100: random 32-byte sectors fetched from device
// memory. A thread a query or slot puts 2^20 independent chains in flight,
// enough to hide each load's latency, so the time follows the number of
// sectors fetched, at the card's rate for independent random fetches
// (about 4e10 a second, scripts/edge_batch_probe.py); row_ptr (4 MB on the
// slice graph) stays in L2. A group of lanes a query, sweeping its row,
// was measured slower: it reads more sectors (PERF.md).
//
// What the design does about it: fewer sectors a call. A search is
// `ebt::guided_lower_bound` (csr.cuh), which reads first the sector where
// an even spread of the row's heads puts dst: one sector settles nearly
// every search on the slice graph, where a bisection touches two or three.
// A positive reads its arc's (source, head) as one 8-byte record where the
// graph carries them (`Graph.device(with_arc_pairs=True)`), one sector in
// place of two. The draws do not depend on either: the Philox counters
// stay (slot, attempt, offset) and the positives' (slot, 0, offset), so
// the same key and offset give the same batch, draw for draw, as before.
// A fit's workspace (`BatchDraws.edges`) writes the labels once, so a
// launch after its first writes only the pairs.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"
#include "philox.cuh"

namespace {

using ebt::arc_source;
using ebt::guided_lower_bound;

constexpr int kThreads = 256;

__global__ void csr_edge_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n, int32_t n_arcs, uint32_t n_nodes, int32_t* __restrict__ ids,
    uint8_t* __restrict__ found) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int32_t s = __ldg(src + i);
  bool hit;
  const int32_t at = guided_lower_bound(col_idx, __ldg(row_ptr + s), __ldg(row_ptr + s + 1),
                                        __ldg(dst + i), n_nodes, &hit);
  if (ids != nullptr) ids[i] = hit ? at : n_arcs;
  if (found != nullptr) found[i] = hit ? 1 : 0;
}

struct EdgeBatch {
  const int32_t* row_ptr;
  const int32_t* col_idx;
  const int32_t* sources;
  const int2* pairs;
  const int32_t* avoid_row_ptr;
  const int32_t* avoid_col_idx;
  int32_t n_nodes;
  uint32_t avoid_nodes;
  uint32_t n_arcs;
  int64_t n_pos, n;
  int scale_free, n_attempts;
  int32_t* out_src;
  int32_t* out_dst;
  float* labels;
  uint32_t k0, k1, offset;
};

// A negative slot's draw at one attempt: its two endpoints.
__device__ __forceinline__ void negative_draw(const EdgeBatch& a, int64_t slot, int attempt,
                                              int32_t* s, int32_t* d) {
  const Philox4 r = philox4x32_10(
      Philox4{static_cast<uint32_t>(slot), static_cast<uint32_t>(slot >> 32),
              static_cast<uint32_t>(attempt), a.offset}, a.k0, a.k1);
  if (a.scale_free) {
    // The head of a uniform arc is degree-distributed.
    *s = __ldg(a.col_idx + bounded(r.x, a.n_arcs));
    *d = __ldg(a.col_idx + bounded(r.y, a.n_arcs));
  } else {
    *s = static_cast<int32_t>(bounded(r.x, static_cast<uint32_t>(a.n_nodes)));
    *d = static_cast<int32_t>(bounded(r.y, static_cast<uint32_t>(a.n_nodes)));
  }
}

__global__ void edge_minibatch_kernel(const EdgeBatch a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.n) return;
  if (i < a.n_pos) {
    const Philox4 r = philox4x32_10(
        Philox4{static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, a.offset},
        a.k0, a.k1);
    const int32_t arc = static_cast<int32_t>(bounded(r.x, a.n_arcs));
    if (a.pairs != nullptr) {
      const int2 pair = __ldg(a.pairs + arc);
      a.out_src[i] = pair.x;
      a.out_dst[i] = pair.y;
    } else {
      a.out_src[i] = a.sources != nullptr ? __ldg(a.sources + arc)
                                          : arc_source(a.row_ptr, a.n_nodes, arc);
      a.out_dst[i] = __ldg(a.col_idx + arc);
    }
    if (a.labels != nullptr) a.labels[i] = 1.0f;
    return;
  }
  int32_t s = 0, d = 0;
  for (int attempt = 0; attempt <= a.n_attempts; ++attempt) {
    negative_draw(a, i, attempt, &s, &d);
    if (attempt == a.n_attempts) break;
    if (s == d) continue;
    bool is_arc;
    guided_lower_bound(a.avoid_col_idx, __ldg(a.avoid_row_ptr + s),
                       __ldg(a.avoid_row_ptr + s + 1), d, a.avoid_nodes, &is_arc);
    if (!is_arc) break;
  }
  a.out_src[i] = s;
  a.out_dst[i] = d;
  if (a.labels != nullptr) a.labels[i] = 0.0f;
}

__global__ void edge_chunk_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ sources, int32_t n_nodes, int64_t n_arcs,
    int64_t start, int64_t n, int32_t* __restrict__ out_src,
    int32_t* __restrict__ out_dst, uint8_t* __restrict__ mask) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const int64_t pos = start + t;
  if (mask != nullptr) mask[t] = pos < n_arcs ? 1 : 0;
  if (out_dst == nullptr) return;
  const int64_t last = n_arcs > 0 ? n_arcs - 1 : 0;
  const int32_t idx = static_cast<int32_t>(pos < 0 ? 0 : (pos > last ? last : pos));
  out_src[t] = sources != nullptr ? sources[idx] : arc_source(row_ptr, n_nodes, idx);
  out_dst[t] = col_idx[idx];
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// ids (int32) and found (one byte per query) may each be NULL; n_nodes is
// row_ptr's length - 1 (every head is below it).
int ebt_csr_edge_ids(const void* row_ptr, const void* col_idx, const void* src,
                     const void* dst, long long n, int n_arcs, int n_nodes, void* ids,
                     void* found, void* stream) {
  if (n == 0) return 0;
  csr_edge_ids_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n, n_arcs,
      static_cast<uint32_t>(n_nodes), static_cast<int32_t*>(ids),
      static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

// pairs ([n_arcs] (source, head), may be NULL) gives a positive its ends in
// one load; else sources (NULL: a search over row_ptr) and col_idx.
// avoid_row_ptr / avoid_col_idx / avoid_nodes: the CSR whose arcs a negative
// must not be (the sampled graph's for the reference's default). labels ==
// NULL leaves them unwritten (a workspace's, written by its first launch).
// n_attempts == 0 keeps the first negative draw unchecked.
int ebt_edge_minibatch(const void* row_ptr, const void* col_idx, const void* sources,
                       const void* pairs, const void* avoid_row_ptr,
                       const void* avoid_col_idx, int avoid_nodes, int n_nodes,
                       long long n_arcs, long long n_pos, long long n, int scale_free,
                       int n_attempts, void* out_src, void* out_dst, void* labels,
                       unsigned long long seed, unsigned int offset, void* stream) {
  if (n == 0) return 0;
  const EdgeBatch a{static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
                    static_cast<const int32_t*>(sources), static_cast<const int2*>(pairs),
                    static_cast<const int32_t*>(avoid_row_ptr),
                    static_cast<const int32_t*>(avoid_col_idx), n_nodes,
                    static_cast<uint32_t>(avoid_nodes), static_cast<uint32_t>(n_arcs), n_pos, n,
                    scale_free, n_attempts, static_cast<int32_t*>(out_src),
                    static_cast<int32_t*>(out_dst), static_cast<float*>(labels),
                    static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), offset};
  edge_minibatch_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Slots [start, start + n) of the arcs in CSR order. out_src and out_dst
// are both NULL (the mask alone, which is then not NULL) or both set, and
// then n_arcs > 0; sources may be NULL (a search over row_ptr).
int ebt_edge_chunk(const void* row_ptr, const void* col_idx, const void* sources,
                   int n_nodes, long long n_arcs, long long start, long long n,
                   void* out_src, void* out_dst, void* mask, void* stream) {
  if (n == 0) return 0;
  edge_chunk_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(sources), n_nodes, n_arcs, start, n,
      static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
