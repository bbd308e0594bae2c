// K5 `csr_edge_ids` and K6 `edge_prediction_mini_batch`: arc membership
// and the GCN's edge minibatch; K20b `edge_chunk` / `chunk_mask`: the arcs
// of one chunk in CSR order.
//
// K5 replaces embiggen_tpu/ops/walks.py::csr_has_edges / csr_edge_ids: for
// each (src, dst) query, a lower-bound binary search in src's sorted CSR
// row gives the arc id, or the sentinel n_arcs when dst is not there.
// K6 replaces embiggen_tpu/ops/negatives.py::edge_prediction_mini_batch
// (with arc_sources): the first n_pos slots are uniform arcs, the rest
// negatives with degree-proportional (or uniform) endpoints, each redrawn
// up to n_attempts times while it is an arc or a self-loop; the redraw
// after the last check is kept unchecked, as in the reference.
//
// What bounds them on the H100: dependent loads. A search is
// log2(degree) + 2 reads of which each waits on the one before; a
// positive slot is two reads after one draw; a negative slot is up to
// (n_attempts + 1) draws, each with two gathers and one search. The
// arithmetic is nothing beside that.
//
// What the design does about it: one thread per query or slot, so the
// search never leaves registers and the JAX version's fixed 32-round
// masked sweep over all queries becomes a loop that ends with its row;
// latency is hidden by the number of threads in flight (2^20 slots fill
// the card's 132 SMs many times over). K6 runs K5's search as a device
// function, so a slot's redraws cost no extra launch. Philox counters are
// (slot, attempt), so the draws do not depend on the launch order.
//
// K20b replaces embiggen_tpu/ops/negatives.py::edge_chunk and chunk_mask:
// slot t of chunk i is arc idx = clamp(i * size + t, 0, max(n_arcs - 1, 0)),
// its source (a gather from `sources`, else K6's search over row_ptr), its
// destination col_idx[idx], and the mask i * size + t < n_arcs. It is
// bound by bytes: each slot reads two ints and writes two ints and a byte,
// in order, so a thread a slot streams them; the search, where there is no
// `sources`, adds log2(N) dependent reads of a row_ptr that stays in L2.
// chunk_mask launches it without the id outputs.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"
#include "philox.cuh"

namespace {

using ebt::arc_lower_bound;
using ebt::arc_source;

constexpr int kThreads = 256;

__global__ void csr_edge_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n, int32_t n_arcs, int32_t* __restrict__ ids,
    uint8_t* __restrict__ found) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bool hit;
  const int32_t lo = arc_lower_bound(row_ptr, col_idx, src[i], dst[i], &hit);
  if (ids != nullptr) ids[i] = hit ? lo : n_arcs;
  if (found != nullptr) found[i] = hit ? 1 : 0;
}

__global__ void edge_minibatch_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ sources, int32_t n_nodes, uint32_t n_arcs,
    int64_t n_pos, int64_t n, int scale_free, int n_attempts,
    int32_t* __restrict__ out_src, int32_t* __restrict__ out_dst,
    float* __restrict__ labels, uint32_t k0, uint32_t k1, uint32_t offset) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t lo = static_cast<uint32_t>(i), hi = static_cast<uint32_t>(i >> 32);
  if (i < n_pos) {
    const Philox4 r = philox4x32_10(Philox4{lo, hi, 0u, offset}, k0, k1);
    const int32_t arc = static_cast<int32_t>(bounded(r.x, n_arcs));
    out_src[i] = sources != nullptr ? sources[arc]
                                    : arc_source(row_ptr, n_nodes, arc);
    out_dst[i] = col_idx[arc];
    labels[i] = 1.0f;
    return;
  }
  int32_t s = 0, d = 0;
  for (int attempt = 0; attempt <= n_attempts; ++attempt) {
    const Philox4 r = philox4x32_10(
        Philox4{lo, hi, static_cast<uint32_t>(attempt), offset}, k0, k1);
    if (scale_free) {
      // The head of a uniform arc is degree-distributed.
      s = col_idx[bounded(r.x, n_arcs)];
      d = col_idx[bounded(r.y, n_arcs)];
    } else {
      s = static_cast<int32_t>(bounded(r.x, static_cast<uint32_t>(n_nodes)));
      d = static_cast<int32_t>(bounded(r.y, static_cast<uint32_t>(n_nodes)));
    }
    if (attempt == n_attempts) break;
    bool is_arc = false;
    if (s != d) arc_lower_bound(row_ptr, col_idx, s, d, &is_arc);
    if (s != d && !is_arc) break;
  }
  out_src[i] = s;
  out_dst[i] = d;
  labels[i] = 0.0f;
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

// ids (int32) and found (one byte per query) may each be NULL.
int ebt_csr_edge_ids(const void* row_ptr, const void* col_idx, const void* src,
                     const void* dst, long long n, int n_arcs, void* ids,
                     void* found, void* stream) {
  if (n == 0) return 0;
  csr_edge_ids_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n,
      n_arcs, static_cast<int32_t*>(ids), static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

// sources == NULL finds each positive's source by a search over row_ptr.
// n_attempts == 0 keeps the first negative draw unchecked.
int ebt_edge_minibatch(const void* row_ptr, const void* col_idx,
                       const void* sources, int n_nodes, long long n_arcs,
                       long long n_pos, long long n, int scale_free,
                       int n_attempts, void* out_src, void* out_dst,
                       void* labels, unsigned long long seed,
                       unsigned int offset, void* stream) {
  if (n == 0) return 0;
  edge_minibatch_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(sources), n_nodes,
      static_cast<uint32_t>(n_arcs), n_pos, n, scale_free, n_attempts,
      static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<float*>(labels), static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset);
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
