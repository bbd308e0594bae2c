// K14: the minibatch samplers of the edge and triple embedders.
//
// `siamese_batch` replaces embiggen_tpu/ops/negatives.py::siamese_mini_batch
// (with arc_sources): per slot one uniform arc (src, dst), one node drawn
// degree-proportional (the head of a second uniform arc) or uniform, and a
// fair coin that puts that node in place of src or of dst, giving the
// corrupted triple (csrc, cdst); with types, the arc's edge type, or 0 when
// the graph has none.
// `line_batch` replaces embiggen_tpu/models/embedders/line.py::
// _LINEBase._sample_batch: per slot one uniform arc (src, dst) and K
// negatives drawn as above; with avoid_false_negatives, a negative that is
// an arc of src is redrawn once and the redraw is kept unchecked (no
// self-loop check), which is the reference's law.
//
// What bounds them on the H100: dependent loads and the launch. A slot is
// one or two reads after its draws (sources[arc], col_idx[arc], the drawn
// arc's head); a checked negative adds a lower-bound search of src's row,
// log2(degree) + 2 reads of which each waits on the one before. At the
// S6 batch (65,536 slots, K 5) the whole batch moves a few MB.
//
// What the design does about it: no shared state at all. Philox counters are
// (slot, word): word 0 gives the slot's arc, its node draw and its coin,
// word 1 + j the j-th negative and its redraw, so draws do not depend on
// the launch order or the grid. The siamese sampler takes a thread per slot;
// the LINE sampler a thread per negative (each recomputes its slot's arc from
// word 0, and the first writes the positive), so K searches of one slot run
// in parallel rather than one after another, and B * K threads keep enough
// loads in flight to hide their latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr.cuh"
#include "philox.cuh"

namespace {

using ebt::arc_lower_bound;
using ebt::arc_source;

constexpr int kThreads = 256;

// A node from 32 random bits: the head of a uniform arc (degree-
// proportional), or a uniform node id.
__device__ __forceinline__ int32_t draw_node(
    const int32_t* __restrict__ col_idx, uint32_t n_arcs, int32_t n_nodes,
    int scale_free, uint32_t r) {
  return scale_free ? col_idx[bounded(r, n_arcs)]
                    : static_cast<int32_t>(bounded(r, static_cast<uint32_t>(n_nodes)));
}

// The source of an arc: a gather when the graph was exported with
// sources, else a search over row_ptr.
__device__ __forceinline__ int32_t slot_source(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ sources,
    int32_t n_nodes, int32_t arc) {
  return sources != nullptr ? sources[arc] : arc_source(row_ptr, n_nodes, arc);
}

__global__ void siamese_batch_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ sources, const int32_t* __restrict__ edge_types,
    int32_t n_nodes, uint32_t n_arcs, int64_t n, int scale_free,
    int32_t* __restrict__ out_src, int32_t* __restrict__ out_dst,
    int32_t* __restrict__ out_csrc, int32_t* __restrict__ out_cdst,
    int32_t* __restrict__ out_etype, uint32_t k0, uint32_t k1, uint32_t offset) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const Philox4 r = philox4x32_10(
      Philox4{static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, offset}, k0, k1);
  const int32_t arc = static_cast<int32_t>(bounded(r.x, n_arcs));
  const int32_t src = slot_source(row_ptr, sources, n_nodes, arc);
  const int32_t dst = col_idx[arc];
  const int32_t node = draw_node(col_idx, n_arcs, n_nodes, scale_free, r.y);
  const bool corrupt_src = (r.z >> 31) != 0u;
  out_src[i] = src;
  out_dst[i] = dst;
  out_csrc[i] = corrupt_src ? node : src;
  out_cdst[i] = corrupt_src ? dst : node;
  if (out_etype != nullptr) out_etype[i] = edge_types != nullptr ? edge_types[arc] : 0;
}

__global__ void line_batch_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ sources, int32_t n_nodes, uint32_t n_arcs,
    int64_t n, int k, int scale_free, int avoid, int32_t* __restrict__ out_src,
    int32_t* __restrict__ out_dst, int32_t* __restrict__ out_neg, uint32_t k0,
    uint32_t k1, uint32_t offset) {
  const int per_slot = k > 0 ? k : 1;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n * per_slot) return;
  const int64_t slot = t / per_slot;
  const int j = static_cast<int>(t - slot * per_slot);
  const uint32_t lo = static_cast<uint32_t>(slot), hi = static_cast<uint32_t>(slot >> 32);
  const Philox4 r = philox4x32_10(Philox4{lo, hi, 0u, offset}, k0, k1);
  const int32_t arc = static_cast<int32_t>(bounded(r.x, n_arcs));
  const int32_t src = slot_source(row_ptr, sources, n_nodes, arc);
  if (j == 0) {
    out_src[slot] = src;
    out_dst[slot] = col_idx[arc];
  }
  if (j >= k) return;
  const Philox4 q = philox4x32_10(
      Philox4{lo, hi, 1u + static_cast<uint32_t>(j), offset}, k0, k1);
  int32_t neg = draw_node(col_idx, n_arcs, n_nodes, scale_free, q.x);
  if (avoid) {
    bool is_arc;
    arc_lower_bound(row_ptr, col_idx, src, neg, &is_arc);
    if (is_arc) neg = draw_node(col_idx, n_arcs, n_nodes, scale_free, q.y);
  }
  out_neg[t] = neg;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// sources == NULL finds each arc's source by a search over row_ptr;
// edge_types == NULL writes type 0; out_etype == NULL writes no types.
int ebt_siamese_batch(const void* row_ptr, const void* col_idx,
                      const void* sources, const void* edge_types, int n_nodes,
                      long long n_arcs, long long n, int scale_free,
                      void* out_src, void* out_dst, void* out_csrc,
                      void* out_cdst, void* out_etype, unsigned long long seed,
                      unsigned int offset, void* stream) {
  if (n == 0) return 0;
  siamese_batch_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(sources), static_cast<const int32_t*>(edge_types),
      n_nodes, static_cast<uint32_t>(n_arcs), n, scale_free,
      static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<int32_t*>(out_csrc), static_cast<int32_t*>(out_cdst),
      static_cast<int32_t*>(out_etype), static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset);
  return static_cast<int>(cudaGetLastError());
}

// out_neg is [n, k] row-major; avoid != 0 redraws once a negative that is
// an arc of its slot's source.
int ebt_line_batch(const void* row_ptr, const void* col_idx, const void* sources,
                   int n_nodes, long long n_arcs, long long n, int k,
                   int scale_free, int avoid, void* out_src, void* out_dst,
                   void* out_neg, unsigned long long seed, unsigned int offset,
                   void* stream) {
  if (n == 0) return 0;
  line_batch_kernel<<<blocks_for(n * (k > 0 ? k : 1)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(sources), n_nodes, static_cast<uint32_t>(n_arcs),
      n, k, scale_free, avoid, static_cast<int32_t*>(out_src),
      static_cast<int32_t*>(out_dst), static_cast<int32_t*>(out_neg),
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
