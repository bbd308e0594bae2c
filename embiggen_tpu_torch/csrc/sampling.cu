// K1 `first_order_walks`, K2 `nce_negatives` and the fused first-order batch
// `first_order_batch`: the samplers of the SkipGram step.
//
// K1 replaces embiggen_tpu/ops/walks.py::_sample_neighbor as looped by
// random_walks (first-order branch). K2 replaces
// embiggen_tpu/ops/negatives.py::sample_nodes_scale_free /
// sample_nodes_uniform behind negative_nodes_for_nce. The fused launch
// replaces the three of them as WalkBasedEmbedder._sample_batch
// (embiggen_tpu/models/embedders/walk_based.py:353-386) calls them: uniform
// starts tiled over the iterations, first-order walks, per-walk negatives.
//
// What bounds them on the H100: dependent gathers. Each walk step reads
// row_ptr[cur], row_ptr[cur + 1], then (weighted graphs) the alias entry,
// then col_idx[base + off], and the next step cannot start before the last
// read returns. The bytes are few (the byte bound of the S1 batch is about
// a tenth of its time); the time is memory latency times walk length. A K2
// draw is one random gather into col_idx.
//
// What the design does about it: one thread per walker runs all L - 1
// steps in one launch, so the walk never leaves registers between steps.
// Each step's Philox words depend only on (walker, step, key, offset), so
// the next step's words are computed while this step's loads are in
// flight. On a graph exported `with_walk_arcs` (unweighted) each arc carries
// a 16-byte record (head, head's row start, head's degree, 0), so a step is
// one dependent load: the record of the drawn arc holds the next row, and
// row_ptr leaves the chain (on an H100 at the S1 shapes 0.0794 against
// 0.0859 ms a launch, and 256 walkers alone 0.0304 against 0.0454;
// scripts/walk_chain_probe.py, which also measured a second 8-byte table
// beside col_idx, an aligned 16-byte row_ptr load, read-only loads, staging
// the walks in shared memory and a persisting L2 window on row_ptr, none
// faster). Weighted graphs read the row and the alias entry first. Blocks
// of kWalkThreads, so a batch of 32,768 walkers spreads over every SM. The
// walks are stored straight out: a step's strided store is off the chain
// (staging them measured slower). In the fused launch a walker draws its
// negatives after its walk, four gathers (one Philox call) in flight at a
// time: on an H100 at the S1 shapes 0.0881 ms a launch against 0.0795 for
// the walks alone, where issuing them beside the walk's own loads, four a
// step in its first steps or one every (L - 1) / K steps, took 0.0946 and
// 0.1053 (scripts/walk_chain_probe.py).
//
// Randomness is Philox4x32-10 keyed by the wrapper's 64-bit key, with the
// counter (walker, slot, stream, offset): stream kStart (slot 0, walker
// b mod B, so walkers b and b + B start together as the reference's
// jnp.tile gives them), kStep (slot t: word x the neighbour offset, word y
// the alias coin) and kNeg (slot j: the four words are negatives 4j..4j+3).
// Distinct streams or slots never share a counter, and a fit's batches
// differ in the offset. K2 draws from counter (i, i >> 32, 0xFFFFFFFF,
// offset), which no walk counter reaches (its stream word is at most 2).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
// Walkers a block: 32,768 walkers make 512 blocks, so all 132 SMs hold some.
constexpr int kWalkThreads = 64;

enum Stream : uint32_t { kStart = 0, kStep = 1, kNeg = 2 };

__device__ __forceinline__ Philox4 draw(uint32_t walker, uint32_t slot, Stream stream,
                                        uint32_t offset, uint32_t k0, uint32_t k1) {
  return philox4x32_10(Philox4{walker, slot, stream, offset}, k0, k1);
}

__device__ __forceinline__ uint32_t word(const Philox4& r, int q) {
  return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
}

// Where a walker's negatives come from and go: `count` per walker into
// out[0 .. count), the head of a uniform arc (src = col_idx, range = arcs) or
// a uniform node (src = nullptr, range = nodes). count == 0: none.
struct Negatives {
  const int32_t* src;
  uint32_t range;
  int count;
  int32_t* out;
};

// Negative j of a walker: word j % 4 of its Philox slot j / 4, the head of
// that uniform arc or that uniform node.
__device__ __forceinline__ int32_t negative(const Negatives& neg, const Philox4& r, int j) {
  const uint32_t u = bounded(word(r, j & 3), neg.range);
  return neg.src != nullptr ? __ldg(neg.src + u) : static_cast<int32_t>(u);
}

// A walker's negatives, after its walk: four gathers in flight at a time.
__device__ __forceinline__ void draw_negatives(const Negatives& neg, uint32_t walker,
                                               uint32_t offset, uint32_t k0, uint32_t k1) {
  for (int j = 0; j < neg.count; j += 4) {
    const Philox4 r = draw(walker, static_cast<uint32_t>(j >> 2), kNeg, offset, k0, k1);
    int32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < neg.count) v[q] = negative(neg, r, j + q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < neg.count) neg.out[j + q] = v[q];
    }
  }
}

// Where a walk reads its rows: row_ptr (and the alias tables when weighted),
// or the arcs' records (head, head's row start, head's degree, 0).
struct Rows {
  const int32_t* row_ptr;
  const int32_t* col_idx;
  const float* alias_prob;
  const int32_t* alias_idx;
  const int4* records;
};

// One walker's first-order walk of `walk_length` nodes from `cur` into
// out[0 .. walk_length).
template <bool kRecords>
__device__ __forceinline__ void walk_first_order(const Rows& g, int32_t cur, uint32_t walker,
                                                 int walk_length, uint32_t k0, uint32_t k1,
                                                 uint32_t offset, int32_t* out) {
  out[0] = cur;
  // With records, the current row rides along with the node.
  int32_t base = 0;
  uint32_t deg = 0;
  if (kRecords) {
    base = __ldg(g.row_ptr + cur);
    deg = static_cast<uint32_t>(__ldg(g.row_ptr + cur + 1) - base);
  }
  Philox4 r = draw(walker, 1, kStep, offset, k0, k1);
  for (int t = 1; t < walk_length; ++t) {
    if (!kRecords) {
      base = __ldg(g.row_ptr + cur);
      deg = static_cast<uint32_t>(__ldg(g.row_ptr + cur + 1) - base);
    }
    // The next step's words, while this step's loads are in flight.
    const Philox4 now = r;
    r = draw(walker, static_cast<uint32_t>(t + 1), kStep, offset, k0, k1);
    int32_t next = cur;
    // A zero-degree node is a trap: the walk stays put.
    if (deg > 0) {
      int32_t off = static_cast<int32_t>(bounded(now.x, deg));
      if (kRecords) {
        const int4 rec = __ldg(g.records + base + off);
        next = rec.x;
        base = rec.y;
        deg = static_cast<uint32_t>(rec.z);
      } else {
        if (g.alias_prob != nullptr) {
          // Walker alias draw: keep the slot with probability alias_prob,
          // else take its alias (an offset inside the same row).
          if (!(unit_float(now.y) < __ldg(g.alias_prob + base + off))) {
            off = __ldg(g.alias_idx + base + off);
          }
        }
        next = __ldg(g.col_idx + base + off);
      }
    }
    cur = next;
    out[t] = cur;
  }
}

template <bool kRecords>
__global__ void __launch_bounds__(kWalkThreads) first_order_walks_kernel(
    Rows g, const int32_t* __restrict__ starts, int32_t* __restrict__ walks, int64_t n_walkers,
    int walk_length, uint32_t k0, uint32_t k1, uint32_t offset) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= n_walkers) return;
  walk_first_order<kRecords>(g, __ldg(starts + b), static_cast<uint32_t>(b), walk_length, k0,
                             k1, offset, walks + b * walk_length);
}

template <bool kRecords>
__global__ void __launch_bounds__(kWalkThreads) first_order_batch_kernel(
    Rows g, uint32_t n_nodes, uint32_t n_arcs, int64_t batch_size, int64_t n_walkers,
    int walk_length, int n_negatives, int scale_free, int32_t* __restrict__ walks,
    int32_t* __restrict__ negs, uint32_t k0, uint32_t k1, uint32_t offset) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= n_walkers) return;
  const uint32_t start_key = static_cast<uint32_t>(b % batch_size);
  const int32_t start = static_cast<int32_t>(
      bounded(draw(start_key, 0, kStart, offset, k0, k1).x, n_nodes));
  const Negatives neg{scale_free ? g.col_idx : nullptr, scale_free ? n_arcs : n_nodes,
                      n_negatives, negs + b * n_negatives};
  walk_first_order<kRecords>(g, start, static_cast<uint32_t>(b), walk_length, k0, k1, offset,
                             walks + b * walk_length);
  draw_negatives(neg, static_cast<uint32_t>(b), offset, k0, k1);
}

__global__ void node_draws_kernel(const int32_t* __restrict__ col_idx,
                                  uint32_t n_arcs, uint32_t n_nodes,
                                  int32_t* __restrict__ out, int64_t n,
                                  uint32_t k0, uint32_t k1, uint32_t offset) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const Philox4 r = philox4x32_10(
      Philox4{static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32),
              0xFFFFFFFFu, offset},
      k0, k1);
  // Scale-free: the head of a uniform arc is degree-distributed.
  out[i] = col_idx != nullptr
               ? col_idx[bounded(r.x, n_arcs)]
               : static_cast<int32_t>(bounded(r.x, n_nodes));
}

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// The rows a walk reads; records only without alias tables (the wrapper
// never passes both).
Rows rows_of(const void* row_ptr, const void* col_idx, const void* alias_prob,
             const void* alias_idx, const void* records) {
  return Rows{static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
              static_cast<const float*>(alias_prob), static_cast<const int32_t*>(alias_idx),
              alias_prob == nullptr ? static_cast<const int4*>(records) : nullptr};
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launch (0 on success); the
// Python wrapper raises on anything else. Walk counters hold the walker in
// 32 bits: more than 2^32 - 1 walkers is refused (cudaErrorInvalidValue).

int ebt_first_order_walks(const void* row_ptr, const void* col_idx,
                          const void* alias_prob, const void* alias_idx, const void* records,
                          const void* starts, void* walks, long long n_walkers,
                          int walk_length, unsigned long long seed,
                          unsigned int offset, void* stream) {
  if (n_walkers == 0) return 0;
  if (n_walkers > 0xFFFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const Rows g = rows_of(row_ptr, col_idx, alias_prob, alias_idx, records);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n_walkers, kWalkThreads);
  const auto run = [&](auto kernel) {
    kernel<<<blocks, kWalkThreads, 0, s>>>(
        g, static_cast<const int32_t*>(starts), static_cast<int32_t*>(walks), n_walkers,
        walk_length, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), offset);
  };
  if (g.records != nullptr) {
    run(first_order_walks_kernel<true>);
  } else {
    run(first_order_walks_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batch of a first-order SkipGram / CBOW / Walklets step: n_walkers =
// batch_size * iterations walks [n_walkers, walk_length] from uniform starts
// (walker b starts where walker b mod batch_size does) and negatives
// [n_walkers, n_negatives], scale-free (heads of uniform arcs) or uniform.
int ebt_first_order_batch(const void* row_ptr, const void* col_idx,
                          const void* alias_prob, const void* alias_idx, const void* records,
                          int n_nodes, long long n_arcs, long long batch_size,
                          long long n_walkers, int walk_length, int n_negatives, int scale_free,
                          void* walks, void* negs, unsigned long long seed, unsigned int offset,
                          void* stream) {
  if (n_walkers == 0) return 0;
  if (n_walkers > 0xFFFFFFFFll || batch_size <= 0 || n_arcs > 0xFFFFFFFFll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows g = rows_of(row_ptr, col_idx, alias_prob, alias_idx, records);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n_walkers, kWalkThreads);
  const auto run = [&](auto kernel) {
    kernel<<<blocks, kWalkThreads, 0, s>>>(
        g, static_cast<uint32_t>(n_nodes), static_cast<uint32_t>(n_arcs), batch_size,
        n_walkers, walk_length, n_negatives, scale_free, static_cast<int32_t*>(walks),
        static_cast<int32_t*>(negs), static_cast<uint32_t>(seed),
        static_cast<uint32_t>(seed >> 32), offset);
  };
  if (g.records != nullptr) {
    run(first_order_batch_kernel<true>);
  } else {
    run(first_order_batch_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

// col_idx == NULL draws uniform node ids in [0, n_nodes) instead.
int ebt_node_draws(const void* col_idx, long long n_arcs, long long n_nodes,
                   void* out, long long n, unsigned long long seed,
                   unsigned int offset, void* stream) {
  if (n == 0) return 0;
  node_draws_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col_idx), static_cast<uint32_t>(n_arcs),
      static_cast<uint32_t>(n_nodes), static_cast<int32_t*>(out), n,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), offset);
  return static_cast<int>(cudaGetLastError());
}

const char* ebt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
