// K13: GloVe's co-occurrence build (K13a) and its weighted-least-squares
// step (K13b).
//
// K13a replaces embiggen_tpu/models/embedders/glove.py::GloVe._cooccurrences
// (the window pairs, their host radix sort and reduceat) and the per-power
// count of WalkletsGloVe._fit_transform (walklets.py:381-394). For every
// walk, every stride d given (GloVe: 1..w at weight 1/d; Walklets GloVe: one
// stride at weight 1) and every position t < L - d, the pair of nodes
// (a, b) = (walk[t], walk[t + d]) adds its weight to the keys a N + b and
// b N + a; the result is each distinct key with its summed weight in
// ascending key order, the diagonal (a == b) dropped. Key order is center
// order, then context order within a center, so the build is a counting
// sort by center followed by a sort of each center's segment:
//   1. cooc_count: a thread a walk position t, as the center a = walk[t],
//      counts its partners walk[t +- d] (those inside the walk and not a)
//      into cnt[a], one atomic for the lanes of a warp that share a center
//      that the walk revisits;
//   2. an exclusive scan of cnt gives each center's segment of the entry
//      buffer (off);
//   3. cooc_scatter: the same thread reserves its k partners' slots in a's
//      segment (one atomic for the lanes of a warp that share a revisited
//      center) and writes them there as b << shift | j (j the stride's
//      index in `shift` bits: one 32-bit word an entry);
//   4. cooc_sort: each segment sorted by that word (context, then stride):
//      up to kWarpSeg entries in a warp's registers (a bitonic network of
//      shuffles, 1-8 words a lane), up to kBlockSeg in the block's shared
//      memory; each run of one context summed in float64 in sorted order,
//      and the distinct (context, sum) written back over the segment's
//      front with the center's distinct count (dcnt). A segment longer than
//      kBlockSeg (a hub) is left to the hub route (below);
//   5. an exclusive scan of dcnt gives each center's place in the output;
//   6. cooc_copy moves each center's distinct entries there (ci, cj, sum as
//      float32), and the hub route writes each hub's.
// The wrapper reads the output's size once, after step 5, to allocate it.
//
// What bounds it on the H100: bytes, and where they land. The byte bound is
// the walks read and the entries written (12 B each). A hash table of the
// pairs would take a random read-modify-write of a DRAM sector for each of
// them (29M at the GloVe bench shape) and a 64-bit sort of the keys after.
// Here every pass but the scatter streams: the count and the scatter read the
// walks (64 MB at the GloVe bench shape), the sort reads the 4-byte entries
// a segment at a time and writes the distinct ones back, the copy moves
// them. The scatter's writes land at random segments; so that partly
// written 32-byte sectors are not evicted to DRAM half-filled, it runs in
// sweeps over ranges of segments that fit in L2: one pass stores each
// position's sweep (a byte), and each sweep reads those bytes and writes
// only its own positions' entries.
//
// Hubs: a segment longer than kBlockSeg entries is a hub. cooc_sort lists
// it with its chunks of kHubChunk entries; its entries are bucketed by
// window of contexts (a histogram a chunk, a prefix a hub, a scatter a
// chunk into the hub's unused part of rec_sum), then a block takes each
// (hub, window) pair: the contexts present flagged a byte each and their
// weights added in float64 in shared memory, then listed in ascending order
// by a scan of the flags; once to count each window's distinct contexts
// (before the scan of step 5), once to write them. Every pass spreads over
// the whole card, and each reads a hub's entries once (a window wider than
// kHubWindow, on graphs over 2^24 nodes, reads its bucket once per
// kHubWindow contexts).
//
// Sums: a run is summed in sorted order (stride order within a context), so
// the sorted routes give the same float64 sums on every run; the hub route
// adds in no fixed order. Both are cast to float32 at the end.
//
// K13b `glove_step` replaces GloVe._batch_updates (glove.py:207-228; its
// loss is embiggen_tpu/ops/losses.py::glove_loss) followed by its "add"
// updates in apply_updates (minibatch.py:71-89), and the same step of
// WalkletsGloVe (walklets.py:413-428). For each drawn entry e = ids[r], with
// (i, j, f, log x), pred = w_i . c_j + b_i + b_j and g = 2 f (pred - log x)
// / B; then node[i] -= lr g c_j, context[j] -= lr g w_i, center_bias[i] -=
// lr g and context_bias[j] -= lr g, summed over repeated rows, in place, and
// the loss sum of f (pred - log x)^2 into one scalar. Every gradient is taken
// from the tables as they stood before the step: no launch reads a row that
// a launch of the step has already changed, or changes at the same time.
// Three launches:
//   1. glove_gradients reads the tables and changes none of them. It writes
//      i, j and g an entry, the loss's partial sum a block, and the context
//      side's scaled rows g w_i into a [B, D] workspace (33.5 MB at B 65536,
//      D 128, which stays in the 50-MB L2).
//   2. glove_node_update adds -lr (g c_j) into node[i], reading c_j from the
//      context table, which no launch has changed yet, and -lr g into both
//      biases, which no later launch reads. Its block 0 sums the loss
//      partials in a fixed order.
//   3. glove_context_update adds -lr times the workspace rows into
//      context[j].
// What bounds it on the H100: bytes. Each entry's two rows and two biases
// are read once and written once: 2 KB an entry at D 128, 134 MB at B
// 65536. Before them come the entry's three dependent gathers: ids[r], then
// (ci, cj, f, log x)[e], then the rows. The gradient launch gives each group
// of G lanes (a power of two, 16 at D 128: two float4 a lane and row) G
// entries in a row. Each lane first gathers one entry's ids, entry and
// biases, so a group's G chains are in flight at once. The group then takes
// its entries four at a time, their ids by shuffles, so a row load waits on
// no other load and four entries' rows are in flight a group. The updates are float4 reductions (red.global.add.v4.f32),
// a group of G lanes an entry. Each term added is -lr (g x), rounded as the
// reference rounds it. Repeated rows sum in no fixed order, so tables differ
// from run to run by rounding only.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Segments of up to kWarpSeg entries are sorted by a warp, up to kBlockSeg
// by a block (its shared memory holds them); longer ones are hubs.
// ops/glove.py mirrors kBlockSeg as _BLOCK_SEGMENT.
constexpr int kWarpSeg = 256;
constexpr int kBlockSeg = 8192;
constexpr int kCentersPerBlock = 64;
constexpr int kScanItems = 8;
constexpr int kScanChunk = kThreads * kScanItems;
// The hub route: a block sums kHubWindow contexts at a time in shared
// memory (a flag byte and a float64 each); a hub has at most
// kMaxHubWindows windows (ops/glove.py picks the window's width to keep to
// that, and mirrors kHubChunk as _HUB_CHUNK).
constexpr int kHubWindow = 16384;
constexpr int kMaxHubWindows = 1024;
constexpr int kHubChunk = 4096;
constexpr int kHubCountSmem = kHubWindow;
constexpr int kHubWriteSmem = kHubWindow + kHubWindow * sizeof(double);

// Calls f(context, j) for each partner of position t of `row` (a walk of
// length L whose node at t is a): row[t + d] and row[t - d] for every
// stride d = strides[j] that stays inside the walk, where not a. Returns
// their count.
template <typename F>
__device__ __forceinline__ int for_partners(const int32_t* __restrict__ row, int L, int t,
                                            int32_t a, const int32_t* __restrict__ strides,
                                            int J, F f) {
  int k = 0;
  for (int j = 0; j < J; ++j) {
    const int d = __ldg(strides + j);
    if (d < L - t) {
      const int32_t b = row[t + d];
      if (b != a) {
        f(b, j);
        ++k;
      }
    }
    if (d <= t) {
      const int32_t b = row[t - d];
      if (b != a) {
        f(b, j);
        ++k;
      }
    }
  }
  return k;
}

__device__ __forceinline__ long long warp_inclusive_sum(long long v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix of v over the block's threads; `total` gets the sum.
// Every thread of the block calls it.
__device__ long long block_exclusive_sum(long long v, long long* warp_totals,
                                         long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long incl = warp_inclusive_sum(v);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  long long before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const long long x = warp_totals[w];
    if (w < warp) before += x;
    sum += x;
  }
  __syncthreads();
  total = sum;
  return before + incl - v;
}

// A warp or the block as the group that sorts one segment.
template <int G>
struct Group;

template <>
struct Group<32> {
  __device__ static int tid() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
  // (rank among the flagged threads, number flagged)
  __device__ static int2 count(bool flag, int*) {
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    return make_int2(__popc(b & ((1u << (threadIdx.x & 31)) - 1u)), __popc(b));
  }
};

template <>
struct Group<kThreads> {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static int2 count(bool flag, int* warp_counts) {
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_counts[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_counts[w];
      total += warp_counts[w];
    }
    __syncthreads();
    return make_int2(before + __popc(b & ((1u << lane) - 1u)), total);
  }
};

// The n entries of `seg` (n <= 32 R) sorted in a warp's registers, R a
// lane (element r * 32 + lane), by a bitonic network (words of the same
// lane swap in registers, others by shuffles), into buf[0, 32 R), padded
// with all-ones words.
template <int R>
__device__ void warp_sort(const unsigned* seg, int n, unsigned* buf) {
  const int lane = threadIdx.x & 31;
  unsigned v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    v[r] = i < n ? seg[i] : 0xffffffffu;
  }
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int pr = r ^ (j >> 5);
          if (pr > r) {
            const bool up = ((r * 32 + lane) & k) == 0;
            const unsigned x = v[r], y = v[pr];
            v[r] = up ? min(x, y) : max(x, y);
            v[pr] = up ? max(x, y) : min(x, y);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned y = __shfl_xor_sync(0xffffffffu, v[r], j);
          const bool up = ((r * 32 + lane) & k) == 0;
          v[r] = (((lane & j) == 0) == up) ? min(v[r], y) : max(v[r], y);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) buf[r * 32 + lane] = v[r];
  __syncwarp();
}

// The n entries of `seg` sorted in the block's shared memory `buf` (a
// power of two >= n) by a bitonic network.
__device__ void block_sort(const unsigned* seg, int n, unsigned* buf) {
  int P = 32;
  while (P < n) P <<= 1;
  for (int i = threadIdx.x; i < P; i += kThreads) buf[i] = i < n ? seg[i] : 0xffffffffu;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned x = buf[i], y = buf[l];
          if ((x > y) == ((i & k) == 0)) {
            buf[i] = y;
            buf[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Each run of one context in the sorted buf[0, n) written over the
// segment's front: the context into seg[k], its weights' float64 sum as
// float32 into sums[k]. Returns the number of runs. Every thread of the
// group calls it with the same n.
template <int G>
__device__ int reduce_runs(unsigned* seg, float* sums, int n, const unsigned* buf, int shift,
                           const double* __restrict__ weights, int* warp_counts) {
  using Gr = Group<G>;
  const unsigned mask = (1u << shift) - 1u;
  int runs = 0;
  for (int base = 0; base < n; base += G) {
    const int i = base + Gr::tid();
    const unsigned ctx = i < n ? buf[i] >> shift : 0u;
    const bool head = i < n && (i == 0 || buf[i - 1] >> shift != ctx);
    const int2 rank = Gr::count(head, warp_counts);
    if (head) {
      double s = 0.0;
      for (int m = i; m < n && buf[m] >> shift == ctx; ++m) s += __ldg(weights + (buf[m] & mask));
      seg[runs + rank.x] = ctx;
      sums[runs + rank.x] = static_cast<float>(s);
    }
    runs += rank.y;
  }
  Gr::sync();
  return runs;
}

template <int R>
__device__ int warp_route(unsigned* seg, float* sums, int n, unsigned* buf, int shift,
                          const double* __restrict__ weights) {
  warp_sort<R>(seg, n, buf);
  return reduce_runs<32>(seg, sums, n, buf, shift, weights, nullptr);
}

// The lanes of `mask` whose `key` is the same form a group (`peers`): each
// lane gets the sum of k over the group's lanes below it (`before`) and over
// the whole group (`total`), so that one lane can reserve for all of them.
// A hub fills half a warp on a star's walks, where one atomic a lane would
// queue at one address. Grouping costs the warp a __match_any_sync, so only
// the lanes whose center comes back two steps before or after (`revisits`:
// the hub of a star, a walk that turns back) take part.
__device__ __forceinline__ bool revisits(const int32_t* __restrict__ row, int L, int t,
                                         int32_t a) {
  return (t >= 2 && row[t - 2] == a) || (t + 2 < L && row[t + 2] == a);
}

__device__ __forceinline__ void group_by_key(unsigned mask, int32_t key, unsigned k,
                                             unsigned& peers, unsigned& before,
                                             unsigned& total) {
  const int lane = threadIdx.x & 31;
  peers = __match_any_sync(mask, key);
  before = 0;
  total = 0;
  for (unsigned b = peers; b; b &= b - 1u) {
    const int j = __ffs(b) - 1;
    const unsigned v = __shfl_sync(peers, k, j);
    total += v;
    if (j < lane) before += v;
  }
}

__global__ void __launch_bounds__(kThreads) cooc_count_kernel(
    const int32_t* __restrict__ walks, long long positions, int L,
    const int32_t* __restrict__ strides, int J, unsigned* __restrict__ cnt) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  int32_t a = -1;
  unsigned k = 0;
  bool hot = false;
  if (i < positions) {
    const long long w = i / L;
    const int t = static_cast<int>(i - w * L);
    const int32_t* row = walks + w * L;
    a = row[t];
    k = for_partners(row, L, t, a, strides, J, [](int32_t, int) {});
    hot = k > 0 && revisits(row, L, t, a);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, hot);
  if (k == 0) return;
  if (!hot) {
    atomicAdd(cnt + a, k);
    return;
  }
  unsigned peers, before, total;
  group_by_key(mask, a, k, peers, before, total);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(cnt + a, total);
}

// Each position's sweep: the range of `width` entries its center's segment
// starts in.
__global__ void __launch_bounds__(kThreads) cooc_sweep_kernel(
    const int32_t* __restrict__ walks, long long positions, const long long* __restrict__ off,
    long long width, uint8_t* __restrict__ sweep) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i < positions) sweep[i] = static_cast<uint8_t>(off[walks[i]] / width);
}

// The positions of sweep `s` (all of them when sweep is null) write their
// entries; cnt counts down to 0 as the slots are taken.
__global__ void __launch_bounds__(kThreads) cooc_scatter_kernel(
    const int32_t* __restrict__ walks, long long positions, int L,
    const int32_t* __restrict__ strides, int J, int shift, const long long* __restrict__ off,
    unsigned* __restrict__ cnt, unsigned* __restrict__ ent, const uint8_t* __restrict__ sweep,
    int s) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const int32_t* row = walks;
  int t = 0;
  int32_t a = -1;
  unsigned k = 0;
  bool hot = false;
  if (i < positions && (sweep == nullptr || sweep[i] == s)) {
    const long long w = i / L;
    t = static_cast<int>(i - w * L);
    row = walks + w * L;
    a = row[t];
    k = for_partners(row, L, t, a, strides, J, [](int32_t, int) {});
    hot = k > 0 && revisits(row, L, t, a);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, hot);
  if (k == 0) return;
  unsigned* out;
  if (hot) {
    unsigned peers, before, total;
    group_by_key(mask, a, k, peers, before, total);
    const int leader = __ffs(peers) - 1;
    unsigned last = 0;
    if ((threadIdx.x & 31) == leader) last = atomicSub(cnt + a, total);
    last = __shfl_sync(peers, last, leader);
    out = ent + off[a] + last - total + before;
  } else {
    out = ent + off[a] + atomicSub(cnt + a, k) - k;
  }
  for_partners(row, L, t, a, strides, J, [&](int32_t b, int j) {
    *out++ = static_cast<unsigned>(b) << shift | static_cast<unsigned>(j);
  });
}

// kCentersPerBlock centers a block: a warp a short segment, then the block
// for each longer one; hubs are listed, with their chunks, for the hub
// route.
__global__ void __launch_bounds__(kThreads) cooc_sort_kernel(
    unsigned* __restrict__ ent, float* __restrict__ rec_sum, const long long* __restrict__ off,
    long long n_nodes, int shift, const double* __restrict__ weights,
    unsigned* __restrict__ dcnt, int32_t* __restrict__ hubs, unsigned* __restrict__ hub_counts,
    int2* __restrict__ chunks) {
  __shared__ unsigned warp_buf[kWarps][kWarpSeg];
  __shared__ unsigned hub_slot[2];
  __shared__ unsigned block_buf[kBlockSeg];
  __shared__ int longs[kCentersPerBlock];
  __shared__ int n_longs;
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = blockIdx.x * static_cast<long long>(kCentersPerBlock);
  if (threadIdx.x == 0) n_longs = 0;
  __syncthreads();
  for (int q = warp; q < kCentersPerBlock; q += kWarps) {
    const long long c = c0 + q;
    if (c >= n_nodes) break;
    const long long o = off[c], n = off[c + 1] - o;
    if (n > kWarpSeg) {
      if (lane == 0) longs[atomicAdd(&n_longs, 1)] = q;
      continue;
    }
    unsigned* seg = ent + o;
    float* sums = rec_sum + o;
    unsigned* buf = warp_buf[warp];
    const int m = static_cast<int>(n);
    const int runs = m == 0     ? 0
                     : m <= 32  ? warp_route<1>(seg, sums, m, buf, shift, weights)
                     : m <= 64  ? warp_route<2>(seg, sums, m, buf, shift, weights)
                     : m <= 128 ? warp_route<4>(seg, sums, m, buf, shift, weights)
                                : warp_route<8>(seg, sums, m, buf, shift, weights);
    if (lane == 0) dcnt[c] = static_cast<unsigned>(runs);
  }
  __syncthreads();
  const int count = n_longs;
  for (int q = 0; q < count; ++q) {
    const long long c = c0 + longs[q];
    const long long o = off[c], n = off[c + 1] - o;
    if (n > kBlockSeg) {
      const unsigned k = static_cast<unsigned>((n + kHubChunk - 1) / kHubChunk);
      if (threadIdx.x == 0) {
        hub_slot[0] = atomicAdd(hub_counts, 1u);
        hub_slot[1] = atomicAdd(hub_counts + 1, k);
        hubs[hub_slot[0]] = static_cast<int32_t>(c);
        dcnt[c] = 0u;
      }
      __syncthreads();
      for (unsigned i = threadIdx.x; i < k; i += kThreads)
        chunks[hub_slot[1] + i] = make_int2(static_cast<int>(hub_slot[0]), static_cast<int>(i));
      __syncthreads();
      continue;
    }
    block_sort(ent + o, static_cast<int>(n), block_buf);
    const int runs = reduce_runs<kThreads>(ent + o, rec_sum + o, static_cast<int>(n), block_buf,
                                           shift, weights, warp_counts);
    if (threadIdx.x == 0) dcnt[c] = static_cast<unsigned>(runs);
  }
}

// The hub route. A hub's entries are bucketed by window (context >> wshift,
// nw windows a hub) into the free float32 half of its segment (`bucket`,
// rec_sum seen as words), then each (hub, window) pair is summed by one
// block in shared memory. The grid is persistent everywhere: the hubs'
// count is on the device only.

// Each hub's entries in chunks of kHubChunk, listed as (hub, chunk) by
// cooc_sort, a chunk a block at a time: its windows' counts added into
// wcnt [hub][nw].
__global__ void __launch_bounds__(kThreads) cooc_hub_hist_kernel(
    const unsigned* __restrict__ ent, const long long* __restrict__ off,
    const int32_t* __restrict__ hubs, const unsigned* __restrict__ hub_counts,
    const int2* __restrict__ chunks, int shift, int wshift, int nw,
    unsigned* __restrict__ wcnt) {
  __shared__ unsigned hist[kMaxHubWindows];
  const unsigned n_chunks = hub_counts[1];
  for (unsigned q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    const int2 hc = chunks[q];
    const long long c = hubs[hc.x];
    const long long o = off[c], n = off[c + 1] - o;
    const long long lo = static_cast<long long>(hc.y) * kHubChunk;
    const long long hi = min(n, lo + kHubChunk);
    for (int i = threadIdx.x; i < nw; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      atomicAdd(hist + ((ent[o + i] >> shift) >> wshift), 1u);
    __syncthreads();
    unsigned* row = wcnt + static_cast<long long>(hc.x) * nw;
    for (int i = threadIdx.x; i < nw; i += kThreads)
      if (hist[i]) atomicAdd(row + i, hist[i]);
    __syncthreads();
  }
}

// A block a hub: out [hub][nw + 1] = the exclusive prefix of x [hub][nw]
// over the hub's windows, the hub's total last.
__global__ void __launch_bounds__(kThreads) cooc_hub_prefix_kernel(
    const unsigned* __restrict__ x, const unsigned* __restrict__ hub_counts, int nw,
    unsigned* __restrict__ out) {
  __shared__ long long warp_totals[kWarps];
  const unsigned count = hub_counts[0];
  for (unsigned h = blockIdx.x; h < count; h += gridDim.x) {
    const unsigned* row = x + static_cast<long long>(h) * nw;
    unsigned* to = out + static_cast<long long>(h) * (nw + 1);
    long long carry = 0;
    for (int base = 0; base < nw; base += kThreads) {
      const int i = base + threadIdx.x;
      const long long v = i < nw ? row[i] : 0;
      long long sum;
      const long long before = block_exclusive_sum(v, warp_totals, sum);
      if (i < nw) to[i] = static_cast<unsigned>(carry + before);
      carry += sum;
    }
    if (threadIdx.x == 0) to[nw] = static_cast<unsigned>(carry);
  }
}

// A chunk a block at a time: its entries, held in registers, reserve their
// windows' slots with one atomic a window (wcnt counts down to 0) and are
// written into their buckets: bucket[off[c] + wofs[hub][window] + slot].
__global__ void __launch_bounds__(kThreads) cooc_hub_scatter_kernel(
    const unsigned* __restrict__ ent, unsigned* __restrict__ bucket,
    const long long* __restrict__ off, const int32_t* __restrict__ hubs,
    const unsigned* __restrict__ hub_counts, const int2* __restrict__ chunks, int shift,
    int wshift, int nw, const unsigned* __restrict__ wofs, unsigned* __restrict__ wcnt) {
  __shared__ unsigned hist[kMaxHubWindows];
  __shared__ unsigned first[kMaxHubWindows];
  constexpr int kItems = kHubChunk / kThreads;
  const unsigned n_chunks = hub_counts[1];
  for (unsigned q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    const int2 hc = chunks[q];
    const long long c = hubs[hc.x];
    const long long o = off[c], n = off[c + 1] - o;
    const long long lo = static_cast<long long>(hc.y) * kHubChunk;
    for (int i = threadIdx.x; i < nw; i += kThreads) hist[i] = 0u;
    __syncthreads();
    unsigned e[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = lo + k * kThreads + threadIdx.x;
      if (i < n) {
        e[k] = ent[o + i];
        atomicAdd(hist + ((e[k] >> shift) >> wshift), 1u);
      }
    }
    __syncthreads();
    unsigned* counts = wcnt + static_cast<long long>(hc.x) * nw;
    const unsigned* starts = wofs + static_cast<long long>(hc.x) * (nw + 1);
    for (int i = threadIdx.x; i < nw; i += kThreads) {
      const unsigned k = hist[i];
      if (k) first[i] = starts[i] + atomicSub(counts + i, k) - k;
      hist[i] = 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (lo + k * kThreads + threadIdx.x >= n) continue;
      const int win = static_cast<int>((e[k] >> shift) >> wshift);
      bucket[o + first[win] + atomicAdd(hist + win, 1u)] = e[k];
    }
    __syncthreads();
  }
}

// A block a (hub, window) pair, over sub-windows of kHubWindow contexts:
// the contexts present flagged a byte each, with write also their weights
// added in float64 in shared memory (in no fixed order); then listed in
// ascending order by a scan of the flags. Without write, each window's
// distinct count goes into wdist [hub][nw] and is added into dcnt[c]
// (zeroed by cooc_sort); with write, the entries are written at out_off[c]
// + wdofs [hub][window] (the prefix of wdist).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads) cooc_hub_window_kernel(
    const unsigned* __restrict__ bucket, const long long* __restrict__ off,
    long long n_nodes, const int32_t* __restrict__ hubs,
    const unsigned* __restrict__ hub_counts, int shift, int wshift, int nw,
    const unsigned* __restrict__ wofs, const double* __restrict__ weights,
    unsigned* __restrict__ wdist, unsigned* __restrict__ dcnt,
    const unsigned* __restrict__ wdofs, const long long* __restrict__ out_off,
    int32_t* __restrict__ ci, int32_t* __restrict__ cj, float* __restrict__ sums) {
  extern __shared__ uint4 hub_smem[];
  uint8_t* flag = reinterpret_cast<uint8_t*>(hub_smem);
  double* acc = reinterpret_cast<double*>(flag + kHubWindow);
  __shared__ long long warp_totals[kWarps];
  constexpr int kFlagWords = kHubWindow / 4 / kThreads;
  const unsigned jmask = (1u << shift) - 1u;
  const long long pairs = static_cast<long long>(hub_counts[0]) * nw;
  for (long long p = blockIdx.x; p < pairs; p += gridDim.x) {
    const long long h = p / nw;
    const int win = static_cast<int>(p - h * nw);
    const unsigned* starts = wofs + h * (nw + 1);
    const unsigned m = starts[win + 1] - starts[win];
    if (m == 0) continue;
    const long long c = hubs[h];
    const unsigned* b = bucket + off[c] + starts[win];
    const long long w0 = static_cast<long long>(win) << wshift;
    const long long w1 = min(n_nodes, (static_cast<long long>(win) + 1) << wshift);
    long long written = 0;
    for (long long base = w0; base < w1; base += kHubWindow) {
      for (int i = threadIdx.x; i < kHubWindow / 16; i += kThreads)
        hub_smem[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kWrite) {
        for (int i = threadIdx.x; i < kHubWindow; i += kThreads) acc[i] = 0.0;
      }
      __syncthreads();
      for (unsigned i = threadIdx.x; i < m; i += kThreads) {
        const unsigned e = b[i];
        const long long s = static_cast<long long>(e >> shift) - base;
        if (s >= 0 && s < kHubWindow) {
          flag[s] = 1;
          if (kWrite) atomicAdd(acc + s, __ldg(weights + (e & jmask)));
        }
      }
      __syncthreads();
      const unsigned* words = reinterpret_cast<const unsigned*>(flag) + threadIdx.x * kFlagWords;
      int present = 0;
#pragma unroll
      for (int q = 0; q < kFlagWords; ++q) present += __popc(words[q]);
      long long total;
      const long long rank = block_exclusive_sum(present, warp_totals, total);
      if (kWrite) {
        long long k = out_off[c] + wdofs[h * (nw + 1) + win] + written + rank;
        for (int q = 0; q < kFlagWords; ++q) {
          const unsigned word = words[q];
          if (!word) continue;
          for (int y = 0; y < 4; ++y) {
            if (!((word >> (8 * y)) & 1u)) continue;
            const int s = (threadIdx.x * kFlagWords + q) * 4 + y;
            ci[k] = static_cast<int32_t>(c);
            cj[k] = static_cast<int32_t>(base + s);
            sums[k] = static_cast<float>(acc[s]);
            ++k;
          }
        }
      }
      written += total;
      __syncthreads();
    }
    if (!kWrite && threadIdx.x == 0) {
      wdist[h * nw + win] = static_cast<unsigned>(written);
      atomicAdd(dcnt + c, static_cast<unsigned>(written));
    }
  }
}

// A warp a center: its distinct entries from the front of its segment to
// its place in the output (hubs write their own).
__global__ void __launch_bounds__(kThreads) cooc_copy_kernel(
    const unsigned* __restrict__ ent, const float* __restrict__ rec_sum,
    const long long* __restrict__ off, const unsigned* __restrict__ dcnt,
    const long long* __restrict__ out_off, long long n_nodes, int32_t* __restrict__ ci,
    int32_t* __restrict__ cj, float* __restrict__ sums) {
  const long long c = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_nodes) return;
  const long long o = off[c];
  if (off[c + 1] - o > kBlockSeg) return;
  const long long to = out_off[c];
  const unsigned d = dcnt[c];
  for (unsigned k = lane; k < d; k += 32) {
    ci[to + k] = static_cast<int32_t>(c);
    cj[to + k] = static_cast<int32_t>(ent[o + k]);
    sums[to + k] = rec_sum[o + k];
  }
}

// Sums of kScanChunk-element chunks of x, one a block.
__global__ void __launch_bounds__(kThreads) cooc_scan_reduce_kernel(
    const unsigned* __restrict__ x, long long n, long long* __restrict__ part) {
  __shared__ long long warp_totals[kWarps];
  const long long base = blockIdx.x * static_cast<long long>(kScanChunk);
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    const long long i = base + q * kThreads + threadIdx.x;
    if (i < n) s += x[i];
  }
  long long total;
  block_exclusive_sum(s, warp_totals, total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// One block: the chunk sums' exclusive prefixes in place, the whole sum
// into *total.
__global__ void __launch_bounds__(kThreads) cooc_scan_partials_kernel(
    long long* __restrict__ part, long long nb, long long* __restrict__ total) {
  __shared__ long long warp_totals[kWarps];
  long long carry = 0;
  for (long long base = 0; base < nb; base += kThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < nb ? part[i] : 0;
    long long sum;
    const long long before = block_exclusive_sum(v, warp_totals, sum);
    if (i < nb) part[i] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads) cooc_scan_down_kernel(
    const unsigned* __restrict__ x, long long n, const long long* __restrict__ part,
    long long* __restrict__ out) {
  __shared__ long long warp_totals[kWarps];
  const long long base =
      blockIdx.x * static_cast<long long>(kScanChunk) + threadIdx.x * kScanItems;
  unsigned v[kScanItems];
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < n ? x[base + q] : 0u;
    s += v[q];
  }
  long long total;
  long long before = block_exclusive_sum(s, warp_totals, total) + part[blockIdx.x];
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < n) out[base + q] = before;
    before += v[q];
  }
}

// K13b. A lane keeps up to kGloveSlots elements (float4 or float) of each
// of an entry's rows in registers; a group of lanes covers a row in chunks
// of G * kGloveSlots elements, kGloveUnroll entries at a time.
constexpr int kGloveSlots = 2;
constexpr int kGloveUnroll = 4;

__device__ __forceinline__ float dot_add(const float4& a, const float4& b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ float dot_add(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ float4 scaled(float s, const float4& x) {
  return make_float4(s * x.x, s * x.y, s * x.z, s * x.w);
}
__device__ __forceinline__ float scaled(float s, float x) { return s * x; }

// The sum of v over the block, on thread 0 (every thread must call it).
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
  if (threadIdx.x < 32) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// A thread an entry: entry r = the global thread index. A group of G lanes
// takes the G entries of its lanes one after another (see the note at the
// top).
template <typename T>
__global__ void __launch_bounds__(kThreads) glove_gradients_kernel(
    const int32_t* __restrict__ ci, const int32_t* __restrict__ cj,
    const float* __restrict__ f_x, const float* __restrict__ log_x,
    const int32_t* __restrict__ ids, const T* __restrict__ node_emb,
    const T* __restrict__ ctx_emb, const float* __restrict__ center_bias,
    const float* __restrict__ ctx_bias, int32_t* __restrict__ out_i,
    int32_t* __restrict__ out_j, float* __restrict__ out_g, T* __restrict__ rows_w,
    float* __restrict__ partials, long long B, int n, int G, float inv_b) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - sub);
  const long long r = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long r0 = r - sub;
  int32_t own_i = 0, own_j = 0;
  float own_f = 0.f, own_lx = 0.f, own_bi = 0.f, own_bj = 0.f;
  if (r < B) {
    const long long e = ids[r];
    own_i = ci[e];
    own_j = cj[e];
    own_f = f_x[e];
    own_lx = log_x[e];
    own_bi = center_bias[own_i];
    own_bj = ctx_bias[own_j];
  }
  float own_g = 0.f, own_loss = 0.f;
  const long long left = B - r0;
  const int count = left <= 0 ? 0 : (left < G ? static_cast<int>(left) : G);
  for (int k0 = 0; k0 < count; k0 += kGloveUnroll) {
    // kGloveUnroll entries' rows in flight at once (the last entry again
    // where count runs out; it is not written twice).
    const T* w[kGloveUnroll];
    const T* c[kGloveUnroll];
#pragma unroll
    for (int u = 0; u < kGloveUnroll; ++u) {
      const int k = min(k0 + u, count - 1);
      w[u] = node_emb + static_cast<long long>(__shfl_sync(mask, own_i, k, G)) * n;
      c[u] = ctx_emb + static_cast<long long>(__shfl_sync(mask, own_j, k, G)) * n;
    }
    T wv[kGloveUnroll][kGloveSlots], cv[kGloveUnroll][kGloveSlots];
    float dot[kGloveUnroll];
#pragma unroll
    for (int u = 0; u < kGloveUnroll; ++u) dot[u] = 0.f;
    for (int base = 0; base < n; base += G * kGloveSlots) {
#pragma unroll
      for (int s = 0; s < kGloveSlots; ++s) {
        const int q = base + sub + s * G;
        if (q < n) {
#pragma unroll
          for (int u = 0; u < kGloveUnroll; ++u) {
            wv[u][s] = __ldg(w[u] + q);
            cv[u][s] = __ldg(c[u] + q);
          }
#pragma unroll
          for (int u = 0; u < kGloveUnroll; ++u) dot[u] = dot_add(wv[u][s], cv[u][s], dot[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGloveUnroll; ++u) {
      for (int off = G / 2; off > 0; off >>= 1) dot[u] += __shfl_xor_sync(mask, dot[u], off, G);
    }
#pragma unroll
    for (int u = 0; u < kGloveUnroll; ++u) {
      const int k = k0 + u;
      if (k >= count) break;  // the same for every lane of the group
      const float f = __shfl_sync(mask, own_f, k, G);
      const float diff = dot[u] + __shfl_sync(mask, own_bi, k, G) +
                         __shfl_sync(mask, own_bj, k, G) - __shfl_sync(mask, own_lx, k, G);
      const float g = 2.f * f * diff * inv_b;
      if (sub == k) {
        own_g = g;
        own_loss = f * diff * diff;
      }
      T* ow = rows_w + (r0 + k) * n;
      if (n <= G * kGloveSlots) {
#pragma unroll
        for (int s = 0; s < kGloveSlots; ++s) {
          const int q = sub + s * G;
          if (q < n) ow[q] = scaled(g, wv[u][s]);
        }
      } else {
        for (int q = sub; q < n; q += G) ow[q] = scaled(g, __ldg(w[u] + q));
      }
    }
  }
  if (r < B) {
    out_i[r] = own_i;
    out_j[r] = own_j;
    out_g[r] = own_g;
  }
  const float total = block_sum(own_loss, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// One side of K13b's update: dst[dst_idx[r]] += -lr (scale[r] src[from]),
// from = src_idx[r], or r where src_idx is null; scale null is 1.
struct GloveSide {
  float* dst;
  const int32_t* dst_idx;
  const float* src;
  const int32_t* src_idx;
  const float* scale;
};

template <typename T>
__device__ __forceinline__ void glove_side_update(const GloveSide& s, long long r, int sub,
                                                  int G, int n, float neg_lr) {
  const long long to = s.dst_idx[r];
  const long long from = s.src_idx == nullptr ? r : s.src_idx[r];
  const float k = s.scale == nullptr ? 1.f : s.scale[r];
  const T* src = reinterpret_cast<const T*>(s.src) + from * n;
  T* dst = reinterpret_cast<T*>(s.dst) + to * n;
  for (int base = 0; base < n; base += G * kGloveSlots) {
    // The lane's loads first, all in flight, then its reductions.
    T x[kGloveSlots];
#pragma unroll
    for (int v = 0; v < kGloveSlots; ++v) {
      const int q = base + sub + v * G;
      if (q < n) x[v] = __ldg(src + q);
    }
#pragma unroll
    for (int v = 0; v < kGloveSlots; ++v) {
      const int q = base + sub + v * G;
      if (q < n) atomicAdd(dst + q, scaled(neg_lr, scaled(k, x[v])));
    }
  }
}

// A group of G lanes an entry: side a; where center_bias is given, -lr g
// into both biases; where loss is given, block 0 first writes the sum of
// the n_partials loss partials into it.
template <typename T>
__device__ __forceinline__ void glove_update(GloveSide a, float* center_bias,
                                             float* ctx_bias, const int32_t* i,
                                             const int32_t* j, const float* g,
                                             const float* partials, long long n_partials,
                                             float* loss, long long B, int n, int G,
                                             float neg_lr) {
  if (loss != nullptr && blockIdx.x == 0) {
    __shared__ float warp_sums[kWarps];
    float s = 0.f;
    for (long long p = threadIdx.x; p < n_partials; p += kThreads) s += partials[p];
    s = block_sum(s, warp_sums);
    if (threadIdx.x == 0) *loss = s;
  }
  const long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long r = t / G;
  if (r >= B) return;
  const int sub = static_cast<int>(t - r * G);
  glove_side_update<T>(a, r, sub, G, n, neg_lr);
  if (center_bias != nullptr && sub == 0) {
    const float term = neg_lr * g[r];
    atomicAdd(center_bias + i[r], term);
    atomicAdd(ctx_bias + j[r], term);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) glove_node_update_kernel(
    GloveSide a, float* center_bias, float* ctx_bias, const int32_t* i, const int32_t* j,
    const float* g, const float* partials, long long n_partials, float* loss, long long B,
    int n, int G, float neg_lr) {
  glove_update<T>(a, center_bias, ctx_bias, i, j, g, partials, n_partials, loss, B, n, G,
                  neg_lr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) glove_context_update_kernel(GloveSide a, long long B,
                                                                        int n, int G,
                                                                        float neg_lr) {
  glove_update<T>(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                  nullptr, B, n, G, neg_lr);
}

// Lanes an entry for rows of n elements: a power of two, at most 32, with
// at most kGloveSlots elements a lane where n allows.
int glove_lanes(int n) {
  int g = 1;
  while (g < 32 && kGloveSlots * g < n) g *= 2;
  return g;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int multiprocessors() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <bool kWrite>
cudaError_t launch_hub_windows(const void* bucket, const void* off, long long n_nodes,
                               const void* hubs, const void* hub_counts, int shift, int wshift,
                               int nw, const void* wofs, const void* weights, void* wdist,
                               void* dcnt, const void* wdofs, const void* out_off, void* ci,
                               void* cj, void* sums, cudaStream_t stream) {
  const int smem = kWrite ? kHubWriteSmem : kHubCountSmem;
  cudaError_t err = cudaFuncSetAttribute(cooc_hub_window_kernel<kWrite>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = multiprocessors();
  if (sms == 0) return cudaErrorInvalidDevice;
  cooc_hub_window_kernel<kWrite><<<sms * (kWrite ? 1 : 8), kThreads, smem, stream>>>(
      static_cast<const unsigned*>(bucket), static_cast<const long long*>(off), n_nodes,
      static_cast<const int32_t*>(hubs), static_cast<const unsigned*>(hub_counts), shift,
      wshift, nw, static_cast<const unsigned*>(wofs), static_cast<const double*>(weights),
      static_cast<unsigned*>(wdist), static_cast<unsigned*>(dcnt),
      static_cast<const unsigned*>(wdofs), static_cast<const long long*>(out_off),
      static_cast<int32_t*>(ci), static_cast<int32_t*>(cj), static_cast<float*>(sums));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cnt[a] (zeroed, N uint32) += the partners of every walk position whose
// node is a, over the J strides.
int ebt_cooc_count(const void* walks, long long n_walks, int L, const void* strides, int J,
                   void* cnt, void* stream) {
  const long long positions = n_walks * L;
  if (positions == 0) return 0;
  cooc_count_kernel<<<blocks_for(positions), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(walks), positions, L, static_cast<const int32_t*>(strides), J,
      static_cast<unsigned*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = x[0] + ... + x[i - 1] for i = 0..n (x uint32, out int64 [n + 1]);
// part is scratch of max(1, ceil(n / 2048)) int64.
int ebt_cooc_scan(const void* x, long long n, void* part, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kScanChunk - 1) / kScanChunk;
  const unsigned* xs = static_cast<const unsigned*>(x);
  long long* ps = static_cast<long long*>(part);
  long long* os = static_cast<long long*>(out);
  if (nb) cooc_scan_reduce_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(xs, n, ps);
  cooc_scan_partials_kernel<<<1, kThreads, 0, s>>>(ps, nb, os + n);
  if (nb) cooc_scan_down_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(xs, n, ps, os);
  return static_cast<int>(cudaGetLastError());
}

// Write every walk position's entries (uint32 b << shift | j) into its
// center's segment of ent at off; cnt (from ebt_cooc_count) counts down as
// slots are taken. In sweeps of about sweep_bytes of entries each (at most
// 255) over `bound` (>= the entries' count), with one byte a position in
// `sweep` (W L bytes) when there is more than one.
int ebt_cooc_scatter(const void* walks, long long n_walks, int L, const void* strides, int J,
                     int shift, const void* off, void* cnt, void* ent, long long bound,
                     long long sweep_bytes, void* sweep, void* stream) {
  const long long positions = n_walks * L;
  if (positions == 0 || bound == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sweeps = std::min<long long>(
      255, std::max<long long>(1, (4 * bound + sweep_bytes - 1) / sweep_bytes));
  const long long width = (bound + sweeps - 1) / sweeps;
  uint8_t* ids = sweeps > 1 ? static_cast<uint8_t*>(sweep) : nullptr;
  if (ids != nullptr) {
    cooc_sweep_kernel<<<blocks_for(positions), kThreads, 0, s>>>(
        static_cast<const int32_t*>(walks), positions, static_cast<const long long*>(off),
        width, ids);
  }
  for (int k = 0; k < sweeps; ++k) {
    cooc_scatter_kernel<<<blocks_for(positions), kThreads, 0, s>>>(
        static_cast<const int32_t*>(walks), positions, L, static_cast<const int32_t*>(strides),
        J, shift, static_cast<const long long*>(off), static_cast<unsigned*>(cnt),
        static_cast<unsigned*>(ent), ids, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sort and sum every center's segment in place (context into ent, float32
// sum into rec_sum, the distinct count into dcnt). Hubs are listed (hubs,
// room for min(N, total / 8193 + 1); hub_counts = {hubs, chunks}, zeroed;
// chunks, room for total / kHubChunk + the hubs' room), bucketed by window
// of 2^wshift contexts (nw a hub) into rec_sum's part of their segments, and
// their distinct contexts counted: wcnt and wdist ([hub room][nw], zeroed)
// take each window's entries and distinct contexts, wofs and wdofs ([hub
// room][nw + 1]) their prefixes within the hub.
int ebt_cooc_sort(void* ent, void* rec_sum, const void* off, long long n_nodes, int shift,
                  const void* weights, void* dcnt, void* hubs, void* hub_counts, void* chunks,
                  int wshift, int nw, void* wcnt, void* wofs, void* wdist, void* wdofs,
                  void* stream) {
  if (n_nodes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n_nodes + kCentersPerBlock - 1) / kCentersPerBlock;
  const unsigned* counts = static_cast<const unsigned*>(hub_counts);
  const int2* list = static_cast<const int2*>(chunks);
  const unsigned* entries = static_cast<const unsigned*>(ent);
  const long long* offs = static_cast<const long long*>(off);
  const int32_t* hub_ids = static_cast<const int32_t*>(hubs);
  cooc_sort_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<unsigned*>(ent), static_cast<float*>(rec_sum), offs, n_nodes, shift,
      static_cast<const double*>(weights), static_cast<unsigned*>(dcnt),
      static_cast<int32_t*>(hubs), static_cast<unsigned*>(hub_counts),
      static_cast<int2*>(chunks));
  const int sms = multiprocessors();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  cooc_hub_hist_kernel<<<sms * 4, kThreads, 0, s>>>(entries, offs, hub_ids, counts, list, shift,
                                                    wshift, nw, static_cast<unsigned*>(wcnt));
  cooc_hub_prefix_kernel<<<sms * 4, kThreads, 0, s>>>(static_cast<const unsigned*>(wcnt), counts,
                                                      nw, static_cast<unsigned*>(wofs));
  cooc_hub_scatter_kernel<<<sms * 4, kThreads, 0, s>>>(
      entries, static_cast<unsigned*>(rec_sum), offs, hub_ids, counts, list, shift, wshift, nw,
      static_cast<const unsigned*>(wofs), static_cast<unsigned*>(wcnt));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_hub_windows<false>(rec_sum, off, n_nodes, hubs, hub_counts, shift, wshift, nw,
                                  wofs, weights, wdist, dcnt, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cooc_hub_prefix_kernel<<<sms * 4, kThreads, 0, s>>>(static_cast<const unsigned*>(wdist),
                                                      counts, nw, static_cast<unsigned*>(wdofs));
  return static_cast<int>(cudaGetLastError());
}

// The output: every center's distinct (center, context, sum) at out_off,
// the hubs' from their buckets (see ebt_cooc_sort).
int ebt_cooc_write(const void* ent, const void* rec_sum, const void* off, const void* dcnt,
                   const void* out_off, long long n_nodes, int shift, const void* weights,
                   const void* hubs, const void* hub_counts, int wshift, int nw,
                   const void* wofs, const void* wdofs, void* ci, void* cj, void* sums,
                   void* stream) {
  if (n_nodes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cooc_copy_kernel<<<blocks_for(n_nodes * 32), kThreads, 0, s>>>(
      static_cast<const unsigned*>(ent), static_cast<const float*>(rec_sum),
      static_cast<const long long*>(off), static_cast<const unsigned*>(dcnt),
      static_cast<const long long*>(out_off), n_nodes, static_cast<int32_t*>(ci),
      static_cast<int32_t*>(cj), static_cast<float*>(sums));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_hub_windows<true>(
      rec_sum, off, n_nodes, hubs, hub_counts, shift, wshift, nw, wofs, weights, nullptr,
      nullptr, wdofs, out_off, ci, cj, sums, s));
}

// K13b's gradient launch for B drawn entries (see glove_gradients_kernel):
// i, j, g [B], rows_w [B, D] = g w_i and the loss partials, ceil(B / 256)
// of them.
int ebt_glove_gradients(const void* ci, const void* cj, const void* f_x, const void* log_x,
                        const void* ids, const void* node_emb, const void* ctx_emb,
                        const void* center_bias, const void* ctx_bias, void* out_i,
                        void* out_j, void* out_g, void* rows_w, void* partials, long long B,
                        int D, float inv_b, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned16({node_emb, ctx_emb, rows_w});
  const int n = vec ? D / 4 : D;
  const int G = glove_lanes(n);
  const auto* ci_ = static_cast<const int32_t*>(ci);
  const auto* cj_ = static_cast<const int32_t*>(cj);
  const auto* fx_ = static_cast<const float*>(f_x);
  const auto* lx_ = static_cast<const float*>(log_x);
  const auto* ids_ = static_cast<const int32_t*>(ids);
  const auto* cb_ = static_cast<const float*>(center_bias);
  const auto* xb_ = static_cast<const float*>(ctx_bias);
  auto* i_ = static_cast<int32_t*>(out_i);
  auto* j_ = static_cast<int32_t*>(out_j);
  auto* g_ = static_cast<float*>(out_g);
  auto* p_ = static_cast<float*>(partials);
  if (vec) {
    glove_gradients_kernel<float4><<<blocks_for(B), kThreads, 0, s>>>(
        ci_, cj_, fx_, lx_, ids_, static_cast<const float4*>(node_emb),
        static_cast<const float4*>(ctx_emb), cb_, xb_, i_, j_, g_, static_cast<float4*>(rows_w),
        p_, B, n, G, inv_b);
  } else {
    glove_gradients_kernel<float><<<blocks_for(B), kThreads, 0, s>>>(
        ci_, cj_, fx_, lx_, ids_, static_cast<const float*>(node_emb),
        static_cast<const float*>(ctx_emb), cb_, xb_, i_, j_, g_, static_cast<float*>(rows_w),
        p_, B, n, G, inv_b);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13b's node-side update, after ebt_glove_gradients: node[i] += -lr (g c_j)
// with c_j from ctx_emb; both biases += -lr g; *loss = the sum of the
// n_partials loss partials.
int ebt_glove_node_update(void* node_emb, const void* ctx_emb, void* center_bias,
                          void* ctx_bias, const void* i, const void* j, const void* g,
                          const void* partials, long long n_partials, void* loss, long long B,
                          int D, float lr, void* stream) {
  if (B == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16({node_emb, ctx_emb});
  const int n = vec ? D / 4 : D;
  const int G = glove_lanes(n);
  const auto* i_ = static_cast<const int32_t*>(i);
  const auto* j_ = static_cast<const int32_t*>(j);
  const auto* g_ = static_cast<const float*>(g);
  const GloveSide a{static_cast<float*>(node_emb), i_, static_cast<const float*>(ctx_emb), j_,
                    g_};
  const unsigned blocks = blocks_for(B * G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* cb_ = static_cast<float*>(center_bias);
  auto* xb_ = static_cast<float*>(ctx_bias);
  const auto* p_ = static_cast<const float*>(partials);
  auto* loss_ = static_cast<float*>(loss);
  if (vec) {
    glove_node_update_kernel<float4><<<blocks, kThreads, 0, s>>>(
        a, cb_, xb_, i_, j_, g_, p_, n_partials, loss_, B, n, G, -lr);
  } else {
    glove_node_update_kernel<float><<<blocks, kThreads, 0, s>>>(
        a, cb_, xb_, i_, j_, g_, p_, n_partials, loss_, B, n, G, -lr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13b's context-side update, after ebt_glove_node_update:
// ctx_emb[j] += -lr rows_w.
int ebt_glove_context_update(void* ctx_emb, const void* rows_w, const void* j, long long B,
                             int D, float lr, void* stream) {
  if (B == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16({ctx_emb, rows_w});
  const int n = vec ? D / 4 : D;
  const int G = glove_lanes(n);
  const GloveSide a{static_cast<float*>(ctx_emb), static_cast<const int32_t*>(j),
                    static_cast<const float*>(rows_w), nullptr, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    glove_context_update_kernel<float4><<<blocks_for(B * G), kThreads, 0, s>>>(a, B, n, G, -lr);
  } else {
    glove_context_update_kernel<float><<<blocks_for(B * G), kThreads, 0, s>>>(a, B, n, G, -lr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
