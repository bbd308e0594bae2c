// Designs of K5 (CSR membership) and K6 (the GCN edge batch) side by side,
// for edge_batch_probe.py, with the card's rate of independent random
// gathers beside them. Each design is one kernel behind a launcher that
// takes the same arguments.
//
//   gather    one 4-byte load a thread from a hashed index of an int32 array
//             (no load waits on another): the rate of random fetches;
//   thread    the design K5 and K6 had before: a thread a query or slot, a
//             lower-bound search (bisection) over the row, slots in order
//             (positives, then negatives), a positive's source and head
//             gathered apart;
//   group GxQ a group membership search: G lanes a pair, Q pairs a group in
//             flight, a row swept by 16-byte loads (64 ids at G 8, 32 at
//             G 4, one dependent step), a longer row narrowed first by G x 8
//             evenly spaced samples a step; K6 with the kinds mixed in every
//             group (a group's Q negatives, lane q drawing the q-th, and an
//             even share of the positives);
//   guided1   a thread a query or slot, the search reading first the 32-byte
//             sector where an even spread of the row's heads puts dst, then
//             bisecting the side it points to (guided16: a 16-byte chunk);
//   guided    the same with up to ebt::kGuidedSteps interpolated sectors
//             before the bisection: csrc/edges.cu's kernels (included here);
//   mixed     guided, positives and negatives on alternate threads;
//   pairs     guided, a positive's (source, head) as one 8-byte record an
//             arc: csrc/edges.cu's K6 on a graph with `arc_pairs`;
//   arc16     pairs, and a negative's source with its row start and degree as
//             one 16-byte record an arc (head, row start, degree, 0: the walk
//             models' `with_walk_arcs` records), no row_ptr read.
//
// Every design draws with the same Philox counters, so at one key and
// offset each K6 design gives the same batch and each K5 design the same
// ids; the script checks that.

#include "../csrc/edges.cu"

namespace ebt {

// The group membership search (K5 and K6): a group of G lanes (G a power
// of two up to 32, each group G consecutive lanes of a warp) looks up one
// (row, dst) pair, the row given as its arc range [lo, hi). A row whose
// 16-byte-aligned span is at most kGroupSpan<G> ids is read in one sweep:
// lane l loads the 16-byte chunks l, G + l, .. (kGroupSweeps of them), all
// at once, and a min over the group's lanes gives the first arc whose head
// is dst. So a short row costs one dependent step, where a lower-bound
// search costs log2(deg) + 1. A longer row (a hub's) is first narrowed:
// G kGroupSamples evenly spaced ids of the range, loaded at once, bracket
// the first place dst can be, and the range shrinks to one gap between two
// samples; a 65,536-id row takes two narrowings and then the sweep.
//
// Every lane of the warp calls these functions together (their shuffles
// name the full warp), each group with its own pair; a group with nothing
// to look up passes an empty range. A chunk is loaded only where it holds
// an id of the range, so no load leaves the array's 16-byte-aligned
// granules, which lie inside its allocation.
constexpr int kGroupSweeps = 2;    // 16-byte chunks a lane loads in a sweep
constexpr int kGroupSamples = 8;   // samples a lane loads in a narrowing
constexpr unsigned kWarpMask = 0xffffffffu;

template <int G>
constexpr int kGroupSpan = 4 * G * kGroupSweeps;

// The index of the first id of the 16-byte chunk that holds col_idx[i]
// (the array may start at any 4-byte boundary).
__device__ __forceinline__ int64_t chunk_of(const int32_t* col_idx, int64_t i) {
  const int64_t shift = (reinterpret_cast<uintptr_t>(col_idx) >> 2) & 3;
  return ((i + shift) & ~int64_t{3}) - shift;
}

// Whether [lo, hi) is read by one sweep.
template <int G>
__device__ __forceinline__ bool sweep_covers(const int32_t* col_idx, int32_t lo, int32_t hi) {
  return hi - chunk_of(col_idx, lo) <= kGroupSpan<G>;
}

// One narrowing of the group's range, where it is longer than a sweep:
// [lo, hi) becomes the gap that holds the first arc whose head is at least
// dst (so dst's first arc, if it has one).
template <int G>
__device__ __forceinline__ void group_narrow(const int32_t* __restrict__ col_idx, int32_t* lo,
                                             int32_t* hi, int32_t dst, int sub) {
  const bool open = !sweep_covers<G>(col_idx, *lo, *hi);
  const int32_t len = *hi - *lo;
  const int32_t stride = open ? (len + G * kGroupSamples - 1) / (G * kGroupSamples) : 1;
  int below = 0;  // samples below dst, of this lane
#pragma unroll
  for (int r = 0; r < kGroupSamples; ++r) {
    const int64_t k = static_cast<int64_t>(sub * kGroupSamples + r) * stride;
    below += open && k < len && __ldg(col_idx + *lo + k) < dst;
  }
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
    below += __shfl_xor_sync(kWarpMask, below, offset, G);
  }
  if (open) {
    // The samples are sorted: the first below dst is sample `below`, so
    // dst's first arc lies after sample below - 1 and at most at sample below.
    const int64_t base = *lo;
    const int64_t after = base + static_cast<int64_t>(below - 1) * stride + 1;
    const int64_t until = base + static_cast<int64_t>(below) * stride + 1;
    *lo = static_cast<int32_t>(after > base ? after : base);
    *hi = static_cast<int32_t>(until < *hi ? until : *hi);
  }
}

// Narrow until one sweep covers every group's range of the warp.
template <int G>
__device__ __forceinline__ void group_narrow_all(const int32_t* __restrict__ col_idx,
                                                 int32_t* lo, int32_t* hi, int32_t dst,
                                                 int sub) {
  while (__any_sync(kWarpMask, !sweep_covers<G>(col_idx, *lo, *hi))) {
    group_narrow<G>(col_idx, lo, hi, dst, sub);
  }
}

// The sweep's loads: this lane's chunks of [lo, hi), which one sweep
// covers; a chunk outside the range is not loaded (INT_MAX).
template <int G>
__device__ __forceinline__ void sweep_load(const int32_t* __restrict__ col_idx, int32_t lo,
                                           int32_t hi, int sub, int4 (&v)[kGroupSweeps]) {
  const int64_t first = chunk_of(col_idx, lo);
#pragma unroll
  for (int k = 0; k < kGroupSweeps; ++k) {
    const int64_t at = first + 4 * (k * G + sub);
    v[k] = lo < hi && at < hi ? __ldg(reinterpret_cast<const int4*>(col_idx + at))
                              : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  }
}

// The first arc of [lo, hi) whose head is dst, from the sweep's loads, the
// same on every lane of the group; INT_MAX where there is none.
template <int G>
__device__ __forceinline__ int32_t sweep_find(const int32_t* col_idx, const int4 (&v)[kGroupSweeps],
                                              int32_t lo, int32_t hi, int32_t dst, int sub) {
  const int64_t first = chunk_of(col_idx, lo);
  int32_t pos = INT_MAX;
#pragma unroll
  for (int k = kGroupSweeps - 1; k >= 0; --k) {
    const int64_t at = first + 4 * (k * G + sub);
    const int32_t ids[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      if (ids[q] == dst && at + q >= lo && at + q < hi) pos = static_cast<int32_t>(at + q);
    }
  }
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
    pos = min(pos, __shfl_xor_sync(kWarpMask, pos, offset, G));
  }
  return pos;
}

// dst's first arc in [lo, hi) for one group (INT_MAX: none), its loads
// issued and awaited at once.
template <int G>
__device__ __forceinline__ int32_t group_find(const int32_t* __restrict__ col_idx, int32_t lo,
                                              int32_t hi, int32_t dst, int sub) {
  group_narrow_all<G>(col_idx, &lo, &hi, dst, sub);
  int4 v[kGroupSweeps];
  sweep_load<G>(col_idx, lo, hi, sub, v);
  return sweep_find<G>(col_idx, v, lo, hi, dst, sub);
}

}  // namespace ebt

namespace {

__global__ void gather_kernel(const int32_t* __restrict__ a, uint32_t n_a, int64_t n,
                              uint32_t seed, int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  uint32_t h = static_cast<uint32_t>(i) * 0x9E3779B1u ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  out[i] = __ldg(a + bounded(h, n_a));
}

// Bisection over [lo, hi).
__device__ __forceinline__ int32_t bisect(const int32_t* __restrict__ col_idx, int32_t lo,
                                          int32_t hi, int32_t dst) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(col_idx + mid) < dst) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The guided1 search: one sector (kIds ids) at the even-spread place, then
// a bisection of the side it points to.
template <int kIds>
__device__ __forceinline__ int32_t guided1_lower_bound(const int32_t* __restrict__ col_idx,
                                                       int32_t lo, int32_t hi, int32_t dst,
                                                       uint32_t n_ids, bool* found) {
  if (lo >= hi) {
    *found = false;
    return lo;
  }
  const int32_t guess = lo + static_cast<int32_t>(
      static_cast<uint64_t>(hi - lo) * static_cast<uint32_t>(dst) / n_ids);
  const int64_t shift = (reinterpret_cast<uintptr_t>(col_idx) >> 2) & (kIds - 1);
  const int64_t c = (((guess < hi ? guess : hi - 1) + shift) & ~int64_t{kIds - 1}) - shift;
  int32_t ids[kIds];
#pragma unroll
  for (int h = 0; h < kIds; h += 4) {
    const int4 v = c + h + 3 >= lo && c + h < hi
                       ? __ldg(reinterpret_cast<const int4*>(col_idx + c + h))
                       : make_int4(0, 0, 0, 0);
    ids[h] = v.x;
    ids[h + 1] = v.y;
    ids[h + 2] = v.z;
    ids[h + 3] = v.w;
  }
  const int32_t v0 = static_cast<int32_t>(c > lo ? c : lo);
  const int32_t v1 = static_cast<int32_t>(c + kIds < hi ? c + kIds : hi);
  int less = 0;
  bool eq = false;
#pragma unroll
  for (int q = 0; q < kIds; ++q) {
    const bool valid = c + q >= lo && c + q < hi;
    less += valid && ids[q] < dst;
    eq |= valid && ids[q] == dst;
  }
  if (less > 0 && less < v1 - v0) {
    *found = eq;
    return v0 + less;
  }
  const int32_t at = less == 0 ? bisect(col_idx, lo, v0, dst) : bisect(col_idx, v1, hi, dst);
  *found = less == 0 && at == v0 ? eq : at < hi && __ldg(col_idx + at) == dst;
  return at;
}

// The search of the thread designs (K5's, and K6's redraw check): 0 a
// bisection, 1 guided1, 2 guided16, 3 guided.
template <int kSearch>
__device__ __forceinline__ int32_t search(const int32_t* __restrict__ col_idx, int32_t lo,
                                          int32_t hi, int32_t dst, uint32_t n_ids,
                                          bool* found) {
  if (kSearch == 1) return guided1_lower_bound<8>(col_idx, lo, hi, dst, n_ids, found);
  if (kSearch == 2) return guided1_lower_bound<4>(col_idx, lo, hi, dst, n_ids, found);
  if (kSearch == 3) return ebt::guided_lower_bound(col_idx, lo, hi, dst, n_ids, found);
  const int32_t at = bisect(col_idx, lo, hi, dst);
  *found = at < hi && __ldg(col_idx + at) == dst;
  return at;
}

template <int kSearch>
__global__ void thread_edge_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int64_t n,
    int32_t n_arcs, uint32_t n_nodes, int32_t* __restrict__ ids, uint8_t* __restrict__ found) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bool hit;
  int32_t at;
  if (kSearch == 0) {
    at = ebt::arc_lower_bound(row_ptr, col_idx, src[i], dst[i], &hit);
  } else {
    const int32_t s = __ldg(src + i);
    at = search<kSearch>(col_idx, __ldg(row_ptr + s), __ldg(row_ptr + s + 1), __ldg(dst + i),
                         n_nodes, &hit);
  }
  ids[i] = hit ? at : n_arcs;
  found[i] = hit ? 1 : 0;
}

// K6 a thread a slot with the K5 search kSearch; kMixed: positives and
// negatives on alternate threads; kArc16: a negative's source, row start and
// degree from one 16-byte record (the positives then read `a.pairs`).
template <int kSearch, bool kMixed, bool kArc16>
__global__ void thread_edge_batch_kernel(const EdgeBatch a, const int4* __restrict__ arcs16) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= a.n) return;
  int64_t i = t;
  if (kMixed) {
    const int64_t n_neg = a.n - a.n_pos;
    const int64_t m = a.n_pos < n_neg ? a.n_pos : n_neg;
    if (t < 2 * m) {
      i = (t & 1) ? a.n_pos + (t >> 1) : (t >> 1);
    } else {
      i = a.n_pos > n_neg ? m + (t - 2 * m) : a.n_pos + m + (t - 2 * m);
    }
  }
  const uint32_t lo = static_cast<uint32_t>(i), hi = static_cast<uint32_t>(i >> 32);
  if (i < a.n_pos) {
    const Philox4 r = philox4x32_10(Philox4{lo, hi, 0u, a.offset}, a.k0, a.k1);
    const int32_t arc = static_cast<int32_t>(bounded(r.x, a.n_arcs));
    if (a.pairs != nullptr) {
      const int2 pair = __ldg(a.pairs + arc);
      a.out_src[i] = pair.x;
      a.out_dst[i] = pair.y;
    } else {
      a.out_src[i] = __ldg(a.sources + arc);
      a.out_dst[i] = __ldg(a.col_idx + arc);
    }
    a.labels[i] = 1.0f;
    return;
  }
  int32_t s = 0, d = 0;
  for (int attempt = 0; attempt <= a.n_attempts; ++attempt) {
    int32_t row_lo = 0, row_hi = 0;
    if (kArc16) {
      const Philox4 r = philox4x32_10(
          Philox4{lo, hi, static_cast<uint32_t>(attempt), a.offset}, a.k0, a.k1);
      const int4 rec = __ldg(arcs16 + bounded(r.x, a.n_arcs));
      s = rec.x;
      row_lo = rec.y;
      row_hi = rec.y + rec.z;
      d = __ldg(a.col_idx + bounded(r.y, a.n_arcs));
    } else {
      negative_draw(a, i, attempt, &s, &d);
    }
    if (attempt == a.n_attempts) break;
    if (s == d) continue;
    if (kSearch == 0) {
      bool is_arc = false;
      ebt::arc_lower_bound(a.avoid_row_ptr, a.avoid_col_idx, s, d, &is_arc);
      if (!is_arc) break;
      continue;
    }
    if (!kArc16) {
      row_lo = __ldg(a.avoid_row_ptr + s);
      row_hi = __ldg(a.avoid_row_ptr + s + 1);
    }
    bool is_arc;
    search<kSearch>(a.avoid_col_idx, row_lo, row_hi, d, a.avoid_nodes, &is_arc);
    if (!is_arc) break;
  }
  a.out_src[i] = s;
  a.out_dst[i] = d;
  a.labels[i] = 0.0f;
}

// The group designs.
template <int G, int Q>
__global__ void __launch_bounds__(kThreads) group_edge_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n, int32_t n_arcs, int32_t* __restrict__ ids, uint8_t* __restrict__ found) {
  const int sub = threadIdx.x & (G - 1);
  const int64_t thread = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if ((thread & ~int64_t{31}) / G * Q >= n) return;  // uniform across the warp
  const int64_t first = thread / G * Q;
  int32_t lo[Q], hi[Q], d[Q], s[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = first + q < n ? first + q : n - 1;
    s[q] = __ldg(src + i);
    d[q] = __ldg(dst + i);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    lo[q] = first + q < n ? __ldg(row_ptr + s[q]) : 0;
    hi[q] = first + q < n ? __ldg(row_ptr + s[q] + 1) : 0;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) ebt::group_narrow_all<G>(col_idx, &lo[q], &hi[q], d[q], sub);
  int4 v[Q][ebt::kGroupSweeps];
#pragma unroll
  for (int q = 0; q < Q; ++q) ebt::sweep_load<G>(col_idx, lo[q], hi[q], sub, v[q]);
  int32_t mine = INT_MAX;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int32_t pos = ebt::sweep_find<G>(col_idx, v[q], lo[q], hi[q], d[q], sub);
    if (sub == q) mine = pos;
  }
  if (sub < Q && first + sub < n) {
    const bool hit = mine != INT_MAX;
    ids[first + sub] = hit ? mine : n_arcs;
    found[first + sub] = hit ? 1 : 0;
  }
}

template <int G, int Q>
__global__ void __launch_bounds__(kThreads) group_edge_batch_kernel(const EdgeBatch a,
                                                                    int64_t units) {
  const int sub = threadIdx.x & (G - 1);
  const int64_t thread = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if ((thread & ~int64_t{31}) / G >= units) return;  // uniform across the warp
  const int64_t unit = thread / G;
  const bool live = unit < units;
  const int64_t n_neg = a.n - a.n_pos;
  const int64_t p = live ? unit * a.n_pos / units + sub : 0;
  const bool has_pos = live && p < (unit + 1) * a.n_pos / units;
  int32_t pos_src = 0, pos_dst = 0;
  if (has_pos) {
    const Philox4 r = philox4x32_10(
        Philox4{static_cast<uint32_t>(p), static_cast<uint32_t>(p >> 32), 0u, a.offset},
        a.k0, a.k1);
    const int32_t arc = static_cast<int32_t>(bounded(r.x, a.n_arcs));
    pos_dst = __ldg(a.col_idx + arc);
    pos_src = __ldg(a.sources + arc);
  }
  const int64_t j = unit * Q + sub;
  const bool has_neg = live && sub < Q && j < n_neg;
  const int64_t slot = a.n_pos + j;
  int attempt = 0;
  int32_t s = 0, d = 0;
  if (has_neg) negative_draw(a, slot, 0, &s, &d);
  bool open = has_neg && a.n_attempts > 0;
  while (__any_sync(ebt::kWarpMask, open)) {
    const bool search = open && s != d;
    const int32_t lo = search ? __ldg(a.avoid_row_ptr + s) : 0;
    const int32_t hi = search ? __ldg(a.avoid_row_ptr + s + 1) : 0;
    int32_t glo[Q], ghi[Q], gd[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      glo[q] = __shfl_sync(ebt::kWarpMask, lo, q, G);
      ghi[q] = __shfl_sync(ebt::kWarpMask, hi, q, G);
      gd[q] = __shfl_sync(ebt::kWarpMask, d, q, G);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      ebt::group_narrow_all<G>(a.avoid_col_idx, &glo[q], &ghi[q], gd[q], sub);
    }
    int4 v[Q][ebt::kGroupSweeps];
#pragma unroll
    for (int q = 0; q < Q; ++q) ebt::sweep_load<G>(a.avoid_col_idx, glo[q], ghi[q], sub, v[q]);
    bool is_arc = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int32_t pos = ebt::sweep_find<G>(a.avoid_col_idx, v[q], glo[q], ghi[q], gd[q], sub);
      if (sub == q) is_arc = pos != INT_MAX;
    }
    if (open) {
      if (s == d || is_arc) {
        ++attempt;
        negative_draw(a, slot, attempt, &s, &d);
        open = attempt < a.n_attempts;
      } else {
        open = false;
      }
    }
  }
  if (has_pos) {
    a.out_src[p] = pos_src;
    a.out_dst[p] = pos_dst;
    a.labels[p] = 1.0f;
  }
  if (has_neg) {
    a.out_src[slot] = s;
    a.out_dst[slot] = d;
    a.labels[slot] = 0.0f;
  }
}

template <int G, int Q>
void group_edge_ids(const int32_t* row_ptr, const int32_t* col_idx, const int32_t* src,
                    const int32_t* dst, long long n, int n_arcs, int32_t* ids, uint8_t* found,
                    cudaStream_t stream) {
  constexpr long long kPerBlock = kThreads / G * Q;
  group_edge_ids_kernel<G, Q><<<static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock),
                                kThreads, 0, stream>>>(row_ptr, col_idx, src, dst, n, n_arcs,
                                                       ids, found);
}

template <int G, int Q>
void group_edge_batch(const EdgeBatch& a, cudaStream_t stream) {
  const long long n_neg = a.n - a.n_pos;
  const long long neg_units = (n_neg + Q - 1) / Q, pos_units = (a.n_pos + G - 1) / G;
  const long long units = neg_units > pos_units ? neg_units : pos_units;
  constexpr long long kUnits = kThreads / G;
  group_edge_batch_kernel<G, Q><<<static_cast<unsigned>((units + kUnits - 1) / kUnits),
                                  kThreads, 0, stream>>>(a, units);
}

}  // namespace

extern "C" {

int probe_gather(const void* a, long long n_a, long long n, unsigned seed, void* out,
                 void* stream) {
  gather_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<uint32_t>(n_a), n, seed,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// design: 0 thread, 1 group 4x4, 2 group 8x4, 3 guided1, 4 guided16,
// 5 guided (csrc/edges.cu's K5).
int probe_edge_ids(int design, const void* row_ptr, const void* col_idx, const void* src,
                   const void* dst, long long n, int n_arcs, int n_nodes, void* ids,
                   void* found, void* stream) {
  const auto rp = static_cast<const int32_t*>(row_ptr);
  const auto ci = static_cast<const int32_t*>(col_idx);
  const auto s = static_cast<const int32_t*>(src);
  const auto d = static_cast<const int32_t*>(dst);
  const auto out = static_cast<int32_t*>(ids);
  const auto hit = static_cast<uint8_t*>(found);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto nn = static_cast<uint32_t>(n_nodes);
  switch (design) {
    case 0:
      thread_edge_ids_kernel<0><<<blocks_for(n), kThreads, 0, st>>>(rp, ci, s, d, n, n_arcs,
                                                                    nn, out, hit);
      break;
    case 1: group_edge_ids<4, 4>(rp, ci, s, d, n, n_arcs, out, hit, st); break;
    case 2: group_edge_ids<8, 4>(rp, ci, s, d, n, n_arcs, out, hit, st); break;
    case 3:
      thread_edge_ids_kernel<1><<<blocks_for(n), kThreads, 0, st>>>(rp, ci, s, d, n, n_arcs,
                                                                    nn, out, hit);
      break;
    case 4:
      thread_edge_ids_kernel<2><<<blocks_for(n), kThreads, 0, st>>>(rp, ci, s, d, n, n_arcs,
                                                                    nn, out, hit);
      break;
    case 5:
      return ebt_csr_edge_ids(row_ptr, col_idx, src, dst, n, n_arcs, n_nodes, ids, found,
                              stream);
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// design: 0 thread, 1 group 4x2, 2 group 8x4, 3 guided1, 4 guided
// (csrc/edges.cu's K6 without pairs), 5 mixed, 6 pairs (csrc/edges.cu's K6),
// 7 arc16. The sampled graph is the graph to avoid; pairs [n_arcs] int2 and
// arcs16 [n_arcs] int4 the records; scale-free draws.
int probe_edge_batch(int design, const void* row_ptr, const void* col_idx, const void* sources,
                     const void* pairs, const void* arcs16, int n_nodes, long long n_arcs,
                     long long n_pos, long long n, int n_attempts, void* out_src,
                     void* out_dst, void* labels, unsigned long long seed, unsigned offset,
                     void* stream) {
  const bool with_pairs = design == 6 || design == 7;
  const EdgeBatch a{static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
                    static_cast<const int32_t*>(sources),
                    with_pairs ? static_cast<const int2*>(pairs) : nullptr,
                    static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
                    n_nodes, static_cast<uint32_t>(n_nodes), static_cast<uint32_t>(n_arcs),
                    n_pos, n, 1, n_attempts, static_cast<int32_t*>(out_src),
                    static_cast<int32_t*>(out_dst), static_cast<float*>(labels),
                    static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), offset};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rec = static_cast<const int4*>(arcs16);
  switch (design) {
    case 0: thread_edge_batch_kernel<0, false, false><<<blocks_for(n), kThreads, 0, st>>>(a, rec); break;
    case 1: group_edge_batch<4, 2>(a, st); break;
    case 2: group_edge_batch<8, 4>(a, st); break;
    case 3: thread_edge_batch_kernel<1, false, false><<<blocks_for(n), kThreads, 0, st>>>(a, rec); break;
    case 4:
    case 6: edge_minibatch_kernel<<<blocks_for(n), kThreads, 0, st>>>(a); break;
    case 5: thread_edge_batch_kernel<3, true, false><<<blocks_for(n), kThreads, 0, st>>>(a, rec); break;
    case 7: thread_edge_batch_kernel<3, false, true><<<blocks_for(n), kThreads, 0, st>>>(a, rec); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
