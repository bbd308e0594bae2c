// K16a `singleton_registers` / `khop_sketches` and K16b
// `edge_sketch_features`: the HyperLogLog k-hop ball sketches behind
// HyperSketching and the GCN's lazy edge features.
//
// K16a replaces embiggen_tpu/ops/hll.py::singleton_registers (:32; the
// hash of each node id, its register index and rho, one register set per
// node) and khop_sketches (:53; `hops` register-wise max propagations, one
// segment_max over the arcs per hop). The singletons launch writes [N, M]
// uint8 registers (M = 2^precision) with the same lowbias32 hash in uint32
// arithmetic and __clz, so the registers equal the reference's bit for
// bit. Each hop launch writes hop h of an [N, H, M] output (the port's
// layout; the reference's is [H, N, M], transposed by its caller) from hop
// h - 1 (or the singletons): out[r] = max(in[r], max over the arcs (r -> c)
// of in[c]), byte by byte. A max does not depend on its order, so the
// sketches are exact too.
//
// The singleton route of K16a (`ebt_hll_ball`) forms hops 1 and 2 of the
// sketches whose base is the singletons, which is every HyperSketching fit
// (embiggen_tpu/models/edge_features.py:111-117), without the singletons
// launch: a singleton row holds one nonzero register, a pure function of
// the node id (its hash's low bits and rho), so hop 1 of v is the max over
// the hashes of v and of its row's ids, and hop 2 over those of v, its row
// and its neighbours' rows. The bytes equal the dense hops' exactly (a max
// of the same registers).
//
// K16b replaces embiggen_tpu/ops/hll.py::edge_sketch_features with
// hll_cardinality: for each (src, dst) pair, the H ball cardinalities of
// both nodes, the H^2 cardinalities of their unions, the overlaps
// max(|s_i| + |d_j| - |s_i u d_j|, 0) and the differences left_i =
// max(|s_i| - overlap(i, H-1), 0), right_j = max(|d_j| - overlap(H-1, j), 0).
// It reads each pair's 2 H M register bytes once from device memory and
// forms every union in registers, where the reference materialises a
// [B, H, H, M] tensor.
//
// What bounds them on the H100: K16a's hops are gathers, like K7's (20M
// rows of M bytes a hop on the slice graph, each from HBM: the [N, M]
// registers are 5 times the L2 at M 256, and the graph has no locality);
// on a heavy-tailed graph, a hub's row walked by one thread or one warp
// outlasts the rest of the launch. The singletons are a write
// of N M bytes. K16b gathers 2 H M bytes per pair and does (2H + H^2) M
// register operations on them; at H 3 and M 256, 1.5 KB and 3,840
// operations per pair. Its bytes bound it on paper (the distinct nodes'
// registers); what held a warp-a-pair design far above that was the
// instructions: 15 sets walked one after another, each re-reading its
// rows, summing byte by byte, and ending in two dependent five-step
// shuffle reductions and a division and a log on one lane.
//
// The singleton route reads ids where the dense hops read registers: hop 1
// row_ptr and the 4-byte ids (84 MB on the slice graph) against 20M
// gathered rows of M bytes, plus the [N, M] output; hop 2 about
// 4 sum(deg(u) + 1) bytes a row against (deg(v) + 1) M.
//
// What the designs do about it: the singleton route runs a warp a row,
// with the row's M registers as bytes in shared memory. Hop 1 reads the
// row's ids coalesced, hashes each (and the row's own id) in registers as
// the singletons launch does, and takes the max into shared memory by byte
// stores, each read back and stored again where a larger value raced it
// (no atomics); then the warp writes the row with 16-byte stores. Hop 2
// is the id route or the hop launch, for every row of the launch, as the
// wrapper picks from the graph's mean and largest degree: the id route
// lays the row's neighbours' rows end to end (a warp scan of their
// lengths), and each lane takes every 32nd id of that list, four loads in
// flight, finding its row by a five-step shuffle search over the scan.
// Hops 3 and later are the hop launch. The singletons run a
// thread per (row, 16 bytes). The hop launch runs a group of lanes a
// row: a lane per 16-byte piece of the row times SLOTS neighbour slots
// (SLOTS > 1 where a row has fewer pieces than the wrapper's lanes a row,
// at the low precisions), each lane taking the byte-wise max of four
// words with __vmaxu4 over every SLOTS-th neighbour's piece, the slots
// merged by shuffles; no atomics. A row longer than the wrapper's split
// (its row plan, `ops/rowplan.py`) is cut into chunks of that many arcs,
// which groups take first in the launch, each writing its maxima to a
// workspace; a second launch (`ebt_hll_hop_merge`) takes each long row's
// own registers and its chunks' maxima. A max is exact in any order, so
// the bytes equal the unsplit hop's. K16b runs G lanes
// a pair (G = the row's words / 8, from 1 at precision 4-5 to 32 from
// precision 10), 32 / G pairs a warp. For H <= 3 (a template on H) each
// lane loads its 8 words (4 at precision 4) of all 2H rows with 16-byte
// loads, forms the H^2 unions in registers with __vmaxu4, and adds every
// set's sum of 2^-r (the exponent field written directly) and zero count
// (one bit a zero byte, __popc) in one pass, over chunks of words at the
// higher precisions. The group then reduces all partials together in
// log2 G shuffle steps (zero counts two to a word), each lane forms the
// cardinalities of its own sets, and the warp writes its pairs' features
// as contiguous rows. Larger H take a general route: the same groups, one
// set after another. The sum of 2^-r is float32, as in the reference, in
// another order, so the features agree to float32 rounding.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The singleton register of node v: its index in the low 16 bits, its
// value (rho, as a byte) in bits 16-23.
__device__ __forceinline__ uint32_t singleton_code(uint32_t v, uint32_t offset, int precision,
                                                   int bits) {
  const uint32_t h = hash32(v + offset);
  const uint32_t idx = h & ((1u << precision) - 1u);
  const int rest = static_cast<int>(h >> precision);
  const int top = (1 << bits) - 1;
  int rho = rest == 0 ? top : __clz(rest) - precision + 1;
  rho = min(max(rho, 1), top);
  return idx | static_cast<uint32_t>(static_cast<uint8_t>(rho)) << 16;
}

__global__ void singletons_kernel(int64_t n, int precision, int bits,
                                  uint32_t offset, uint4* __restrict__ out) {
  const int chunks = (1 << precision) / 16;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t node = t / chunks;
  if (node >= n) return;
  const int chunk = static_cast<int>(t - node * chunks);
  const uint32_t code = singleton_code(static_cast<uint32_t>(node), offset, precision, bits);
  const uint32_t idx = code & 0xFFFFu;
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (static_cast<int>(idx >> 4) == chunk) {
    const int byte = idx & 15;
    words[byte >> 2] = (code >> 16) << (8 * (byte & 3));
  }
  out[t] = make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z),
                    __vmaxu4(a.w, b.w));
}

// in and out are [N, stride] views in units of 16 bytes; each row's
// registers are its first `units` units. Work items [0, n_chunks) are the
// chunks of the long rows (the row plan: chunk_rows, chunk_starts, `split`
// arcs each), whose maxima over their arcs go to partials[item]; item
// n_chunks + r is row r when it has at most `split` arcs. A group of
// units * SLOTS threads takes an item: thread (slot, piece) takes that
// 16-byte piece of every SLOTS-th gathered row, and the slots merge by
// shuffles inside the group (SLOTS > 1 only where the group divides 32).
//
// SLOTS is a template argument, so that at SLOTS 1 the loop is a lane's
// plain walk of its row: 32 registers, and 64 warps an SM to keep gathers
// in flight (unrolling it by 4, in the same call, took 32 registers with
// spills and was no faster).
template <int SLOTS>
__global__ void hop_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
           const uint4* __restrict__ in, int64_t in_stride, uint4* __restrict__ out,
           int64_t out_stride, int64_t n, int units,
           const int32_t* __restrict__ chunk_rows, const int32_t* __restrict__ chunk_starts,
           int64_t n_chunks, int32_t split, uint4* __restrict__ partials) {
  const int group = units * SLOTS;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t item = t / group;
  if (item >= n_chunks + n) return;  // uniform across the group
  const int r = static_cast<int>(t - item * group);
  const int piece = SLOTS == 1 ? r : r % units;
  const int slot = SLOTS == 1 ? 0 : r / units;
  int32_t start, end;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  uint4* dst;
  if (item < n_chunks) {
    const int32_t row = chunk_rows[item];
    start = chunk_starts[item];
    end = start + min(split, row_ptr[row + 1] - start);
    dst = partials + item * units + piece;
  } else {
    const int64_t row = item - n_chunks;
    start = row_ptr[row];
    end = row_ptr[row + 1];
    if (end - start > split) return;  // a long row: its chunks and the merge
    if (slot == 0) acc = __ldg(in + row * in_stride + piece);
    dst = out + row * out_stride + piece;
  }
  for (int32_t a = start + slot; a < end; a += SLOTS) {
    const int64_t col = __ldg(cols + a);
    acc = vmax4(acc, __ldg(in + col * in_stride + piece));
  }
  if (SLOTS > 1) {
    const int lane = threadIdx.x & 31;
    const unsigned mask =
        group == 32 ? kFull : ((1u << group) - 1u) << (lane & ~(group - 1));
    for (int off = units; off < group; off <<= 1) {
      acc.x = __vmaxu4(acc.x, __shfl_xor_sync(mask, acc.x, off));
      acc.y = __vmaxu4(acc.y, __shfl_xor_sync(mask, acc.y, off));
      acc.z = __vmaxu4(acc.z, __shfl_xor_sync(mask, acc.z, off));
      acc.w = __vmaxu4(acc.w, __shfl_xor_sync(mask, acc.w, off));
    }
  }
  if (slot == 0) *dst = acc;
}

// A thread a (long row, 16-byte piece): the row's own registers and its
// chunks' partials, a byte-wise max (exact in any order).
__global__ void hop_merge_kernel(const int32_t* __restrict__ long_rows,
                                 const int32_t* __restrict__ chunk_ptr, int64_t n_long,
                                 const uint4* __restrict__ in, int64_t in_stride,
                                 const uint4* __restrict__ partials,
                                 uint4* __restrict__ out, int64_t out_stride, int units) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t i = t / units;
  if (i >= n_long) return;
  const int piece = static_cast<int>(t - i * units);
  const int64_t row = long_rows[i];
  uint4 acc = __ldg(in + row * in_stride + piece);
  const int32_t last = chunk_ptr[i + 1];
  for (int32_t k = chunk_ptr[i]; k < last; ++k) {
    acc = vmax4(acc, __ldg(partials + static_cast<int64_t>(k) * units + piece));
  }
  out[row * out_stride + piece] = acc;
}

// ------------------------------------------------ the singleton route
constexpr int kBallWarps = 8;    // rows a block, a warp each
constexpr int kRowUnroll = 2;    // ids of the row's own list in flight a lane
constexpr int kBallUnroll = 4;   // ids of its neighbours' rows in flight a lane

// Takes the max of each lane's codes' values (code 0: none) into their
// registers, bytes of the row's registers in shared memory, for the whole
// warp at once. A byte store may land under a larger one that raced it, so
// each lane stores while its byte holds less, then reads it back, and a
// lane whose value lost stores again; no atomics. Every lane calls it.
template <int U>
__device__ __forceinline__ void put_codes(volatile uint8_t* regs, const uint32_t (&codes)[U]) {
  unsigned pending = 0;
#pragma unroll
  for (int q = 0; q < U; ++q) pending |= static_cast<unsigned>(codes[q] != 0u) << q;
  while (__any_sync(kFull, pending != 0)) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const uint32_t idx = codes[q] & 0xFFFFu, rho = codes[q] >> 16;
      if ((pending >> q & 1u) && regs[idx] < rho) regs[idx] = static_cast<uint8_t>(rho);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const uint32_t idx = codes[q] & 0xFFFFu, rho = codes[q] >> 16;
      if ((pending >> q & 1u) && regs[idx] >= rho) pending &= ~(1u << q);
    }
    __syncwarp();
  }
}

// Hop 1 (SECOND false) or hop 2 by the id route of the singletons'
// sketches, a warp a row. out is [N, stride] in units of 16 bytes; a row's
// registers are its first M / 16 units.
template <bool SECOND>
__device__ __forceinline__ void id_ball(const int32_t* __restrict__ row_ptr,
                                        const int32_t* __restrict__ cols, int64_t n,
                                        int precision, int bits, uint32_t offset,
                                        uint4* __restrict__ out, int64_t stride) {
  extern __shared__ uint4 ball_smem[];
  const int chunks = (1 << precision) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t v = blockIdx.x * static_cast<int64_t>(kBallWarps) + warp;
  if (v >= n) return;  // uniform across the warp
  const int32_t vs = __ldg(row_ptr + v), ve = __ldg(row_ptr + v + 1);
  uint4* regs4 = ball_smem + warp * chunks;
  volatile uint8_t* regs = reinterpret_cast<volatile uint8_t*>(regs4);
  for (int ch = lane; ch < chunks; ch += 32) regs4[ch] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  // v itself (position vs - 1), then its row.
  for (int32_t j0 = vs - 1; j0 < ve; j0 += 32 * kRowUnroll) {
    uint32_t codes[kRowUnroll];
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const int32_t j = j0 + q * 32 + lane;
      const int64_t id = j >= ve ? -1 : (j < vs ? v : __ldg(cols + j));
      codes[q] = id < 0 ? 0u
                        : singleton_code(static_cast<uint32_t>(id), offset, precision, bits);
    }
    put_codes(regs, codes);
  }
  if (SECOND) {
    for (int32_t j0 = vs; j0 < ve; j0 += 32) {
      // Lane l holds neighbour j0 + l's row; the rows end to end are the ids.
      int32_t start = 0, len = 0;
      if (j0 + lane < ve) {
        const int32_t u = __ldg(cols + j0 + lane);
        start = __ldg(row_ptr + u);
        len = __ldg(row_ptr + u + 1) - start;
      }
      int32_t incl = len;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int32_t total = __shfl_sync(kFull, incl, 31);
      const int32_t excl = incl - len;
      for (int32_t k0 = 0; k0 < total; k0 += 32 * kBallUnroll) {
        int32_t w[kBallUnroll];
#pragma unroll
        for (int q = 0; q < kBallUnroll; ++q) {
          const int32_t k = k0 + q * 32 + lane;
          int owner = 0;  // the last lane whose rows start at or before k
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            if (__shfl_sync(kFull, excl, owner + step) <= k) owner += step;
          }
          const int32_t at = __shfl_sync(kFull, start, owner) + k - __shfl_sync(kFull, excl, owner);
          w[q] = k < total ? __ldg(cols + at) : -1;
        }
        uint32_t codes[kBallUnroll];
#pragma unroll
        for (int q = 0; q < kBallUnroll; ++q) {
          codes[q] = w[q] < 0 ? 0u
                              : singleton_code(static_cast<uint32_t>(w[q]), offset, precision, bits);
        }
        put_codes(regs, codes);
      }
    }
  }
  __syncwarp();
  uint4* row_out = out + v * stride;
  for (int ch = lane; ch < chunks; ch += 32) row_out[ch] = regs4[ch];
}

__global__ void __launch_bounds__(kBallWarps * 32) hop1_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols, int64_t n,
    int precision, int bits, uint32_t offset, uint4* __restrict__ out, int64_t stride) {
  id_ball<false>(row_ptr, cols, n, precision, bits, offset, out, stride);
}

__global__ void __launch_bounds__(kBallWarps * 32) hop2_ids_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ cols, int64_t n,
    int precision, int bits, uint32_t offset, uint4* __restrict__ out, int64_t stride) {
  id_ball<true>(row_ptr, cols, n, precision, bits, offset, out, stride);
}

// One bit (the top one) set for each zero byte of w.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t w) {
  return ~(((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w | 0x7F7F7F7Fu);
}

// Nonzero when a byte of w is 127 or more, where 2^-r has no exponent field.
__device__ __forceinline__ uint32_t wide_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x01010101u) | w) & 0x80808080u;
}

// Sum of 2^-r over the four registers of w, each exactly. With every
// register at most 126, 127 - r is taken for the four bytes at once (no
// borrow) and each byte shifted into a float's exponent field; WIDE takes
// them one by one, 2^-r below 2^-126 a denormal or 0.
template <bool WIDE>
__device__ __forceinline__ float inv_sum(uint32_t w) {
  if (!WIDE) {
    const uint32_t t = 0x7F7F7F7Fu - w;
    return (__uint_as_float((t << 23) & 0x7F800000u) + __uint_as_float((t << 15) & 0x7F800000u)) +
           (__uint_as_float((t << 7) & 0x7F800000u) + __uint_as_float((t >> 1) & 0x7F800000u));
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t r = (w >> (8 * k)) & 0xFFu;
    sum += r <= 126u ? __uint_as_float((127u - r) << 23)
                     : (r <= 149u ? __uint_as_float(1u << (149u - r)) : 0.0f);
  }
  return sum;
}

__device__ __forceinline__ float cardinality(float sum, int zeros, float alpha_mm, float fm) {
  const float raw = alpha_mm / sum;
  const float linear = fm * logf(fm / fmaxf(static_cast<float>(zeros), 1e-9f));
  return (raw <= 2.5f * fm && zeros > 0) ? linear : raw;
}

// Feature k of a pair from its 2H + H^2 cardinalities (balls of src, of
// dst, then the unions (i, j) row by row).
__device__ __forceinline__ float feature(const float* card, int h, int k) {
  if (k < h * h) return fmaxf(card[k / h] + card[h + k % h] - card[2 * h + k], 0.0f);
  if (k < h * h + h) {
    const int i = k - h * h;  // left_i, against overlap(i, H - 1)
    const float ov = fmaxf(card[i] + card[2 * h - 1] - card[2 * h + i * h + h - 1], 0.0f);
    return fmaxf(card[i] - ov, 0.0f);
  }
  const int j = k - h * h - h;  // right_j, against overlap(H - 1, j)
  const float ov = fmaxf(card[h - 1] + card[h + j] - card[2 * h + (h - 1) * h + j], 0.0f);
  return fmaxf(card[h + j] - ov, 0.0f);
}

template <int WPC>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < WPC / 4; ++i) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + i);
    w[4 * i] = t.x;
    w[4 * i + 1] = t.y;
    w[4 * i + 2] = t.z;
    w[4 * i + 3] = t.w;
  }
}

// Adds one chunk's words of every set to the partial sums and zero counts.
template <int H, int WPC, bool WIDE>
__device__ __forceinline__ void accumulate(const uint32_t (&s)[H][WPC],
                                           const uint32_t (&d)[H][WPC], float* sum,
                                           int* zeros) {
#pragma unroll
  for (int q = 0; q < WPC; ++q) {
    uint32_t zs[H], zd[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      zs[i] = zero_bytes(s[i][q]);
      zd[i] = zero_bytes(d[i][q]);
      sum[i] += inv_sum<WIDE>(s[i][q]);
      sum[H + i] += inv_sum<WIDE>(d[i][q]);
      zeros[i] += __popc(zs[i]);
      zeros[H + i] += __popc(zd[i]);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        sum[2 * H + i * H + j] += inv_sum<WIDE>(__vmaxu4(s[i][q], d[j][q]));
        zeros[2 * H + i * H + j] += __popc(zs[i] & zd[j]);
      }
    }
  }
}

// Writes the features of a warp's `per_warp` pairs, from their
// cardinalities in `cards` (n_sets a pair), as contiguous rows.
__device__ __forceinline__ void write_features(const float* cards, int h, int64_t first,
                                               int per_warp, int64_t n_pairs, int lane,
                                               float* __restrict__ out) {
  const int n_sets = 2 * h + h * h, n_feats = h * h + 2 * h;
  float* o = out + first * n_feats;
  for (int k = lane; k < per_warp * n_feats; k += 32) {
    const int p = k / n_feats;
    if (first + p < n_pairs) o[k] = feature(cards + p * n_sets, h, k - p * n_feats);
  }
}

// H <= 3: `group` lanes a pair (a power of two, at most 32), each over
// chunks of WPC words of every row. Block kThreads / group pairs. At most
// 128 registers a thread, so two blocks fit an SM: at H 3 the compiler's
// own choice (171) ran 2.0 ms at 2^20 pairs and precision 8, this 1.2.
template <int H, int WPC>
__global__ void __launch_bounds__(kThreads, 2) edge_features_kernel(
    const uint32_t* __restrict__ sketches, int words, int group,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int64_t n_pairs,
    float alpha_mm, float* __restrict__ out) {
  constexpr int kSets = 2 * H + H * H;
  __shared__ float sums[kThreads * kSets];
  __shared__ int zero_counts[kThreads * kSets];
  const int lane = threadIdx.x & 31, sub = threadIdx.x & (group - 1);
  const int local = threadIdx.x / group, per_warp = 32 / group;
  const int warp_local = (threadIdx.x >> 5) * per_warp;
  const int64_t block_first = blockIdx.x * static_cast<int64_t>(kThreads / group);
  if (block_first + warp_local >= n_pairs) return;  // uniform across the warp
  // A lane of a pair past the end works on the last pair and writes nothing.
  const int64_t pair = block_first + local < n_pairs ? block_first + local : n_pairs - 1;
  const int64_t row_words = static_cast<int64_t>(H) * words;
  const uint32_t* s_regs = sketches + src[pair] * row_words;
  const uint32_t* d_regs = sketches + dst[pair] * row_words;
  float sum[kSets];
  int zeros[kSets];
#pragma unroll
  for (int k = 0; k < kSets; ++k) {
    sum[k] = 0.0f;
    zeros[k] = 0;
  }
  for (int w0 = sub * WPC; w0 < words; w0 += group * WPC) {
    uint32_t s[H][WPC], d[H][WPC];
    uint32_t any = 0;  // a byte of it is at least each register in its place
#pragma unroll
    for (int i = 0; i < H; ++i) {
      load_words<WPC>(s_regs + i * words + w0, s[i]);
      load_words<WPC>(d_regs + i * words + w0, d[i]);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int q = 0; q < WPC; ++q) any |= s[i][q] | d[i][q];
    }
    if (wide_bytes(any)) {
      accumulate<H, WPC, true>(s, d, sum, zeros);
    } else {
      accumulate<H, WPC, false>(s, d, sum, zeros);
    }
  }
  // Zero counts are at most 4096, so two share a word through the shuffles.
  int packed[(kSets + 1) / 2];
#pragma unroll
  for (int k = 0; k < kSets; k += 2) {
    packed[k / 2] = zeros[k] | (k + 1 < kSets ? zeros[k + 1] << 16 : 0);
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kSets; ++k) sum[k] += __shfl_xor_sync(kFull, sum[k], off);
#pragma unroll
    for (int k = 0; k < (kSets + 1) / 2; ++k) packed[k] += __shfl_xor_sync(kFull, packed[k], off);
  }
  float* my_sums = sums + local * kSets;
  int* my_zeros = zero_counts + local * kSets;
#pragma unroll
  for (int k = 0; k < kSets; ++k) {
    if ((k & (group - 1)) == sub) {
      my_sums[k] = sum[k];
      my_zeros[k] = (packed[k / 2] >> (16 * (k & 1))) & 0xFFFF;
    }
  }
  __syncwarp();
  const float fm = static_cast<float>(words * 4);
  for (int k = sub; k < kSets; k += group) {
    my_sums[k] = cardinality(my_sums[k], my_zeros[k], alpha_mm, fm);
  }
  __syncwarp();
  write_features(sums + warp_local * kSets, H, block_first + warp_local, per_warp, n_pairs,
                 lane, out);
}

// Any H: `group` lanes a pair, one set after another, each lane over its
// 16-byte pieces of the set's rows. Block kGeneralThreads / group pairs,
// with (pairs) * n_sets floats and ints of dynamic shared memory.
constexpr int kGeneralThreads = 64;

__global__ void __launch_bounds__(kGeneralThreads) edge_features_general_kernel(
    const uint32_t* __restrict__ sketches, int h, int words, int group,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int64_t n_pairs,
    float alpha_mm, float* __restrict__ out) {
  extern __shared__ float general_smem[];
  const int n_sets = 2 * h + h * h;
  const int pairs = kGeneralThreads / group;
  float* sums = general_smem;
  int* zero_counts = reinterpret_cast<int*>(general_smem + pairs * n_sets);
  const int lane = threadIdx.x & 31, sub = threadIdx.x & (group - 1);
  const int local = threadIdx.x / group, per_warp = 32 / group;
  const int warp_local = (threadIdx.x >> 5) * per_warp;
  const int64_t block_first = blockIdx.x * static_cast<int64_t>(pairs);
  if (block_first + warp_local >= n_pairs) return;  // uniform across the warp
  const int64_t pair = block_first + local < n_pairs ? block_first + local : n_pairs - 1;
  const int64_t row_words = static_cast<int64_t>(h) * words;
  const uint32_t* s_regs = sketches + src[pair] * row_words;
  const uint32_t* d_regs = sketches + dst[pair] * row_words;
  for (int set = 0; set < n_sets; ++set) {
    const uint32_t* a;
    const uint32_t* b = nullptr;
    if (set < h) {
      a = s_regs + set * words;
    } else if (set < 2 * h) {
      a = d_regs + (set - h) * words;
    } else {
      a = s_regs + ((set - 2 * h) / h) * words;
      b = d_regs + ((set - 2 * h) % h) * words;
    }
    float sum = 0.0f;
    int zeros = 0;
    for (int w0 = sub * 4; w0 < words; w0 += group * 4) {
      uint32_t x[4];
      load_words<4>(a + w0, x);
      if (b != nullptr) {
        uint32_t y[4];
        load_words<4>(b + w0, y);
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = __vmaxu4(x[q], y[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sum += inv_sum<true>(x[q]);
        zeros += __popc(zero_bytes(x[q]));
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
      zeros += __shfl_xor_sync(kFull, zeros, off);
    }
    if (sub == 0) {
      sums[local * n_sets + set] = sum;
      zero_counts[local * n_sets + set] = zeros;
    }
  }
  __syncwarp();
  const float fm = static_cast<float>(words * 4);
  for (int k = sub; k < n_sets; k += group) {
    sums[local * n_sets + k] =
        cardinality(sums[local * n_sets + k], zero_counts[local * n_sets + k], alpha_mm, fm);
  }
  __syncwarp();
  write_features(sums + warp_local * n_sets, h, block_first + warp_local, per_warp, n_pairs,
                 lane, out);
}

template <int H>
int launch_features(const uint32_t* sk, int words, const int32_t* src, const int32_t* dst,
                    long long n_pairs, float alpha_mm, float* out, cudaStream_t s) {
  const int wpc = words >= 8 ? 8 : 4;
  const int group = std::min(32, words / wpc);
  const long long pairs = kThreads / group;
  const unsigned blocks = static_cast<unsigned>((n_pairs + pairs - 1) / pairs);
  if (wpc == 8) {
    edge_features_kernel<H, 8><<<blocks, kThreads, 0, s>>>(sk, words, group, src, dst, n_pairs,
                                                           alpha_mm, out);
  } else {
    edge_features_kernel<H, 4><<<blocks, kThreads, 0, s>>>(sk, words, group, src, dst, n_pairs,
                                                           alpha_mm, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: [n, 2^precision] uint8, 16-byte aligned; precision >= 4.
int ebt_hll_singletons(long long n, int precision, int bits, unsigned offset,
                       void* out, void* stream) {
  if (n == 0) return 0;
  const long long threads = n * ((1LL << precision) / 16);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  singletons_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, precision, bits, offset, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// in and out: rows of m registers (m a multiple of 16) at byte strides
// in_stride and out_stride (multiples of 16), 16-byte aligned. slots: 1, or
// 2, 4 or 8 with (m / 16) * slots dividing 32. The row plan: n_chunks
// chunks (chunk_rows, chunk_starts) of `split` arcs of the rows longer
// than `split`, whose maxima go to partials ([n_chunks, m] bytes, 16-byte
// aligned); with n_chunks 0 and split 2^31 - 1, no row is long.
int ebt_hll_hop(const void* row_ptr, const void* cols, const void* in,
                long long in_stride, void* out, long long out_stride,
                long long n, int m, int slots, const void* chunk_rows,
                const void* chunk_starts, long long n_chunks, int split, void* partials,
                void* stream) {
  if (n == 0) return 0;
  const int units = m / 16;
  const int group = units * slots;
  if (slots < 1 || (slots & (slots - 1)) != 0 || (slots > 1 && 32 % group != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (n_chunks + n) * group;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* src = static_cast<const uint4*>(in);
  auto* dst = static_cast<uint4*>(out);
  const auto* cr = static_cast<const int32_t*>(chunk_rows);
  const auto* cs = static_cast<const int32_t*>(chunk_starts);
  auto* part = static_cast<uint4*>(partials);
#define EBT_HOP_LAUNCH(S)                                                                  \
  hop_kernel<S><<<blocks, kThreads, 0, st>>>(rp, c, src, in_stride / 16, dst, out_stride / 16, \
                                             n, units, cr, cs, n_chunks, split, part)
  switch (slots) {
    case 1: EBT_HOP_LAUNCH(1); break;
    case 2: EBT_HOP_LAUNCH(2); break;
    case 4: EBT_HOP_LAUNCH(4); break;
    case 8: EBT_HOP_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EBT_HOP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The second launch of a plan with n_long long rows: out[long_rows[i]] =
// the byte-wise max of in[long_rows[i]] and partials[chunk_ptr[i] ..
// chunk_ptr[i + 1]); strides and alignment as ebt_hll_hop's.
int ebt_hll_hop_merge(const void* long_rows, const void* chunk_ptr, long long n_long,
                      const void* in, long long in_stride, const void* partials, void* out,
                      long long out_stride, int m, void* stream) {
  if (n_long == 0) return 0;
  const int units = m / 16;
  const long long threads = n_long * units;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  hop_merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(long_rows), static_cast<const int32_t*>(chunk_ptr), n_long,
      static_cast<const uint4*>(in), in_stride / 16, static_cast<const uint4*>(partials),
      static_cast<uint4*>(out), out_stride / 16, units);
  return static_cast<int>(cudaGetLastError());
}

// Hop 1 (second 0) or hop 2 by the id route (second 1) of the singletons'
// sketches at precision 4-12: out rows of 2^precision registers at byte
// stride `stride` (a multiple of 16), 16-byte aligned.
int ebt_hll_ball(const void* row_ptr, const void* cols, long long n, int precision, int bits,
                 unsigned offset, int second, void* out, long long stride, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(kBallWarps) << precision;
  const unsigned blocks = static_cast<unsigned>((n + kBallWarps - 1) / kBallWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(cols);
  auto* o = static_cast<uint4*>(out);
  if (second == 0) {
    hop1_ids_kernel<<<blocks, kBallWarps * 32, smem, st>>>(rp, c, n, precision, bits, offset, o,
                                                           stride / 16);
  } else if (second == 1) {
    hop2_ids_kernel<<<blocks, kBallWarps * 32, smem, st>>>(rp, c, n, precision, bits, offset, o,
                                                           stride / 16);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// sketches: [N, h, m] uint8, m a multiple of 16, 16-byte aligned; out:
// [n_pairs, h * h + 2 h] float32. h <= 3 takes the template on h, larger
// h the general route.
int ebt_hll_edge_features(const void* sketches, int h, int m, const void* src,
                          const void* dst, long long n_pairs, float alpha_mm, void* out,
                          void* stream) {
  if (n_pairs == 0) return 0;
  const auto* sk = static_cast<const uint32_t*>(sketches);
  const auto* s_ids = static_cast<const int32_t*>(src);
  const auto* d_ids = static_cast<const int32_t*>(dst);
  auto* o = static_cast<float*>(out);
  const auto stream_ = static_cast<cudaStream_t>(stream);
  const int words = m / 4;
  if (h == 1) return launch_features<1>(sk, words, s_ids, d_ids, n_pairs, alpha_mm, o, stream_);
  if (h == 2) return launch_features<2>(sk, words, s_ids, d_ids, n_pairs, alpha_mm, o, stream_);
  if (h == 3) return launch_features<3>(sk, words, s_ids, d_ids, n_pairs, alpha_mm, o, stream_);
  const int group = std::min(32, words / 4);
  const int pairs = kGeneralThreads / group;
  const size_t smem = static_cast<size_t>(pairs) * (2 * h + h * h) * 8;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_features_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n_pairs + pairs - 1) / pairs);
  edge_features_general_kernel<<<blocks, kGeneralThreads, smem, stream_>>>(
      sk, h, words, group, s_ids, d_ids, n_pairs, alpha_mm, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
