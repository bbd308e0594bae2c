// K13: GloVe's co-occurrence build (K13a) and its weighted-least-squares
// step (K13b).
//
// K13a `cooc_insert` + `cooc_compact` replace
// embiggen_tpu/models/embedders/glove.py::GloVe._cooccurrences (the window
// pairs, their host radix sort and reduceat) and the per-power count of
// WalkletsGloVe._fit_transform (walklets.py:381-394). For every walk, every
// stride d given (GloVe: 1..w at weight 1/d; Walklets GloVe: one stride at
// weight 1) and every position t < L - d, the pair of nodes (a, b) =
// (walk[t], walk[t + d]) adds its weight to the symmetric keys a N + b and
// b N + a; the result is each distinct key with its summed weight, the
// diagonal (a == b) dropped. Both keys of a pair always take the same
// weight, so the build inserts the one unordered key min N + max and the
// compaction writes both orientations of each. The wrapper sorts the
// compacted keys (the reference sorts on the host, outside any device
// program).
//
// K13b `glove_step` replaces GloVe._batch_updates (glove.py:207-228; its
// loss is embiggen_tpu/ops/losses.py::glove_loss) and the same step of
// WalkletsGloVe: for each drawn entry e (ids[r]) it gathers (i, j, f, log x)
// and the rows w_i, c_j, b_i, b_j, and writes pred = w_i . c_j + b_i + b_j,
// g = 2 f (pred - log x) / B, the gradient rows g c_j and g w_i, the bias
// gradient g (both biases take it), i and j, and the entry's loss
// f (pred - log x)^2. The tables are not touched: the caller scatter-adds
// the rows after the step, so every gradient is taken before any table
// changes.
//
// What bounds them on the H100:
//   - K13a: the insertions, random 16-byte slots of a table of at least
//     twice as many slots as unordered keys (at the bench's 1M walks of 16,
//     w 2: 29M keys into 2^26 slots, 1.07 GB), each an atomicCAS on the key
//     and a float64 atomicAdd on the sum, then one pass over the slots;
//     its byte bound is the walks read and the entries written.
//   - K13b: the gathered rows, 2 D floats an entry read and 2 D written
//     (B 65536, D 128: 134 MB), and the entry gathers before them.
//
// What the design does about it:
//   - K13a hashes each key (the splitmix64 finaliser) into an open-addressing
//     table with linear probing; a slot's key goes from empty to its key
//     once, so a key read without a lock is either empty (then the CAS
//     decides) or final. A thread a (walk, position, stride), consecutive
//     threads on consecutive positions of one walk, so the walk reads are
//     coalesced. Each block counts the slots it claimed and adds its count
//     once; a probe sequence that finds no slot (which a table at most half
//     full cannot give) raises a flag the wrapper reads. The compaction
//     takes a thread a slot and one atomic a block for its output offset.
//     Float64 atomics add in no fixed order, so a sum may differ from the
//     reference's by a rounding of float64, under float32's after the cast.
//   - K13b takes a warp an entry: lanes over D, float4 loads when D % 4 == 0
//     and the rows are 16-byte aligned, the dot product by shuffles, then the
//     two gradient rows written from the rows just read (L1 hits).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

// Block-wide sum of `v` (each thread's 0 or 1), into thread 0's return.
__device__ __forceinline__ unsigned block_count(unsigned v, unsigned* red) {
  const unsigned warp = __popc(__ballot_sync(0xffffffffu, v != 0));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = warp;
  __syncthreads();
  unsigned total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads) cooc_insert_kernel(
    const int32_t* __restrict__ walks, long long n_walks, int L, long long n_nodes,
    const int32_t* __restrict__ strides, const double* __restrict__ weights, int n_strides,
    unsigned long long* __restrict__ keys, double* __restrict__ sums,
    unsigned long long mask, unsigned long long* __restrict__ counters) {
  __shared__ unsigned red[kThreads / 32];
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long per_stride = n_walks * L;
  unsigned claimed = 0;
  if (i < per_stride * n_strides) {
    const int j = static_cast<int>(i / per_stride);
    const long long r = i - j * per_stride;
    const long long w = r / L;
    const int t = static_cast<int>(r - w * L);
    const int d = strides[j];
    if (t + d < L) {
      const long long a = walks[w * L + t], b = walks[w * L + t + d];
      if (a != b) {
        const unsigned long long key =
            static_cast<unsigned long long>(a < b ? a * n_nodes + b : b * n_nodes + a);
        const double v = weights[j];
        unsigned long long h = mix(key) & mask;
        bool done = false;
        for (unsigned long long probe = 0; probe <= mask; ++probe) {
          unsigned long long cur = __ldcg(keys + h);
          if (cur == kEmpty) {
            cur = atomicCAS(keys + h, kEmpty, key);
            if (cur == kEmpty) {
              claimed = 1;
              cur = key;
            }
          }
          if (cur == key) {
            atomicAdd(sums + h, v);
            done = true;
            break;
          }
          h = (h + 1) & mask;
        }
        if (!done) atomicOr(counters + 1, 1ull);
      }
    }
  }
  const unsigned total = block_count(claimed, red);
  if (threadIdx.x == 0 && total) atomicAdd(counters, static_cast<unsigned long long>(total));
}

// Both orientations of every occupied slot's key, with its sum, into
// out_keys / out_sums at 2 (block offset + rank in the block).
__global__ void __launch_bounds__(kThreads) cooc_compact_kernel(
    const unsigned long long* __restrict__ keys, const double* __restrict__ sums,
    long long cap, long long n_nodes, long long* __restrict__ out_keys,
    double* __restrict__ out_sums, unsigned long long* __restrict__ cursor) {
  __shared__ unsigned warp_base[kThreads / 32];
  __shared__ unsigned long long block_base;
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const unsigned long long key = i < cap ? keys[i] : kEmpty;
  const bool live = key != kEmpty;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const unsigned c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total ? atomicAdd(cursor, static_cast<unsigned long long>(total)) : 0;
  }
  __syncthreads();
  if (!live) return;
  const unsigned long long pos =
      block_base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
  const long long lo = static_cast<long long>(key / n_nodes);
  const long long hi = static_cast<long long>(key - lo * n_nodes);
  const double s = sums[i];
  out_keys[2 * pos] = lo * n_nodes + hi;
  out_keys[2 * pos + 1] = hi * n_nodes + lo;
  out_sums[2 * pos] = s;
  out_sums[2 * pos + 1] = s;
}

__global__ void __launch_bounds__(kThreads) glove_step_kernel(
    const int32_t* __restrict__ ci, const int32_t* __restrict__ cj,
    const float* __restrict__ f_x, const float* __restrict__ log_x,
    const int32_t* __restrict__ ids, const float* __restrict__ node_emb,
    const float* __restrict__ ctx_emb, const float* __restrict__ center_bias,
    const float* __restrict__ ctx_bias, int32_t* __restrict__ out_i,
    int32_t* __restrict__ out_j, float* __restrict__ gw, float* __restrict__ gc,
    float* __restrict__ g, float* __restrict__ loss, long long B, int D, float inv_b,
    bool vec) {
  const long long r = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= B) return;
  const long long e = ids[r];
  const long long i = ci[e], j = cj[e];
  const float* w = node_emb + i * D;
  const float* c = ctx_emb + j * D;
  float dot = 0.f;
  if (vec) {
    for (int q = lane; q < D / 4; q += 32) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(w) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(c) + q);
      dot = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, dot))));
    }
  } else {
    for (int q = lane; q < D; q += 32) dot = fmaf(__ldg(w + q), __ldg(c + q), dot);
  }
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  const float fx = f_x[e];
  const float diff = dot + center_bias[i] + ctx_bias[j] - log_x[e];
  const float gr = 2.f * fx * diff * inv_b;
  if (lane == 0) {
    out_i[r] = static_cast<int32_t>(i);
    out_j[r] = static_cast<int32_t>(j);
    g[r] = gr;
    loss[r] = fx * diff * diff;
  }
  float* ow = gw + r * D;
  float* oc = gc + r * D;
  if (vec) {
    for (int q = lane; q < D / 4; q += 32) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(w) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(c) + q);
      reinterpret_cast<float4*>(ow)[q] = make_float4(gr * b.x, gr * b.y, gr * b.z, gr * b.w);
      reinterpret_cast<float4*>(oc)[q] = make_float4(gr * a.x, gr * a.y, gr * a.z, gr * a.w);
    }
  } else {
    for (int q = lane; q < D; q += 32) {
      ow[q] = gr * __ldg(c + q);
      oc[q] = gr * __ldg(w + q);
    }
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Insert every (walk, position, stride) pair's unordered key into the table
// keys / sums of mask + 1 slots (a power of two; keys all-ones, sums zero);
// counters[0] gains the slots claimed, counters[1] is set if a key found no
// slot.
int ebt_cooc_insert(const void* walks, long long n_walks, int L, long long n_nodes,
                    const void* strides, const void* weights, int n_strides, void* keys,
                    void* sums, unsigned long long mask, void* counters, void* stream) {
  const long long threads = n_walks * L * n_strides;
  if (threads == 0) return 0;
  cooc_insert_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(walks), n_walks, L, n_nodes,
      static_cast<const int32_t*>(strides), static_cast<const double*>(weights), n_strides,
      static_cast<unsigned long long*>(keys), static_cast<double*>(sums), mask,
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// Write the occupied slots of the table (cap slots) as key pairs and sums;
// out_keys / out_sums hold twice the claimed slots, cursor starts at 0.
int ebt_cooc_compact(const void* keys, const void* sums, long long cap, long long n_nodes,
                     void* out_keys, void* out_sums, void* cursor, void* stream) {
  if (cap == 0) return 0;
  cooc_compact_kernel<<<blocks_for(cap), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys), static_cast<const double*>(sums), cap,
      n_nodes, static_cast<long long*>(out_keys), static_cast<double*>(out_sums),
      static_cast<unsigned long long*>(cursor));
  return static_cast<int>(cudaGetLastError());
}

// One GloVe step's gradients for B drawn entries; see glove_step_kernel.
int ebt_glove_step(const void* ci, const void* cj, const void* f_x, const void* log_x,
                   const void* ids, const void* node_emb, const void* ctx_emb,
                   const void* center_bias, const void* ctx_bias, void* out_i, void* out_j,
                   void* gw, void* gc, void* g, void* loss, long long B, int D, float inv_b,
                   void* stream) {
  if (B == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(node_emb) |
                          reinterpret_cast<uintptr_t>(ctx_emb) |
                          reinterpret_cast<uintptr_t>(gw) | reinterpret_cast<uintptr_t>(gc);
  const bool vec = D % 4 == 0 && align % 16 == 0;
  glove_step_kernel<<<blocks_for(B * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ci), static_cast<const int32_t*>(cj),
      static_cast<const float*>(f_x), static_cast<const float*>(log_x),
      static_cast<const int32_t*>(ids), static_cast<const float*>(node_emb),
      static_cast<const float*>(ctx_emb), static_cast<const float*>(center_bias),
      static_cast<const float*>(ctx_bias), static_cast<int32_t*>(out_i),
      static_cast<int32_t*>(out_j), static_cast<float*>(gw), static_cast<float*>(gc),
      static_cast<float*>(g), static_cast<float*>(loss), B, D, inv_b, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
