// K16a `singleton_registers` / `khop_sketches` and K16b
// `edge_sketch_features`: the HyperLogLog k-hop ball sketches behind
// HyperSketching and the GCN's lazy edge features.
//
// K16a replaces embiggen_tpu/ops/hll.py::singleton_registers (the hash of
// each node id, its register index and rho, one register set per node) and
// khop_sketches (`hops` register-wise max propagations, one segment_max
// over the arcs per hop). The singletons launch writes [N, M] uint8
// registers (M = 2^precision) with the same lowbias32 hash in uint32
// arithmetic and __clz, so the registers equal the reference's bit for
// bit. Each hop launch writes hop h of an [N, H, M] output (the port's
// layout; the reference's is [H, N, M], transposed by its caller) from hop
// h - 1 (or the singletons): out[r] = max(in[r], max over the arcs (r -> c)
// of in[c]), byte by byte. A max does not depend on its order, so the
// sketches are exact too.
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
// rows of M bytes a hop on the slice graph); the singletons are a write
// of N M bytes. K16b gathers 2 H M bytes per pair and does (2H + H^2) M
// register operations on them; at H 3 and M 256, 1.5 KB and 3,840
// operations per pair.
//
// What the designs do about it: the hops and the singletons run a thread
// per (row, 16 bytes), so the threads of a row read neighbouring 16-byte
// pieces of a gathered row and take the byte-wise max of four words with
// __vmaxu4; no atomics. K16b runs a warp per pair, its lanes over 4-byte
// words of the registers; each set's sum of 2^-r and zero count is reduced
// by shuffles, its cardinality kept in shared memory, and the lanes then
// write the pair's H^2 + 2H features. The sum of 2^-r is float32, as in the
// reference, in another order, so the features agree to float32 rounding.

#include <cuda_runtime.h>

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

__global__ void singletons_kernel(int64_t n, int precision, int bits,
                                  uint32_t offset, uint4* __restrict__ out) {
  const int chunks = (1 << precision) / 16;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t node = t / chunks;
  if (node >= n) return;
  const int chunk = static_cast<int>(t - node * chunks);
  const uint32_t h = hash32(static_cast<uint32_t>(node) + offset);
  const uint32_t idx = h & ((1u << precision) - 1u);
  const int rest = static_cast<int>(h >> precision);
  const int top = (1 << bits) - 1;
  int rho = rest == 0 ? top : __clz(rest) - precision + 1;
  rho = min(max(rho, 1), top);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (static_cast<int>(idx >> 4) == chunk) {
    const int byte = idx & 15;
    words[byte >> 2] = static_cast<uint32_t>(static_cast<uint8_t>(rho)) << (8 * (byte & 3));
  }
  out[t] = make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z),
                    __vmaxu4(a.w, b.w));
}

// in and out are [N, stride] views in units of 16 bytes; each row's
// registers are its first `chunks` units.
__global__ void hop_kernel(const int32_t* __restrict__ row_ptr,
                           const int32_t* __restrict__ cols,
                           const uint4* __restrict__ in, int64_t in_stride,
                           uint4* __restrict__ out, int64_t out_stride,
                           int64_t n, int chunks) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / chunks;
  if (row >= n) return;
  const int chunk = static_cast<int>(t - row * chunks);
  uint4 acc = __ldg(in + row * in_stride + chunk);
  const int32_t end = row_ptr[row + 1];
  for (int32_t a = row_ptr[row]; a < end; ++a) {
    const int64_t col = __ldg(cols + a);
    acc = vmax4(acc, __ldg(in + col * in_stride + chunk));
  }
  out[row * out_stride + chunk] = acc;
}

// Sum of 2^-r over the four registers of w, and their zero count.
__device__ __forceinline__ void add_word(uint32_t w, float* sum, int* zeros) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (w >> (8 * k)) & 0xFF;
    // 2^-r exactly: an exponent field for r <= 126, ldexpf below it.
    *sum += r <= 126 ? __int_as_float((127 - r) << 23) : ldexpf(1.0f, -r);
    *zeros += r == 0;
  }
}

__global__ void edge_features_kernel(
    const uint32_t* __restrict__ sketches, int h, int m,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int64_t n_pairs, float alpha_mm, float* __restrict__ out) {
  extern __shared__ float cards[];
  const int n_sets = 2 * h + h * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t pair = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (pair >= n_pairs) return;  // uniform across the warp
  float* card = cards + warp * n_sets;
  const int words = m / 4;
  const int64_t row_words = static_cast<int64_t>(h) * words;
  const uint32_t* s_regs = sketches + src[pair] * row_words;
  const uint32_t* d_regs = sketches + dst[pair] * row_words;
  const float fm = static_cast<float>(m);
  for (int set = 0; set < n_sets; ++set) {
    const uint32_t* a;
    const uint32_t* b = nullptr;
    if (set < h) {
      a = s_regs + set * words;
    } else if (set < 2 * h) {
      a = d_regs + (set - h) * words;
    } else {
      const int u = set - 2 * h;
      a = s_regs + (u / h) * words;
      b = d_regs + (u % h) * words;
    }
    float sum = 0.0f;
    int zeros = 0;
    for (int w = lane; w < words; w += 32) {
      uint32_t x = __ldg(a + w);
      if (b != nullptr) x = __vmaxu4(x, __ldg(b + w));
      add_word(x, &sum, &zeros);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
      zeros += __shfl_xor_sync(kFull, zeros, off);
    }
    if (lane == 0) {
      const float raw = alpha_mm / sum;
      const float linear = fm * logf(fm / fmaxf(static_cast<float>(zeros), 1e-9f));
      card[set] = (raw <= 2.5f * fm && zeros > 0) ? linear : raw;
    }
  }
  __syncwarp();
  const int n_feats = h * h + 2 * h;
  float* o = out + pair * n_feats;
  for (int k = lane; k < n_feats; k += 32) {
    float v;
    if (k < h * h) {
      v = fmaxf(card[k / h] + card[h + k % h] - card[2 * h + k], 0.0f);
    } else if (k < h * h + h) {
      const int i = k - h * h;  // left_i, against overlap(i, H - 1)
      const float ov = fmaxf(card[i] + card[2 * h - 1] - card[2 * h + i * h + h - 1], 0.0f);
      v = fmaxf(card[i] - ov, 0.0f);
    } else {
      const int j = k - h * h - h;  // right_j, against overlap(H - 1, j)
      const float ov =
          fmaxf(card[h - 1] + card[h + j] - card[2 * h + (h - 1) * h + j], 0.0f);
      v = fmaxf(card[h + j] - ov, 0.0f);
    }
    o[k] = v;
  }
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
// in_stride and out_stride (multiples of 16), 16-byte aligned.
int ebt_hll_hop(const void* row_ptr, const void* cols, const void* in,
                long long in_stride, void* out, long long out_stride,
                long long n, int m, void* stream) {
  if (n == 0) return 0;
  const int chunks = m / 16;
  const long long threads = n * chunks;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  hop_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(cols),
      static_cast<const uint4*>(in), in_stride / 16, static_cast<uint4*>(out),
      out_stride / 16, n, chunks);
  return static_cast<int>(cudaGetLastError());
}

// sketches: [N, h, m] uint8 (m a multiple of 4, 4-byte aligned); out:
// [n_pairs, h * h + 2 h] float32.
int ebt_hll_edge_features(const void* sketches, int h, int m, const void* src,
                          const void* dst, long long n_pairs, float alpha_mm,
                          void* out, void* stream) {
  if (n_pairs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_pairs * 32 + kThreads - 1) / kThreads);
  const size_t smem = (kThreads / 32) * (2 * h + h * h) * sizeof(float);
  edge_features_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sketches), h, m, static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), n_pairs, alpha_mm, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
