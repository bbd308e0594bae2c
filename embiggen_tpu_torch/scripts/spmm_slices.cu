// The feature-sliced SpMM measured against K7 (csrc/spmm.cu, included as it
// is) by spmm_slices.py: a pack of x [n, d] into contiguous [P, n, s] slices
// and passes that gather from one slice at a time, each over all rows or
// over the arcs of one block of columns, with three pass kernels; and the
// L2 persisting-window controls. Built into a library of its own, never
// into the port's kernels.

#include "../csrc/spmm.cu"

namespace {

constexpr int kGroup = 8;       // lanes per output row in sliced_pass_kernel
constexpr int kChunks = 4;      // chunks of kGroup arcs a group reads at once
constexpr int kArcs = 8;        // arcs a lane reads at once in sliced_rows_kernel
constexpr int kTileChunks = 2;  // chunks per row a group reads at once in sliced_tile_kernel

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <bool kStream, typename T>
__device__ __forceinline__ T load_csr(const T* p) {
  if (kStream) return __ldcs(p);
  return __ldg(p);
}

// x [n, d] -> packed [P, n, s], slice p holding columns p s .. p s + s - 1
// (zeros past d). A thread per float4 of a padded row of x, in x's order, so
// the reads are coalesced and each write is a whole 16 bytes.
__global__ void pack_slices_kernel(const float* __restrict__ x, float* __restrict__ packed,
                                   int64_t n, int d, int s, int passes) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int per_row = passes * s / 4;
  if (q >= n * per_row) return;
  const int64_t row = q / per_row;
  const int c = 4 * static_cast<int>(q - row * per_row);
  const float* src = x + row * d + c;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d % 4 == 0) {
    if (c < d) v = __ldcs(reinterpret_cast<const float4*>(src));
  } else {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < 4 && c + i < d; ++i) a[i] = __ldcs(src + i);
    v = make_float4(a[0], a[1], a[2], a[3]);
  }
  const int p = c / s;
  *reinterpret_cast<float4*>(packed + (p * n + row) * s + c - p * s) = v;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// One pass of a sliced product: out[:, c0 : c0 + S] (clipped at d) from the
// slice xs [n_in, S], over the arcs starts[r] .. ends[r] - 1 of each row r
// (added to out when accumulate != 0). A group of kGroup lanes per output
// row; lane g of a group holds float4 v = g % V of the slice for the arcs
// a = g / V, a + A, ... of each chunk of kGroup arcs. The group reads
// kChunks chunks of the row's columns and weights at once and then issues
// all their gathers, so that one row keeps up to kChunks * kGroup / A loads
// in flight per lane. With vals == nullptr every weight is 1. kStream reads
// the CSR with evict-first loads (__ldcs), so that it does not evict the
// slice.
template <int S, bool kStream>
__global__ void sliced_pass_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ xs, const float* __restrict__ row_scale,
    const float* __restrict__ col_scale, float* __restrict__ out, int64_t n_out, int d,
    int c0, int accumulate) {
  constexpr int V = S / 4;       // float4 per slice row
  constexpr int A = kGroup / V;  // arcs of a chunk taken at once
  const int64_t row =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / kGroup;
  const int lane = threadIdx.x & 31, g = lane % kGroup, v = g % V, a = g / V;
  const unsigned mask = 0xFFu << (lane & ~(kGroup - 1));
  if (row >= n_out) return;  // uniform across the group
  const int32_t start = load_csr<kStream>(starts + row), end = load_csr<kStream>(ends + row);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int32_t base = start; base < end; base += kChunks * kGroup) {
    int32_t col[kChunks];
    float w[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int32_t i = base + c * kGroup + g;
      col[c] = 0;
      w[c] = 0.0f;
      if (i < end) {
        col[c] = load_csr<kStream>(cols + i);
        w[c] = vals != nullptr ? load_csr<kStream>(vals + i) : 1.0f;
      }
    }
    if (col_scale != nullptr) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (base + c * kGroup + g < end) w[c] *= __ldg(col_scale + col[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int j = 0; j < kGroup / A; ++j) {
        const int src = j * A + a;
        const int32_t cj = __shfl_sync(mask, col[c], src, kGroup);
        const float wj = __shfl_sync(mask, w[c], src, kGroup);
        if (base + c * kGroup + src < end) {
          fma4(acc, wj, __ldg(reinterpret_cast<const float4*>(
                            xs + static_cast<int64_t>(cj) * S + 4 * v)));
        }
      }
    }
  }
#pragma unroll
  for (int o = V; o < kGroup; o <<= 1) {
    acc.x += __shfl_xor_sync(mask, acc.x, o, kGroup);
    acc.y += __shfl_xor_sync(mask, acc.y, o, kGroup);
    acc.z += __shfl_xor_sync(mask, acc.z, o, kGroup);
    acc.w += __shfl_xor_sync(mask, acc.w, o, kGroup);
  }
  const int c = c0 + 4 * v;
  if (a != 0 || c >= d) return;
  const float rs = row_scale != nullptr ? row_scale[row] : 1.0f;
  float r[4] = {acc.x * rs, acc.y * rs, acc.z * rs, acc.w * rs};
  float* dst = out + row * d + c;
  if (d % 4 == 0) {
    auto* dst4 = reinterpret_cast<float4*>(dst);
    if (accumulate) {
      const float4 old = *dst4;
      r[0] += old.x;
      r[1] += old.y;
      r[2] += old.z;
      r[3] += old.w;
    }
    *dst4 = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    for (int i = 0; i < 4 && c + i < d; ++i) dst[i] = accumulate ? dst[i] + r[i] : r[i];
  }
}

// The same pass with kGroup lanes for R consecutive rows at once: the
// group reads the R rows' arc ranges, then kTileChunks chunks of kGroup
// arcs of every row, then issues all their gathers, so that R rows' chains
// of loads overlap.
template <int S, int R>
__global__ void sliced_tile_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ xs, const float* __restrict__ row_scale,
    const float* __restrict__ col_scale, float* __restrict__ out, int64_t n_out, int d,
    int c0, int accumulate) {
  constexpr int V = S / 4;
  constexpr int A = kGroup / V;
  constexpr int C = kTileChunks;
  const int64_t row0 =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / kGroup * R;
  const int lane = threadIdx.x & 31, g = lane % kGroup, v = g % V, a = g / V;
  const unsigned mask = 0xFFu << (lane & ~(kGroup - 1));
  if (row0 >= n_out) return;  // uniform across the group
  int32_t my_start = 0, my_end = 0;
  if (g < R && row0 + g < n_out) {
    my_start = starts[row0 + g];
    my_end = ends[row0 + g];
  }
  int32_t st[R], en[R];
  int32_t longest = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    st[i] = __shfl_sync(mask, my_start, i, kGroup);
    en[i] = __shfl_sync(mask, my_end, i, kGroup);
    longest = max(longest, en[i] - st[i]);
  }
  float4 acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int32_t off = 0; off < longest; off += C * kGroup) {
    int32_t col[R][C];
    float w[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int32_t k = st[i] + off + c * kGroup + g;
        col[i][c] = 0;
        w[i][c] = 0.0f;
        if (k < en[i]) {
          col[i][c] = __ldg(cols + k);
          w[i][c] = vals != nullptr ? __ldg(vals + k) : 1.0f;
        }
      }
    }
    if (col_scale != nullptr) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (st[i] + off + c * kGroup + g < en[i]) w[i][c] *= __ldg(col_scale + col[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < kGroup / A; ++j) {
          const int src = j * A + a;
          const int32_t cj = __shfl_sync(mask, col[i][c], src, kGroup);
          const float wj = __shfl_sync(mask, w[i][c], src, kGroup);
          if (st[i] + off + c * kGroup + src < en[i]) {
            fma4(acc[i], wj, __ldg(reinterpret_cast<const float4*>(
                                 xs + static_cast<int64_t>(cj) * S + 4 * v)));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int o = V; o < kGroup; o <<= 1) {
      acc[i].x += __shfl_xor_sync(mask, acc[i].x, o, kGroup);
      acc[i].y += __shfl_xor_sync(mask, acc[i].y, o, kGroup);
      acc[i].z += __shfl_xor_sync(mask, acc[i].z, o, kGroup);
      acc[i].w += __shfl_xor_sync(mask, acc[i].w, o, kGroup);
    }
  }
  const int c = c0 + 4 * v;
  if (a != 0 || c >= d) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = row0 + i;
    if (row >= n_out) break;
    const float rs = row_scale != nullptr ? row_scale[row] : 1.0f;
    float r[4] = {acc[i].x * rs, acc[i].y * rs, acc[i].z * rs, acc[i].w * rs};
    float* dst = out + row * d + c;
    if (d % 4 == 0) {
      auto* dst4 = reinterpret_cast<float4*>(dst);
      if (accumulate) {
        const float4 old = *dst4;
        r[0] += old.x;
        r[1] += old.y;
        r[2] += old.z;
        r[3] += old.w;
      }
      *dst4 = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      for (int q = 0; q < 4 && c + q < d; ++q) dst[q] = accumulate ? dst[q] + r[q] : r[q];
    }
  }
}

// The same pass with V = S / 4 lanes per output row, lane v holding float4
// v of the slice for every arc of the row: no shuffles, 32 / V rows per
// warp. Each lane reads kArcs columns and weights of its row at once and
// then issues their kArcs gathers.
template <int S>
__global__ void sliced_rows_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ xs, const float* __restrict__ row_scale,
    const float* __restrict__ col_scale, float* __restrict__ out, int64_t n_out, int d,
    int c0, int accumulate) {
  constexpr int V = S / 4;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / V;
  const int v = static_cast<int>(t % V);
  if (row >= n_out) return;
  const int32_t start = starts[row], end = ends[row];
  const float* xv = xs + 4 * v;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int32_t base = start; base < end; base += kArcs) {
    int32_t col[kArcs];
    float w[kArcs];
#pragma unroll
    for (int i = 0; i < kArcs; ++i) {
      col[i] = 0;
      w[i] = 0.0f;
      if (base + i < end) {
        col[i] = __ldg(cols + base + i);
        w[i] = vals != nullptr ? __ldg(vals + base + i) : 1.0f;
      }
    }
    if (col_scale != nullptr) {
#pragma unroll
      for (int i = 0; i < kArcs; ++i) {
        if (base + i < end) w[i] *= __ldg(col_scale + col[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kArcs; ++i) {
      if (base + i < end) {
        fma4(acc, w[i], __ldg(reinterpret_cast<const float4*>(
                            xv + static_cast<int64_t>(col[i]) * S)));
      }
    }
  }
  const int c = c0 + 4 * v;
  if (c >= d) return;
  const float rs = row_scale != nullptr ? row_scale[row] : 1.0f;
  float r[4] = {acc.x * rs, acc.y * rs, acc.z * rs, acc.w * rs};
  float* dst = out + row * d + c;
  if (d % 4 == 0) {
    auto* dst4 = reinterpret_cast<float4*>(dst);
    if (accumulate) {
      const float4 old = *dst4;
      r[0] += old.x;
      r[1] += old.y;
      r[2] += old.z;
      r[3] += old.w;
    }
    *dst4 = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    for (int i = 0; i < 4 && c + i < d; ++i) dst[i] = accumulate ? dst[i] + r[i] : r[i];
  }
}

// x [n, d] -> packed [P, n, s] in packed's order: a thread per float4 of
// the output, so the writes are coalesced and a warp reads 32 / (s / 4)
// row pieces of s floats.
__global__ void pack_out_order_kernel(const float* __restrict__ x, float* __restrict__ packed,
                                      int64_t n, int d, int s, int passes) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int v4 = s / 4;
  if (q >= passes * n * v4) return;
  const int64_t p = q / (n * v4);
  const int64_t rem = q - p * n * v4;
  const int64_t row = rem / v4;
  const int c = static_cast<int>(p * s + 4 * (rem - row * v4));
  const float* src = x + row * d + c;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d % 4 == 0) {
    if (c < d) v = __ldcs(reinterpret_cast<const float4*>(src));
  } else {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < 4 && c + i < d; ++i) a[i] = __ldcs(src + i);
    v = make_float4(a[0], a[1], a[2], a[3]);
  }
  reinterpret_cast<float4*>(packed)[q] = v;
}

template <int S, bool kStream>
void launch_pass(const int32_t* starts, const int32_t* ends, const int32_t* ci,
                 const float* v, const float* xs, const float* rsc, const float* csc, float* o,
                 long long n_out, int d, int c0, int accumulate, cudaStream_t stream) {
  sliced_pass_kernel<S, kStream><<<blocks_for(n_out * kGroup), kThreads, 0, stream>>>(
      starts, ends, ci, v, xs, rsc, csc, o, n_out, d, c0, accumulate);
}

}  // namespace

extern "C" {

// x [n_in, d] -> packed [passes, n_in, s]; s a multiple of 4, 16-byte
// aligned packed (and x when d % 4 == 0).
int ebt_pack_slices(const void* x, void* packed, long long n_in, int d, int s, int passes,
                    void* stream) {
  if (n_in == 0 || d == 0) return 0;
  pack_slices_kernel<<<blocks_for(n_in * passes * s / 4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(packed), n_in, d, s, passes);
  return static_cast<int>(cudaGetLastError());
}

// One sliced pass over xs [n_in, s] into out[:, c0 : c0 + s] over the arcs
// starts[r] .. ends[r] - 1 of each row; s in 4, 8, 16, 32; stream_csr != 0
// reads the CSR with evict-first loads.
int ebt_dev_sliced_pass(const void* starts, const void* ends, const void* cols,
                        const void* vals, const void* xs, const void* row_scale,
                        const void* col_scale, void* out, long long n_out, int d, int c0,
                        int s, int accumulate, int stream_csr, void* stream) {
  const auto* b = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* x = static_cast<const float*>(xs);
  const auto* rsc = static_cast<const float*>(row_scale);
  const auto* csc = static_cast<const float*>(col_scale);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
#define EBT_PASS(S)                                                                  \
  if (s == S) {                                                                      \
    if (stream_csr) {                                                                \
      launch_pass<S, true>(b, e, ci, v, x, rsc, csc, o, n_out, d, c0, accumulate, st);  \
    } else {                                                                         \
      launch_pass<S, false>(b, e, ci, v, x, rsc, csc, o, n_out, d, c0, accumulate, st); \
    }                                                                                \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  EBT_PASS(4)
  EBT_PASS(8)
  EBT_PASS(16)
  EBT_PASS(32)
#undef EBT_PASS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with V = s / 4 lanes per row (sliced_rows_kernel).
int ebt_dev_sliced_rows(const void* starts, const void* ends, const void* cols,
                        const void* vals, const void* xs, const void* row_scale,
                        const void* col_scale, void* out, long long n_out, int d, int c0,
                        int s, int accumulate, void* stream) {
  const auto* b = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* x = static_cast<const float*>(xs);
  const auto* rsc = static_cast<const float*>(row_scale);
  const auto* csc = static_cast<const float*>(col_scale);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
#define EBT_ROWS(S)                                                                  \
  if (s == S) {                                                                      \
    sliced_rows_kernel<S><<<blocks_for(n_out * (S / 4)), kThreads, 0, st>>>(         \
        b, e, ci, v, x, rsc, csc, o, n_out, d, c0, accumulate);                      \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  EBT_ROWS(8)
  EBT_ROWS(16)
  EBT_ROWS(32)
#undef EBT_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with R = rows rows per group (sliced_tile_kernel), rows in 2, 4.
int ebt_dev_sliced_tile(const void* starts, const void* ends, const void* cols,
                        const void* vals, const void* xs, const void* row_scale,
                        const void* col_scale, void* out, long long n_out, int d, int c0,
                        int s, int accumulate, int rows, void* stream) {
  const auto* b = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* x = static_cast<const float*>(xs);
  const auto* rsc = static_cast<const float*>(row_scale);
  const auto* csc = static_cast<const float*>(col_scale);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
#define EBT_TILE(S, R)                                                               \
  if (s == S && rows == R) {                                                         \
    sliced_tile_kernel<S, R><<<blocks_for((n_out + R - 1) / R * kGroup), kThreads, 0, \
                               st>>>(b, e, ci, v, x, rsc, csc, o, n_out, d, c0,      \
                                     accumulate);                                    \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  EBT_TILE(8, 2)
  EBT_TILE(8, 4)
  EBT_TILE(16, 2)
  EBT_TILE(16, 4)
  EBT_TILE(32, 2)
  EBT_TILE(32, 4)
#undef EBT_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The pack in the output's order (pack_out_order_kernel).
int ebt_dev_pack_out_order(const void* x, void* packed, long long n, int d, int s, int passes,
                           void* stream) {
  pack_out_order_kernel<<<blocks_for(passes * n * (s / 4)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(packed), n, d, s, passes);
  return static_cast<int>(cudaGetLastError());
}

// Set aside `bytes` of L2 for persisting lines, with no window marking
// any: what a set-aside left in place costs other accesses.
int ebt_dev_set_aside(long long bytes) {
  return static_cast<int>(
      cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, static_cast<size_t>(bytes)));
}

// info[0..3]: L2 bytes, most persisting L2 bytes, largest access-policy
// window, SMs.
int ebt_dev_l2_info(int* info) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const cudaDeviceAttr attrs[4] = {cudaDevAttrL2CacheSize, cudaDevAttrMaxPersistingL2CacheSize,
                                   cudaDevAttrMaxAccessPolicyWindowSize,
                                   cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = cudaDeviceGetAttribute(info + i, attrs[i], device);
  }
  return static_cast<int>(err);
}

// With bytes > 0: set aside `limit` bytes of L2 for persisting lines (when
// that changed) and mark [base, base + bytes) persisting on `stream` (hit
// ratio limit / bytes where the window is larger). With bytes == 0: clear
// the window, release the persisting lines and give the set-aside back.
int ebt_dev_persist(void* base, long long bytes, long long limit, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaStreamAttrValue attr = {};
  cudaError_t err = cudaSuccess;
  static long long set_aside = 0;
  if (bytes > 0) {
    if (limit != set_aside) {
      err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, static_cast<size_t>(limit));
      set_aside = limit;
    }
    attr.accessPolicyWindow.base_ptr = base;
    attr.accessPolicyWindow.num_bytes = static_cast<size_t>(bytes);
    attr.accessPolicyWindow.hitRatio =
        bytes > limit ? static_cast<float>(limit) / static_cast<float>(bytes) : 1.0f;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  } else {
    attr.accessPolicyWindow.num_bytes = 0;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyNormal;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyNormal;
  }
  if (err == cudaSuccess) {
    err = cudaStreamSetAttribute(st, cudaStreamAttributeAccessPolicyWindow, &attr);
  }
  if (err == cudaSuccess && bytes == 0) {
    err = cudaCtxResetPersistingL2Cache();
    if (err == cudaSuccess) err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
    set_aside = 0;
  }
  return static_cast<int>(err);
}

}  // extern "C"
