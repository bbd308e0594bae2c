// Designs of K1's walk loop (csrc/sampling.cu) side by side, for
// walk_chain_probe.py: one thread a walker, first-order unweighted steps,
// Philox4x32-10 at counter (walker, step, 1, offset), the walks stored
// straight to device memory unless the design stages them. Each design is
// one kernel behind one C launcher taking the same arguments; `rows` is the
// design's per-node or per-arc table (see each kernel), `threads` the block.
//
// A step needs the current node's row (base, degree), a Philox draw, then
// the arc col_idx[base + off]; the next step's row waits on that arc. The
// designs differ in what sits on that chain:
//   chain     the draw after the row loads, plain loads (K1's earlier design);
//   hoisted   the next step's draw while this step's loads are in flight;
//   ldg       hoisted, loads through the read-only path (ld.global.nc);
//   row16     hoisted, base and end from one aligned 16-byte row_ptr load
//             (a second load where the pair straddles two);
//   arc16     hoisted, a 16-byte record an arc (head, head's base, head's
//             degree, 0): one dependent load a step, no row_ptr read;
//   arc8      hoisted, col_idx beside an 8-byte (head's base, degree) an arc:
//             two independent loads a step;
//   staged    hoisted, the block's walks staged in shared memory and written
//             row by row at the end.
// `persist` runs `hoisted` with row_ptr in a persisting L2 access-policy
// window on the launch's stream (set and cleared by the launcher).
//
// The fused batch's designs (arc16's walk from a Philox start, then K
// scale-free negatives of the walker, heads of uniform arcs) differ in when
// the negatives' gathers go out:
//   burst     four a step in the walk's first steps, stored a step later;
//   spread    one every (L - 1) / K steps, stored at the next;
//   after     after the walk, four gathers in flight at a time.

#include <cuda_runtime.h>

#include <cstdint>

#include "../csrc/philox.cuh"

namespace {

__device__ __forceinline__ Philox4 step_draw(uint32_t walker, uint32_t t, uint32_t offset,
                                             uint32_t k0, uint32_t k1) {
  return philox4x32_10(Philox4{walker, t, 1u, offset}, k0, k1);
}

struct Args {
  const int32_t* row_ptr;
  const int32_t* col_idx;
  const void* rows;
  const int32_t* starts;
  int32_t* walks;
  int64_t n;
  int length;
  uint32_t k0, k1, offset;
  int32_t* negs;
  int k;
  uint32_t n_nodes, n_arcs;
};

__device__ __forceinline__ uint32_t word(const Philox4& r, int q) {
  return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
}

__device__ __forceinline__ Philox4 neg_draw(uint32_t walker, int j, const Args& a) {
  return philox4x32_10(Philox4{walker, static_cast<uint32_t>(j), 2u, a.offset}, a.k0, a.k1);
}

__global__ void chain_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  int32_t cur = a.starts[b];
  int32_t* out = a.walks + b * a.length;
  out[0] = cur;
  for (int t = 1; t < a.length; ++t) {
    const int32_t base = a.row_ptr[cur];
    const uint32_t deg = static_cast<uint32_t>(a.row_ptr[cur + 1] - base);
    if (deg > 0) {
      const Philox4 r = step_draw(static_cast<uint32_t>(b), t, a.offset, a.k0, a.k1);
      cur = a.col_idx[base + bounded(r.x, deg)];
    }
    out[t] = cur;
  }
}

template <bool kLdg>
__global__ void hoisted_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  int32_t cur = a.starts[b];
  int32_t* out = a.walks + b * a.length;
  out[0] = cur;
  Philox4 r = step_draw(static_cast<uint32_t>(b), 1, a.offset, a.k0, a.k1);
  for (int t = 1; t < a.length; ++t) {
    const int32_t base = kLdg ? __ldg(a.row_ptr + cur) : a.row_ptr[cur];
    const int32_t end = kLdg ? __ldg(a.row_ptr + cur + 1) : a.row_ptr[cur + 1];
    const Philox4 now = r;
    r = step_draw(static_cast<uint32_t>(b), t + 1, a.offset, a.k0, a.k1);
    const uint32_t deg = static_cast<uint32_t>(end - base);
    if (deg > 0) {
      const int32_t* p = a.col_idx + base + bounded(now.x, deg);
      cur = kLdg ? __ldg(p) : *p;
    }
    out[t] = cur;
  }
}

__global__ void row16_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  const int4* rp4 = reinterpret_cast<const int4*>(a.row_ptr);
  int32_t cur = a.starts[b];
  int32_t* out = a.walks + b * a.length;
  out[0] = cur;
  Philox4 r = step_draw(static_cast<uint32_t>(b), 1, a.offset, a.k0, a.k1);
  for (int t = 1; t < a.length; ++t) {
    const int4 v = rp4[cur >> 2];
    const int lane = cur & 3;
    const int32_t base = lane == 0 ? v.x : lane == 1 ? v.y : lane == 2 ? v.z : v.w;
    int32_t end = lane == 0 ? v.y : lane == 1 ? v.z : v.w;
    if (lane == 3) end = a.row_ptr[cur + 1];
    const Philox4 now = r;
    r = step_draw(static_cast<uint32_t>(b), t + 1, a.offset, a.k0, a.k1);
    const uint32_t deg = static_cast<uint32_t>(end - base);
    if (deg > 0) cur = a.col_idx[base + bounded(now.x, deg)];
    out[t] = cur;
  }
}

__global__ void arc16_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  const int4* arcs = static_cast<const int4*>(a.rows);
  int32_t cur = a.starts[b];
  int32_t base = a.row_ptr[cur];
  uint32_t deg = static_cast<uint32_t>(a.row_ptr[cur + 1] - base);
  int32_t* out = a.walks + b * a.length;
  out[0] = cur;
  Philox4 r = step_draw(static_cast<uint32_t>(b), 1, a.offset, a.k0, a.k1);
  for (int t = 1; t < a.length; ++t) {
    const Philox4 now = r;
    if (deg > 0) {
      const int4 next = arcs[base + bounded(now.x, deg)];
      r = step_draw(static_cast<uint32_t>(b), t + 1, a.offset, a.k0, a.k1);
      cur = next.x;
      base = next.y;
      deg = static_cast<uint32_t>(next.z);
    }
    out[t] = cur;
  }
}

__global__ void arc8_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  const int2* heads = static_cast<const int2*>(a.rows);
  int32_t cur = a.starts[b];
  int32_t base = a.row_ptr[cur];
  uint32_t deg = static_cast<uint32_t>(a.row_ptr[cur + 1] - base);
  int32_t* out = a.walks + b * a.length;
  out[0] = cur;
  Philox4 r = step_draw(static_cast<uint32_t>(b), 1, a.offset, a.k0, a.k1);
  for (int t = 1; t < a.length; ++t) {
    const Philox4 now = r;
    if (deg > 0) {
      const int64_t arc = base + bounded(now.x, deg);
      const int32_t head = a.col_idx[arc];
      const int2 row = heads[arc];
      r = step_draw(static_cast<uint32_t>(b), t + 1, a.offset, a.k0, a.k1);
      cur = head;
      base = row.x;
      deg = static_cast<uint32_t>(row.y);
    }
    out[t] = cur;
  }
}

__global__ void staged_kernel(Args a) {
  extern __shared__ int32_t stage[];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t b = b0 + threadIdx.x;
  const int pitch = a.length | 1;
  if (b < a.n) {
    int32_t cur = a.starts[b];
    int32_t* out = stage + threadIdx.x * pitch;
    out[0] = cur;
    Philox4 r = step_draw(static_cast<uint32_t>(b), 1, a.offset, a.k0, a.k1);
    for (int t = 1; t < a.length; ++t) {
      const int32_t base = a.row_ptr[cur];
      const uint32_t deg = static_cast<uint32_t>(a.row_ptr[cur + 1] - base);
      const Philox4 now = r;
      r = step_draw(static_cast<uint32_t>(b), t + 1, a.offset, a.k0, a.k1);
      if (deg > 0) cur = a.col_idx[base + bounded(now.x, deg)];
      out[t] = cur;
    }
  }
  __syncthreads();
  const int rows = static_cast<int>(min(static_cast<int64_t>(blockDim.x), a.n - b0));
  for (int row = threadIdx.x >> 5; row < rows; row += blockDim.x >> 5) {
    for (int c = threadIdx.x & 31; c < a.length; c += 32) {
      a.walks[(b0 + row) * a.length + c] = stage[row * pitch + c];
    }
  }
}

// kMode: 0 burst, 1 spread, 2 after (see the header).
template <int kMode>
__global__ void batch_kernel(Args a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.n) return;
  const uint32_t w = static_cast<uint32_t>(b);
  const int4* arcs = static_cast<const int4*>(a.rows);
  int32_t cur = static_cast<int32_t>(bounded(
      philox4x32_10(Philox4{w, 0u, 0u, a.offset}, a.k0, a.k1).x, a.n_nodes));
  int32_t base = a.row_ptr[cur];
  uint32_t deg = static_cast<uint32_t>(a.row_ptr[cur + 1] - base);
  int32_t* out = a.walks + b * a.length;
  int32_t* neg = a.negs + b * a.k;
  out[0] = cur;
  const int slots = (a.k + 3) / 4;
  const int stride = max(1, (a.length - 1) / max(a.k, 1));
  int32_t held[4];
  Philox4 rn{0, 0, 0, 0};
  int j = 0;
  Philox4 r = step_draw(w, 1, a.offset, a.k0, a.k1);
  for (int t = 1; t < a.length; ++t) {
    const Philox4 now = r;
    if (deg > 0) {
      const int4 next = arcs[base + bounded(now.x, deg)];
      r = step_draw(w, t + 1, a.offset, a.k0, a.k1);
      cur = next.x;
      base = next.y;
      deg = static_cast<uint32_t>(next.z);
    }
    if (kMode == 0 && t - 1 < slots) {
      if (t > 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (4 * (t - 2) + q < a.k) neg[4 * (t - 2) + q] = held[q];
        }
      }
      const Philox4 d = neg_draw(w, t - 1, a);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * (t - 1) + q < a.k) held[q] = __ldg(a.col_idx + bounded(word(d, q), a.n_arcs));
      }
    }
    if (kMode == 1 && j < a.k && (t - 1) % stride == 0) {
      if (j > 0) neg[j - 1] = held[0];
      if (j % 4 == 0) rn = neg_draw(w, j / 4, a);
      held[0] = __ldg(a.col_idx + bounded(word(rn, j % 4), a.n_arcs));
      ++j;
    }
    out[t] = cur;
  }
  if (kMode == 0) {
    const int done = min(a.length - 1, slots);
    j = 4 * done;
    if (done > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * (done - 1) + q < a.k) neg[4 * (done - 1) + q] = held[q];
      }
    }
  }
  if (kMode == 1 && j > 0) neg[j - 1] = held[0];
  // The rest (all of them `after`), four gathers in flight at a time.
  for (; j < a.k; j += 4) {
    const Philox4 d = neg_draw(w, j / 4, a);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < a.k) held[q] = __ldg(a.col_idx + bounded(word(d, q), a.n_arcs));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < a.k) neg[j + q] = held[q];
    }
  }
}

}  // namespace

extern "C" {

// design: 0 chain, 1 hoisted, 2 ldg, 3 row16, 4 arc16, 5 arc8, 6 staged,
// 7 persist; the fused batch 8 burst, 9 spread, 10 after (starts unread,
// `negs` [n, k] written). Returns the cudaError_t of the launch.
int probe_walks(int design, const void* row_ptr, const void* col_idx, const void* rows,
                const void* starts, void* walks, long long n, int length, int threads,
                unsigned long long seed, unsigned int offset, long long row_ptr_bytes,
                void* negs, int k, long long n_nodes, long long n_arcs, void* stream) {
  if (n == 0) return 0;
  const Args a{static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
               rows, static_cast<const int32_t*>(starts), static_cast<int32_t*>(walks), n,
               length, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
               offset, static_cast<int32_t*>(negs), k, static_cast<uint32_t>(n_nodes),
               static_cast<uint32_t>(n_arcs)};
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  switch (design) {
    case 0: chain_kernel<<<blocks, threads, 0, s>>>(a); break;
    case 1: hoisted_kernel<false><<<blocks, threads, 0, s>>>(a); break;
    case 2: hoisted_kernel<true><<<blocks, threads, 0, s>>>(a); break;
    case 3: row16_kernel<<<blocks, threads, 0, s>>>(a); break;
    case 4: arc16_kernel<<<blocks, threads, 0, s>>>(a); break;
    case 5: arc8_kernel<<<blocks, threads, 0, s>>>(a); break;
    case 6: {
      const size_t bytes = static_cast<size_t>(threads) * (length | 1) * 4;
      cudaFuncSetAttribute(staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
      staged_kernel<<<blocks, threads, bytes, s>>>(a);
      break;
    }
    case 7: {
      cudaStreamAttrValue window = {};
      window.accessPolicyWindow.base_ptr = const_cast<void*>(row_ptr);
      window.accessPolicyWindow.num_bytes = static_cast<size_t>(row_ptr_bytes);
      window.accessPolicyWindow.hitRatio = 1.0f;
      window.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
      window.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
      cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &window);
      hoisted_kernel<false><<<blocks, threads, 0, s>>>(a);
      const int err = static_cast<int>(cudaGetLastError());
      window.accessPolicyWindow.num_bytes = 0;
      window.accessPolicyWindow.hitProp = cudaAccessPropertyNormal;
      cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &window);
      return err;
    }
    case 8: batch_kernel<0><<<blocks, threads, 0, s>>>(a); break;
    case 9: batch_kernel<1><<<blocks, threads, 0, s>>>(a); break;
    case 10: batch_kernel<2><<<blocks, threads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The persisting L2 set-aside for design 7 (0 releases it).
int probe_persisting_l2(long long bytes) {
  return static_cast<int>(cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                                             static_cast<size_t>(bytes)));
}

}  // extern "C"
