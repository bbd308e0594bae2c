// P1 `tile_gather_sums` and P2 `table_gather_sums`: the gather-rate probes
// that bound K7. Each block sums one tile of gathered rows:
// out[t] = sum over i in [t * tile, (t + 1) * tile) of x[idx[i]]; only
// whole tiles are used, as in the Pallas kernels.
//
// P1 replaces scripts/spmm_probe.py::dma_kernel (pallas_gather): tiles of
// 256 rows gathered from a [1M, 128] f32 table in device memory. The
// Pallas kernel double-buffers each tile in VMEM ([2, 256, 128] f32,
// 256 KB), which does not fit the 227 KB of shared memory a Hopper block
// may have; here no row is staged at all: each warp keeps its share of the
// tile's sum in registers, and only the per-warp partial sums (4 KB) meet
// in shared memory.
//
// P2 replaces scripts/spmm_probe.py::vmem_kernel (vmem_gather): blocks of
// 8192 rows gathered from a resident [8192, 128] f32 table. Its 4 MB
// "resident" table cannot live in shared memory on Hopper; it lives in the
// 50 MB L2 cache instead, which the first blocks' reads fill, so the probe
// measures the L2 gather rate. It runs the same code with 32 warps per
// block.
//
// What bounds them on the H100: gathered bytes, from device memory (P1)
// or L2 (P2); one add per gathered float. What the design does about it:
// a warp reads one 512-byte row per load instruction (a float4 per lane),
// the indices 32 at a time broadcast by shuffles, with several rows in
// flight per warp (unrolled).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// d % 4 == 0. Dynamic shared memory: (blockDim.x / 32) * 128 floats.
__global__ void tile_gather_sums_kernel(const float* __restrict__ x,
                                        const int32_t* __restrict__ idx,
                                        int64_t tile, int d,
                                        float* __restrict__ out) {
  extern __shared__ float partial[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int64_t per_warp = (tile + n_warps - 1) / n_warps;
  const int64_t first = blockIdx.x * tile + warp * per_warp;
  const int64_t tile_end = (blockIdx.x + 1) * tile;
  const int64_t stop = first + per_warp < tile_end ? first + per_warp : tile_end;
  for (int c0 = 0; c0 < d; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool active = c < d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t base = first; base < stop; base += 32) {
      const int32_t mine = base + lane < stop ? idx[base + lane] : 0;
      const int count = static_cast<int>(stop - base < 32 ? stop - base : 32);
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const int32_t r = __shfl_sync(kFull, mine, j);
        if (active) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              x + static_cast<int64_t>(r) * d + c));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
    }
    reinterpret_cast<float4*>(partial)[warp * 32 + lane] = acc;
    __syncthreads();
    for (int t = threadIdx.x; t < 128 && c0 + t < d; t += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += partial[w * 128 + t];
      out[blockIdx.x * static_cast<int64_t>(d) + c0 + t] = s;
    }
    __syncthreads();
  }
}

int launch(const void* x, const void* idx, long long n_tiles, long long tile,
           int d, void* out, int threads, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(threads / 32) * 128 * sizeof(float);
  tile_gather_sums_kernel<<<static_cast<unsigned>(n_tiles), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx), tile, d,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1: 8 warps per block, tile rows from a table in device memory.
int ebt_tile_gather_sums(const void* x, const void* idx, long long n_tiles,
                         long long tile, int d, void* out, void* stream) {
  return launch(x, idx, n_tiles, tile, d, out, 256, stream);
}

// P2: 32 warps per block, block rows from an L2-resident table.
int ebt_table_gather_sums(const void* tbl, const void* idx, long long n_blocks,
                          long long block, int d, void* out, void* stream) {
  return launch(tbl, idx, n_blocks, block, d, out, 1024, stream);
}

}  // extern "C"
