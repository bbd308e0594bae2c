// What K13a's scatter (csrc/glove.cu, cooc_scatter) pays for on one GPU, in
// isolation: 16M positions, each with a random center among 1M nodes and
// K = 4 entries, written into the center's segment of a 268-MB buffer
// (ascending segments, as the scan lays them out). Variants: the count's
// fire-and-forget atomics alone; the scatter's atomics with return alone;
// atomics and writes; the writes alone at given ranks (and at given
// addresses); and atomics and writes in 5, 10 and 20 sweeps over ranges of
// segments, each sweep's positions picked by a byte a position. Prints the
// mean ms of 5 runs of each on CUDA events. It is the floor that a next
// design of the scatter (a partition through shared memory, so that its
// writes leave the blocks as runs) is held against.
//
//   mkdir -p embiggen_tpu_torch/_build
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//       -o embiggen_tpu_torch/_build/cooc_scatter_probe \
//       embiggen_tpu_torch/scripts/cooc_scatter_probe.cu
//   embiggen_tpu_torch/_build/cooc_scatter_probe
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
#include <vector>
#include <random>
#include <algorithm>

constexpr long long P = 16LL << 20;  // positions
constexpr int N = 1 << 20;            // nodes
constexpr int K = 4;                  // entries a position

__global__ void red_only(const int* a, unsigned* cnt) {
  long long i = blockIdx.x * 256LL + threadIdx.x; if (i >= P) return;
  atomicAdd(cnt + a[i], (unsigned)K);
}
__global__ void atom_ret(const int* a, unsigned* cnt, unsigned* sink) {
  long long i = blockIdx.x * 256LL + threadIdx.x; if (i >= P) return;
  unsigned o = atomicSub(cnt + a[i], (unsigned)K);
  if (o == 0xdeadbeef) sink[0] = o;
}
__global__ void atom_write(const int* a, unsigned* cnt, const long long* off, unsigned* ent) {
  long long i = blockIdx.x * 256LL + threadIdx.x; if (i >= P) return;
  int x = a[i];
  unsigned* out = ent + off[x] + atomicSub(cnt + x, (unsigned)K) - K;
  for (int k = 0; k < K; ++k) out[k] = (unsigned)i + k;
}
__global__ void write_only(const int* a, const unsigned* rank, const long long* off, unsigned* ent) {
  long long i = blockIdx.x * 256LL + threadIdx.x; if (i >= P) return;
  int x = a[i];
  unsigned* out = ent + off[x] + rank[i];
  for (int k = 0; k < K; ++k) out[k] = (unsigned)i + k;
}
__global__ void write_only_sorted(const unsigned* dst, unsigned* ent) {
  long long i = blockIdx.x * 256LL + threadIdx.x; if (i >= P) return;
  unsigned* out = ent + dst[i];
  for (int k = 0; k < K; ++k) out[k] = (unsigned)i + k;
}
__global__ void atom_write_sweep(const int* a, const uint8_t* sw, int s, unsigned* cnt, const long long* off, unsigned* ent) {
  long long stride = (long long)gridDim.x * 256;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < P; i += stride) {
    if (__ldcs(sw + i) != s) continue;
    int x = __ldcs(a + i);
    unsigned* out = ent + off[x] + atomicSub(cnt + x, (unsigned)K) - K;
    for (int k = 0; k < K; ++k) out[k] = (unsigned)i + k;
  }
}
__global__ void write_sweep(const int* a, const uint8_t* sw, int s, const unsigned* rank, const long long* off, unsigned* ent) {
  long long stride = (long long)gridDim.x * 256;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < P; i += stride) {
    if (__ldcs(sw + i) != s) continue;
    int x = __ldcs(a + i);
    unsigned* out = ent + off[x] + rank[i];
    for (int k = 0; k < K; ++k) out[k] = (unsigned)i + k;
  }
}
__global__ void reset(unsigned* cnt, const unsigned* c0) { int i = blockIdx.x * 256 + threadIdx.x; if (i < N) cnt[i] = c0[i]; }

int main() {
  std::mt19937 g(1);
  std::vector<int> a(P);
  for (auto& x : a) x = g() % N;
  std::vector<unsigned> c0(N, 0), rank(P);
  for (long long i = 0; i < P; ++i) { rank[i] = c0[a[i]]; c0[a[i]] += K; }
  std::vector<long long> off(N + 1, 0);
  for (int i = 0; i < N; ++i) off[i + 1] = off[i] + c0[i];
  std::vector<unsigned> dst(P);
  for (long long i = 0; i < P; ++i) dst[i] = off[a[i]] + rank[i];
  const long long T = off[N];
  int *da; unsigned *dcnt, *dc0, *drank, *dent, *dsink, *ddst; long long* doff; uint8_t* dsw;
  cudaMalloc(&da, P * 4); cudaMalloc(&dcnt, N * 4); cudaMalloc(&dc0, N * 4); cudaMalloc(&drank, P * 4);
  cudaMalloc(&dent, T * 4); cudaMalloc(&dsink, 4); cudaMalloc(&doff, (N + 1) * 8); cudaMalloc(&dsw, P); cudaMalloc(&ddst, P * 4);
  cudaMemcpy(da, a.data(), P * 4, cudaMemcpyHostToDevice); cudaMemcpy(dc0, c0.data(), N * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(drank, rank.data(), P * 4, cudaMemcpyHostToDevice); cudaMemcpy(doff, off.data(), (N + 1) * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(ddst, dst.data(), P * 4, cudaMemcpyHostToDevice);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  unsigned blocks = (P + 255) / 256;
  auto run = [&](const char* name, auto f) {
    for (int w = 0; w < 2; ++w) { reset<<<N / 256, 256>>>(dcnt, dc0); f(); }
    float tot = 0;
    for (int r = 0; r < 5; ++r) {
      reset<<<N / 256, 256>>>(dcnt, dc0);
      cudaEventRecord(e0); f(); cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1); tot += ms;
    }
    printf("%-28s %.4f ms  (%s)\n", name, tot / 5, cudaGetErrorString(cudaGetLastError()));
  };
  run("red_only", [&] { red_only<<<blocks, 256>>>(da, dcnt); });
  run("atom_ret", [&] { atom_ret<<<blocks, 256>>>(da, dcnt, dsink); });
  run("atom_write", [&] { atom_write<<<blocks, 256>>>(da, dcnt, doff, dent); });
  run("write_only (rank given)", [&] { write_only<<<blocks, 256>>>(da, drank, doff, dent); });
  run("write_only_sorted_dst", [&] { write_only_sorted<<<blocks, 256>>>(ddst, dent); });
  for (int S : {5, 10, 20}) {
    const long long wd = (T + S - 1) / S;
    std::vector<uint8_t> sw2(P);
    for (long long i = 0; i < P; ++i) sw2[i] = off[a[i]] / wd;
    cudaMemcpy(dsw, sw2.data(), P, cudaMemcpyHostToDevice);
    char name[64];
    snprintf(name, 64, "atom_write %d sweeps", S);
    run(name, [&] { for (int s = 0; s < S; ++s) atom_write_sweep<<<8 * sms, 256>>>(da, dsw, s, dcnt, doff, dent); });
    snprintf(name, 64, "write %d sweeps (rank)", S);
    run(name, [&] { for (int s = 0; s < S; ++s) write_sweep<<<8 * sms, 256>>>(da, dsw, s, drank, doff, dent); });
  }
  return 0;
}
