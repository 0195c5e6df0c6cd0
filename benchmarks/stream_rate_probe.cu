// Streaming-rate probe for one NVIDIA H100: how fast 132 blocks of 512
// threads, each reading its own 384 KB region 20 times, pull bytes into the
// SMs (a) through a ring of cp.async.bulk stages completing on mbarriers
// (stage bytes x depth; refilled by thread 0 after the 16 warps have read a
// stage, or by a dedicated producer warp), and (b) with 16-byte loads, U in
// flight a thread, with ~220 KB of shared memory allocated (the carve-out of
// the decoder-steps kernel, K3) or none.  The regions total 50.7 MB, about
// the L2, so the runs without shared memory are partly served from L2.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/stream_rate_probe benchmarks/stream_rate_probe.cu
//   build/stream_rate_probe
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void minit(uint64_t* b, uint32_t c) { asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(sa(b)), "r"(c)); }
__device__ __forceinline__ void mexp(uint64_t* b, uint32_t n) { asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(sa(b)), "r"(n) : "memory"); }
__device__ __forceinline__ void marr(uint64_t* b) { asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(sa(b)) : "memory"); }
__device__ __forceinline__ void mwait(uint64_t* b, uint32_t par) {
  uint32_t d, tries = 0;   // traps after 2^25 tries instead of hanging the card
  do { asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0,1,0,p; }" : "=r"(d) : "r"(sa(b)), "r"(par) : "memory");
       if (++tries == (1u << 25)) __trap(); } while (!d); }
__device__ __forceinline__ void bulk(void* dst, const void* src, uint32_t n, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" :: "r"(sa(dst)), "l"(__cvta_generic_to_global(src)), "r"(n), "r"(sa(b)) : "memory"); }

template <int STAGE, int DEPTH, bool PRODUCER>
__global__ void __launch_bounds__(544, 1) ring(const unsigned char* src, size_t per_block, int reps, float* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = (uint64_t*)(sm + STAGE * DEPTH); uint64_t* empty = full + DEPTH;
  const unsigned char* base = src + blockIdx.x * per_block;
  const int n = (int)(per_block / STAGE) * reps;
  if (threadIdx.x == 0) { for (int i = 0; i < DEPTH; ++i) { minit(full + i, 1); minit(empty + i, 16); } asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }
  __syncthreads();
  auto issue = [&](int i) { mexp(full + i % DEPTH, STAGE); bulk(sm + (i % DEPTH) * STAGE, base + (size_t)(i % (per_block / STAGE)) * STAGE, STAGE, full + i % DEPTH); };
  float acc = 0.f;
  const int warp = threadIdx.x >> 5;
  if (PRODUCER && warp == 16) {
    if (threadIdx.x == 512) for (int i = 0; i < n; ++i) { if (i >= DEPTH) mwait(empty + i % DEPTH, ((i / DEPTH) - 1) & 1); issue(i); }
  } else if (warp < 16) {
    if (!PRODUCER && threadIdx.x == 0) for (int i = 0; i < DEPTH && i < n; ++i) issue(i);
    for (int i = 0; i < n; ++i) {
      mwait(full + i % DEPTH, (i / DEPTH) & 1);
      const float4* s = (const float4*)(sm + (i % DEPTH) * STAGE);
      for (int j = threadIdx.x; j < STAGE / 16; j += 512) { float4 v = s[j]; acc += v.x + v.y + v.z + v.w; }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) marr(empty + i % DEPTH);
      if (!PRODUCER && threadIdx.x == 0 && i + DEPTH < n) { mwait(empty + i % DEPTH, (i / DEPTH) & 1); issue(i + DEPTH); }
    }
  }
  if (acc == 1234.5f) out[0] = acc;
}

__device__ __forceinline__ float4 ld_mode(const float4* p, int mode) {
  if (mode == 0) return __ldg(p);
  if (mode == 1) return __ldcg(p);
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
template <int U, int MODE>
__global__ void __launch_bounds__(512, 1) ldgm(const float4* src, size_t per_block, int reps, float* out) {
  extern __shared__ float big[];
  const float4* base = src + blockIdx.x * (per_block / 16);
  const int n = (int)(per_block / 16);
  float acc = 0.f;
  for (int r = 0; r < reps; ++r)
    for (int i = threadIdx.x; i < n; i += 512 * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = i + u * 512 < n ? ld_mode(base + i + u * 512, MODE) : make_float4(0,0,0,0);
#pragma unroll
      for (int u = 0; u < U; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  if (acc == 1234.5f) { out[0] = acc; big[threadIdx.x] = acc; }
}
template <int U>
__global__ void __launch_bounds__(512, 1) ldg(const float4* src, size_t per_block, int reps, float* out) {
  const float4* base = src + blockIdx.x * (per_block / 16);
  const int n = (int)(per_block / 16);
  float acc = 0.f;
  for (int r = 0; r < reps; ++r)
    for (int i = threadIdx.x; i < n; i += 512 * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = i + u * 512 < n ? __ldg(base + i + u * 512) : make_float4(0,0,0,0);
#pragma unroll
      for (int u = 0; u < U; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  if (acc == 1234.5f) out[0] = acc;
}

int main() {
  const int blocks = 132, reps = 20; const size_t per_block = 393216;   // 384 KB
  unsigned char* src; float* out; cudaMalloc(&src, per_block * blocks); cudaMalloc(&out, 4);
  cudaMemset(src, 0, per_block * blocks);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  auto run = [&](const char* name, auto launch) {
    launch(); cudaDeviceSynchronize();
    cudaEventRecord(a); for (int k = 0; k < 3; ++k) launch(); cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b); ms /= 3;
    printf("%-28s %8.3f ms  %6.3f TB/s  %s\n", name, ms, per_block * blocks * (double)reps / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  };
#define RING(S, D, P) { auto k = ring<S, D, P>; int sm = S * D + 2 * D * 8; cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, sm); \
    run(P ? "ring " #S " x " #D " producer" : "ring " #S " x " #D, [&] { k<<<blocks, P ? 544 : 512, sm>>>(src, per_block, reps, out); }); }
  RING(8192, 8, false) RING(8192, 8, true) RING(16384, 4, false) RING(16384, 8, false) RING(32768, 4, false) RING(4096, 16, false) RING(16384, 8, true) RING(32768, 6, true)
  // L1-bypass variants with 220 KB of shared memory, over 4x the L2 (reading 4 disjoint copies)
  {
    const int smem = 220 * 1024;
#define LDGM(U, M, NAME) { auto k = ldgm<U, M>; cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
      run(NAME, [&] { k<<<blocks, 512, smem>>>((const float4*)src, per_block, reps, out); }); }
    LDGM(8, 0, "ldg x8 big smem") LDGM(8, 1, "ldcg x8 big smem") LDGM(8, 2, "nc.no_alloc x8 big smem") LDGM(16, 1, "ldcg x16 big smem")
  }
  run("ldg x4", [&] { ldg<4><<<blocks, 512>>>((const float4*)src, per_block, reps, out); });
  run("ldg x8", [&] { ldg<8><<<blocks, 512>>>((const float4*)src, per_block, reps, out); });
  run("ldg x16", [&] { ldg<16><<<blocks, 512>>>((const float4*)src, per_block, reps, out); });
  return 0;
}
