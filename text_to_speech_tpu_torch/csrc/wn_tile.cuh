// Device code shared by the WN kernels for Hopper (sm_90a).
//
// The element conversions and the cp.async copies serve the three WN
// kernels (wn_block.cu, wn_block_int8.cu, wn_layer.cu).  `tile::product` is
// the GEMM mainloop of the float32 kernels of K1 (wn_block.cu) and K4
// (wn_layer.cu): one block's BM x 128 product over a 3-stage ring of
// 32-deep cp.async stages on FMA tiles in true f32, left as an f32 tile at
// the start of shared memory, which lets the card check the indexing
// tightly against the plain versions.  The bf16 paths run on wgmma
// (wn_sm90.cuh, wn_block_int8.cu).  Each kernel keeps its loaders and
// epilogues.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte asynchronous copy global -> shared; with `valid` false nothing is
// read and the 16 bytes are zero-filled (`src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

namespace tile {

constexpr int BN = 128;       // accumulator columns per product
constexpr int BK = 32;        // reduction depth per stage
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int C_LD = BN + 4;  // f32 accumulator tile row stride

// shared-memory row strides (elements) of the A and B stages: 16 bytes of
// padding a row
template <typename T> struct Tile {
  static constexpr int A_LD = BK + 16 / (int)sizeof(T);
  static constexpr int B_LD = BN + 16 / (int)sizeof(T);
};

// the ring of A and B stages, reused for the f32 accumulator tile after
// each product; BYTES is rounded up to 128 so a kernel can put its own
// tiles behind it
template <typename T, int BM>
struct Smem {
  static constexpr int A_STAGE = BM * Tile<T>::A_LD;          // elements
  static constexpr int B_STAGE = BK * Tile<T>::B_LD;
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(T);
  static constexpr int ACC = BM * C_LD * (int)sizeof(float);
  static constexpr int BYTES = ((RING > ACC ? RING : ACC) + 127) / 128 * 128;
};

// The block's BM x BN product A (BM x K) @ B (K x BN) in f32, left in the
// accumulator tile (row stride C_LD) at the start of `smem`.  B always
// streams through the ring; A streams through it too, or, with A_RESIDENT,
// is read in place from a shared tile `a_res` of row stride `a_ld`.
// load(sA, sB, k0) starts the cp.async copies of one stage; the loop keeps
// STAGES - 1 stages in flight ahead of the one being multiplied.  BM is 64
// or 128: threads own BM/16 rows x 8 columns.
template <typename T, int BM, bool A_RESIDENT, typename Load>
__device__ void product(unsigned char* smem, int K, const T* a_res, int a_ld, Load load) {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(std::is_same<T, float>::value, "the FMA tiles are float32");
  constexpr int A_LD = Tile<T>::A_LD;
  constexpr int B_LD = Tile<T>::B_LD;
  T* ring = reinterpret_cast<T*>(smem);
  auto sA = [&](int s) { return ring + s * (Smem<T, BM>::A_STAGE + Smem<T, BM>::B_STAGE); };
  auto sB = [&](int s) { return sA(s) + Smem<T, BM>::A_STAGE; };
  float* sC = reinterpret_cast<float*>(smem);

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(sA(s), sB(s), s * BK);
    cp_async_commit();
  }
  const int tid = threadIdx.x;
  constexpr int RM = BM / 16;
  const int ty = tid / 16, tx = tid % 16;     // RM rows x 8 columns each
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load(sA(next % STAGES), sB(next % STAGES), next * BK);
    cp_async_commit();
    const float* a_s = A_RESIDENT ? a_res + kt * BK : sA(kt % STAGES);
    const int lda = A_RESIDENT ? a_ld : A_LD;
    const float* b_s = sB(kt % STAGES);
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = a_s[(ty * RM + i) * lda + k];
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * B_LD + tx * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * B_LD + tx * 8 + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sC[(ty * RM + i) * C_LD + tx * 8 + j] = acc[i][j];
  __syncthreads();
}

}  // namespace tile

}  // namespace
