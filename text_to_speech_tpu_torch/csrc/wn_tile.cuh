// Device code shared by the WN kernels for Hopper (sm_90a).
//
// The element conversions and the cp.async copies serve all three WN
// kernels (wn_block.cu, wn_block_int8.cu, wn_layer.cu).  `tile::product` is
// the GEMM mainloop of the bf16 / f32 kernels (wn_block.cu, wn_layer.cu):
// one block's BM x 128 product over a 3-stage ring of 32-deep cp.async
// stages, on the tensor cores through nvcuda::wmma for bf16 (bf16 operands,
// f32 accumulation) and on FMA tiles in true f32 for float, left as an f32
// tile at the start of shared memory.  The int8 kernel has its own
// mainloop on mma.sync s8.  Each kernel keeps its loaders and epilogues.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

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

// The block's BM x BN product A (BM x K) @ B (K x BN), left as f32 in the
// accumulator tile (row stride C_LD) at the start of `smem`.  B always
// streams through the ring; A streams through it too, or, with A_RESIDENT,
// is read in place from a shared tile `a_res` of row stride `a_ld`.
// load(sA, sB, k0) starts the cp.async copies of one stage; the loop keeps
// STAGES - 1 stages in flight ahead of the one being multiplied.  BM is 64
// or 128: f32 threads own BM/16 rows x 8 columns, bf16 warps 32 rows x
// (BN / (8 / (BM/32))) columns.
template <typename T, int BM, bool A_RESIDENT, typename Load>
__device__ void product(unsigned char* smem, int K, const T* a_res, int a_ld, Load load) {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
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
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    using namespace nvcuda;
    constexpr int WARPS_N = 8 / (BM / 32);      // warps across the columns
    constexpr int FN = BN / WARPS_N / 16;       // 16-column fragments a warp
    const int warp = tid / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < nk) load(sA(next % STAGES), sB(next % STAGES), next * BK);
      cp_async_commit();
      const T* a_s = A_RESIDENT ? a_res + kt * BK : sA(kt % STAGES);
      const int lda = A_RESIDENT ? a_ld : A_LD;
      const T* b_s = sB(kt % STAGES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], a_s + (wm * 32 + i * 16) * lda + kk, lda);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, b_s + kk * B_LD + wn * FN * 16 + j * 16, B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * C_LD + wn * FN * 16 + j * 16,
                                acc[i][j], C_LD, wmma::mem_row_major);
  }
  __syncthreads();
}

}  // namespace tile

}  // namespace
