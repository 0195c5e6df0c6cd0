// WaveGlow WN coupling block for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_wn_block` (text_to_speech_tpu/ops/
// pallas_kernels.py, body `_wn_block_kernel`).  It computes the same
// function: for each of the L layers i,
//
//   acts  = conv3(x, w_in[i], dilation 2^i) + spect @ w_cond[i] + b_in[i] + b_cond[i]
//   gated = tanh(acts[:, :C]) * sigmoid(acts[:, C:])        (f32, stored in T)
//   rs    = gated @ w_rs[i] + b_rs[i]
//   x    += rs[:, :C]          (layers 0..L-2; stored in T)
//   skip += rs[:, C:]          (f32; the last layer's rs is all skip)
//
// and returns skip in T.  Rows outside [0, T) read as zero, which is the
// per-layer SAME padding of the reference chain.
//
// Each layer is two GEMMs with fused epilogues:
//   in: M = B*T rows, K = 3C + S, N = 2C.  The A tile is the im2col of rows
//     t-d, t, t+d of x and row t of spect, so the (B, T, 3C+S) operand never
//     exists in memory.  The weight tile pairs columns j and C+j, so the
//     epilogue applies the tanh-sigmoid gate and writes only gated (B, T, C).
//   rs: M = B*T, K = C, N = 2C (C for the last layer).  Its epilogue updates
//     x in place (each element read and written by the thread that owns it,
//     after the layer's in-GEMM has finished reading x) and accumulates skip
//     in an f32 buffer; the last layer writes the output.
//
// bf16 (the serving and wn_train_fused path), `sm90::` (wn_sm90.cuh, whose
// kernels K4 shares, templated on what differs): warp-specialised
// wgmma kernels on a persistent grid (a block takes tiles i, i + gridDim.x,
// ...).  A producer warpgroup (one thread, the others idle after giving up
// registers with setmaxnreg) keeps a 4-stage ring full with TMA loads, each
// completing on the stage's mbarrier, and runs on into the next tile while
// the consumers finish one; two consumer warpgroups run wgmma.mma_async
// (bf16 in, f32 accumulators in registers) and release each stage to the
// producer once its products are done.
//   - in: 128 x 256 tiles on m64n256k16, 48 KB stages.  im2col by TMA: x is
//     a 3-D tensor map (C, T, B) with a box of 64 channels x 128 rows x 1;
//     tap k loads at time coordinate t0 + (k-1) d.  TMA writes zeros for
//     every element outside [0, T), negative coordinates included: that is
//     the SAME padding.  A box never leaves its batch row, so tiles are cut
//     per batch row: B x ceil(T/128) row tiles.  The mel is the fourth K
//     segment, with its own (S, T, B) map; its last 64-wide stage, where
//     S % 64 == 32, reads zeros past S on both operands (the weight map is
//     3-D too, so rows past 3C + S are zero, not the next layer's).  The
//     weights stay in the packed layout, N contiguous (MN-major B), which
//     wgmma reads through its transpose bit.  One stage's B is four
//     64-column boxes: gated columns [n0, n0+128) and their sigmoid
//     partners [C+n0, +128), so a thread's fragment holds each tanh column
//     and its sigmoid partner 64 registers apart, and the gate runs in
//     registers; the gated pairs go to memory from there.
//   - rs: 128 x 128 tiles on m64n128k16, 32 KB stages, so that a 64 KB
//     staging tile fits beside the ring: the producer loads the tile's x
//     (residual columns) or skip sum by TMA behind its stages, the
//     consumers add the products to it in shared memory, and one TMA store
//     writes it back (the last layer's output from a second staging tile).
//     Read-modify-writes from registers took 44 of this GEMM's 64 us a
//     layer on an H100.
//   - Every box is 128 bytes wide and lands 128-byte swizzled; the wgmma
//     descriptors describe that layout (wn_wgmma.cuh).  Tensor maps are
//     encoded once per call on the host and passed as __grid_constant__
//     parameters.
// float32, `in_kernel` / `rs_kernel`: FMA tiles in true f32 through
// `tile::product` (wn_tile.cuh), which lets the card check the indexing
// tightly against the plain version.
//
// Bound on an H100 SXM: per grouped row a block takes
//   2 * ((3C + S) * 2C + C * 2C) * (L - 1) + 2 * ((3C + S) * 2C + C * C)
// operations, 43.5 MFLOP at C = 512, S = 640, L = 8; 356 GFLOP for a
// 256-frame utterance (T = 8192), 0.36 ms at 989 TFLOP/s dense bf16.  The
// bytes (about 44 MB of bf16 weights, 19 MB of x and spect) take 0.02 ms at
// 3.35 TB/s, so the block is bound by operations.  What stands between the
// bf16 kernels and that bound is L2: every row tile streams its weights
// again.  At T = 8192, B = 1 the tiles move about 4.9 GB through L2 a block
// (`l2_bytes` in ops/wn_block.py).  A cluster of two row tiles that
// multicast each weight box to both blocks (a third less L2 traffic for the
// in-GEMM) ran 69.5 us a layer against 66.5 on an H100: the in-GEMM is not
// bound by L2, and the pair's coupling costs more than the bytes save.

#include "wn_sm90.cuh"
#include "wn_tile.cuh"

#include <stdint.h>

namespace {

using namespace tile;

constexpr int BM = 128;       // rows per block

// Layer i, first GEMM: acts over K = 3C + S with the gate in the epilogue.
// Block (bx, by) owns rows [bx*BM, +BM) and gated columns [by*64, +64),
// i.e. acts columns [by*64, +64) and [C + by*64, +64).
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_kernel(const T* __restrict__ x, const T* __restrict__ spect,
          const T* __restrict__ w, const float* __restrict__ bias,
          T* __restrict__ gated, int M, int T_len, int C, int S, int dilation) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);              // elements per 16-byte copy
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * 64;
  const int N = 2 * C;
  const int tid = threadIdx.x;

  auto load = [&](T* sA, T* sB, int k0) {
    // every BK-wide stage lies inside one segment: tap 0, 1, 2 or spect
    const T* src;
    int width, ch0, shift;
    if (k0 < 3 * C) {
      const int tap = k0 / C;
      src = x; width = C; ch0 = k0 - tap * C; shift = (tap - 1) * dilation;
    } else {
      src = spect; width = S; ch0 = k0 - 3 * C; shift = 0;
    }
    constexpr int A_ROW = BK / V;
    for (int c = tid; c < BM * A_ROW; c += THREADS) {
      const int r = c / A_ROW, kc = (c % A_ROW) * V;
      const int row = m0 + r;
      bool ok = row < M;
      int b = 0, t = 0;
      if (ok) {
        b = row / T_len;
        t = row - b * T_len + shift;
        ok = t >= 0 && t < T_len;
      }
      cp_async16(sA + r * Tile<T>::A_LD + kc,
                 ok ? src + ((size_t)b * T_len + t) * width + ch0 + kc : src, ok);
    }
    constexpr int B_ROW = BN / V;
    for (int c = tid; c < BK * B_ROW; c += THREADS) {
      const int kr = c / B_ROW, jc = (c % B_ROW) * V;
      const int col = jc < 64 ? n0 + jc : C + n0 + (jc - 64);
      cp_async16(sB + kr * Tile<T>::B_LD + jc, w + (size_t)(k0 + kr) * N + col, true);
    }
  };
  product<T, BM, false>(smem, 3 * C + S, nullptr, 0, load);

  const float* sC = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < BM * 64; e += THREADS) {
    const int r = e / 64, j = e % 64;
    const int row = m0 + r;
    if (row >= M) continue;
    const float a_t = sC[r * C_LD + j] + bias[n0 + j];
    const float a_s = sC[r * C_LD + 64 + j] + bias[C + n0 + j];
    const float g = tanhf(a_t) * (1.f / (1.f + expf(-a_s)));
    gated[(size_t)row * C + n0 + j] = from_f<T>(g);
  }
}

// Layer i, second GEMM: rs = gated @ w_rs + b_rs, fused residual and skip.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rs_kernel(const T* __restrict__ gated, const T* __restrict__ w,
          const float* __restrict__ bias, T* __restrict__ x,
          float* __restrict__ skip, T* __restrict__ out,
          int M, int C, int N, int first, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);              // elements per 16-byte copy
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  auto load = [&](T* sA, T* sB, int k0) {
    constexpr int A_ROW = BK / V;
    for (int c = tid; c < BM * A_ROW; c += THREADS) {
      const int r = c / A_ROW, kc = (c % A_ROW) * V;
      const int row = m0 + r;
      const bool ok = row < M;
      cp_async16(sA + r * Tile<T>::A_LD + kc,
                 ok ? gated + (size_t)row * C + k0 + kc : gated, ok);
    }
    constexpr int B_ROW = BN / V;
    for (int c = tid; c < BK * B_ROW; c += THREADS) {
      const int kr = c / B_ROW, jc = (c % B_ROW) * V;
      cp_async16(sB + kr * Tile<T>::B_LD + jc, w + (size_t)(k0 + kr) * N + n0 + jc, true);
    }
  };
  product<T, BM, false>(smem, C, nullptr, 0, load);

  const float* sC = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, j = e % BN;
    const int row = m0 + r;
    if (row >= M) continue;
    const int col = n0 + j;
    const float v = sC[r * C_LD + j] + bias[col];
    if (!last && col < C) {
      const size_t at = (size_t)row * C + col;
      x[at] = from_f<T>(to_f(x[at]) + v);
    } else {
      const size_t at = (size_t)row * C + (last ? col : col - C);
      const float acc = (first ? 0.f : skip[at]) + v;
      if (last) out[at] = from_f<T>(acc);
      else skip[at] = acc;
    }
  }
}

template <typename T>
int run_block(const void* spect, const void* w_in_cond, const float* b_in_cond,
              const void* w_rs, const float* b_rs, const void* w_rs_last,
              const float* b_rs_last, void* x, void* gated, float* skip, void* out,
              int B, int T_len, int C, int S, int L, cudaStream_t stream) {
  constexpr int smem = Smem<T, BM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      in_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      rs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  const int M = B * T_len;
  const int K = 3 * C + S;
  const dim3 block(THREADS);
  const dim3 grid_in((M + BM - 1) / BM, C / 64);
  for (int i = 0; i < L; ++i) {
    in_kernel<T><<<grid_in, block, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(spect),
        static_cast<const T*>(w_in_cond) + (size_t)i * K * 2 * C,
        b_in_cond + (size_t)i * 2 * C, static_cast<T*>(gated),
        M, T_len, C, S, 1 << i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool last = i == L - 1;
    const int N = last ? C : 2 * C;
    const T* w = last ? static_cast<const T*>(w_rs_last)
                      : static_cast<const T*>(w_rs) + (size_t)i * C * 2 * C;
    const float* b = last ? b_rs_last : b_rs + (size_t)i * 2 * C;
    const dim3 grid_rs((M + BM - 1) / BM, N / BN);
    rs_kernel<T><<<grid_rs, block, smem, stream>>>(
        static_cast<const T*>(gated), w, b, static_cast<T*>(x), skip,
        static_cast<T*>(out), M, C, N, i == 0, last);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}


// ---- bf16: warp-specialised wgmma with TMA ------------------------------------

namespace sm90 {

// -1: the CUDA driver refused a tensor map (alignment or strides)
int run_block(const void* spect, const void* w_in_cond, const float* b_in_cond,
              const void* w_rs, const float* b_rs, const void* w_rs_last,
              const float* b_rs_last, void* x, void* gated, float* skip, void* out,
              int B, int T_len, int C, int S, int L, cudaStream_t stream) {
  const auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int K = 3 * C + S;
  CUtensorMap m_x, m_sp, m_g, m_in, m_rs, m_last, m_skip, m_out;
  if (!hop::make_map(&m_x, BF16, 2, x, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_sp, BF16, 2, spect, S, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_g, BF16, 2, gated, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_skip, F32, 4, skip, C, T_len, B, 32, BM, true) ||
      !hop::make_map(&m_out, BF16, 2, out, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_in, BF16, 2, w_in_cond, 2 * C, K, L, 64, BK, true) ||
      !hop::make_map(&m_rs, BF16, 2, w_rs, 2 * C, C, L - 1, 64, BK, true) ||
      !hop::make_map(&m_last, BF16, 2, w_rs_last, C, C, 1, 64, BK, true))
    return -1;
  const int in_smem = smem_bytes(IN_CHUNKS, 0), rs_smem = smem_bytes(RS_CHUNKS, RS_EXTRA);
  cudaError_t err = cudaFuncSetAttribute(
      wn_in_wgmma<float, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, in_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wn_rs_wgmma<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rs_smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = B * ((T_len + BM - 1) / BM);
  const auto grid = [&](int tiles) { return tiles < sms ? tiles : sms; };
  for (int i = 0; i < L; ++i) {
    wn_in_wgmma<float, false><<<grid(row_tiles * (C / 128)), THREADS, in_smem, stream>>>(
        m_x, m_sp, m_in, m_x, b_in_cond + (size_t)i * 2 * C, static_cast<bf16*>(gated), B,
        T_len, C, S, i, 1 << i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool last = i == L - 1;
    const int N = last ? C : 2 * C;
    wn_rs_wgmma<float><<<grid(row_tiles * (N / 128)), THREADS, rs_smem, stream>>>(
        m_g, last ? m_last : m_rs, m_x, m_x, m_skip, m_out,
        last ? b_rs_last : b_rs + (size_t)i * 2 * C, B, T_len, C, N, last ? 0 : i, i == 0,
        !last, last);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// x is the block's working buffer (the start conv's output, B x T x C); it
// is overwritten with the residual stream.  gated (B x T x C, T) and skip
// (B x T x C, f32) are scratch; out (B x T x C, T) receives the skip sum.
// Weights: w_in_cond (L, 3C + S, 2C) = [w_in tap 0; tap 1; tap 2; w_cond],
// w_rs (L - 1, C, 2C), w_rs_last (C, C); biases are f32, b_in_cond = b_in +
// b_cond.  Requires C % 128 == 0, S % 32 == 0 and 16-byte aligned pointers.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int wn_block_forward(int is_bf16, const void* spect,
                                const void* w_in_cond, const float* b_in_cond,
                                const void* w_rs, const float* b_rs,
                                const void* w_rs_last, const float* b_rs_last,
                                void* x, void* gated, float* skip, void* out,
                                int B, int T_len, int C, int S, int L,
                                void* stream) {
  if (is_bf16)
    return sm90::run_block(spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last,
                         x, gated, skip, out, B, T_len, C, S, L, (cudaStream_t)stream);
  return run_block<float>(spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last,
                          b_rs_last, x, gated, skip, out, B, T_len, C, S, L,
                          (cudaStream_t)stream);
}
