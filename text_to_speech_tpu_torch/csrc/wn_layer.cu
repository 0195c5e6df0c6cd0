// One WaveGlow WN layer for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_wn_layer` (text_to_speech_tpu/ops/
// pallas_kernels.py, body `_wn_layer_kernel`).  It computes the same
// function, for x (B, T, C) and cond (B, T, 2C) in one dtype T:
//
//   acts  = sum_k x[t + (k-1)d] @ w_in[k] + b_in + cond      (f32)
//   gated = tanh(acts[:, :C]) * sigmoid(acts[:, C:])          (f32, stored in T)
//   rs    = gated @ w_rs + b_rs                               (f32)
//   residual: x_out = x + rs[:, :C] (f32 sum, stored in T), skip = rs[:, C:]
//   last layer: x is returned unchanged (by the wrapper) and skip = rs
//
// with the skip in T.  Rows outside [0, T) read as zero, which is the SAME
// padding of the reference; the TPU kernel's pre-padded input and halo DMA
// are not needed.
//
// Design.  bf16: the two GEMMs of K1's layer (wn_sm90.cuh, `sm90::`), not
// a copy of them: warp-specialised wgmma kernels on a persistent grid, a
// producer thread keeping a 4-stage TMA ring full, two consumer warpgroups.
//   1. in: M = B*T rows, K = 3C, N = 2C on m64n256k16, 128 x 256 tiles.
//      The A tile is the im2col of rows t-d, t, t+d of x, done by TMA on a
//      (C, T, B) tensor map: a box at time coordinate t0 + (k-1)d is
//      zero-filled wherever it leaves [0, T), wholly so for a dilation
//      beyond the tile or the sequence, which is the SAME padding.  The
//      weight columns pair j with C + j, so the epilogue adds b_in, then
//      cond (read at the fragment's own positions), and applies the gate in
//      registers; the gate goes to a (B, T, C) bf16 scratch.
//   2. rs: M = B*T, K = C, N = 2C (C for the last layer) on m64n128k16:
//      residual columns load x by TMA into a staging tile, add rs there and
//      store x_out (a new tensor: the caller still holds x) by TMA; skip
//      columns store rs in bf16 the same way.
// The TPU kernel keeps the gate in VMEM; here it crosses device memory
// between the two kernels (64 MB written and read a layer at B = 8, T =
// 8192, about 14 % of the layer's bound at 3.35 TB/s), which buys K1's
// pipeline whole.
// float32: one block owns BM = 64 rows and runs both products on the FMA
// tiles of wn_tile.cuh (`tile::product`, a 3-stage cp.async ring) in true
// f32, with the gate in a (64 x C) shared tile; it checks the indexing
// tightly against the plain version.  Envelope: C % 128 == 0 and C <= 512.
//
// Bound on an H100 SXM, for B = 8, T = 8192, C = 512 and a residual layer:
// 2 * B * T * (3C * 2C + C * 2C) = 2.75e11 operations, 0.278 ms at 989
// TFLOP/s dense bf16 (4.10 ms in f32 outside the tensor cores at 67
// TFLOP/s).  It moves x, cond, x_out, skip and the weights once, 335 MB in
// bf16, 0.100 ms at 3.35 TB/s: the layer is bound by operations.  L2
// traffic by the tiling: `l2_bytes` in ops/wn_layer.py.

#include "wn_sm90.cuh"
#include "wn_tile.cuh"

#include <stdint.h>

namespace {

using namespace tile;

constexpr int BM = 64;        // rows per block
constexpr int MAX_C = 512;

// dynamic shared memory: the product's ring and accumulator tile, then the
// (BM x C) gate tile with 16 bytes of padding a row
template <typename T>
__host__ __device__ constexpr int gate_ld(int C) { return C + 16 / (int)sizeof(T); }
template <typename T>
constexpr int smem_bytes(int C) {
  return Smem<T, BM>::BYTES + BM * gate_ld<T>(C) * (int)sizeof(T);
}

// The layer.  Block b owns rows [b*BM, +BM) of the flattened (B*T) rows.
// N is w_rs's width: 2C for a residual layer, C for the last one.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wn_layer_kernel(const T* __restrict__ x, const T* __restrict__ cond,
                const T* __restrict__ w_in, const T* __restrict__ b_in,
                const T* __restrict__ w_rs, const T* __restrict__ b_rs,
                T* __restrict__ x_out, T* __restrict__ skip,
                int M, int T_len, int C, int N, int dilation, int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);              // elements per 16-byte copy
  constexpr int A_LD = Tile<T>::A_LD;
  constexpr int B_LD = Tile<T>::B_LD;
  T* gate = reinterpret_cast<T*>(smem + Smem<T, BM>::BYTES);
  const int g_ld = gate_ld<T>(C);
  const float* sC = reinterpret_cast<const float*>(smem);
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;

  // 1. acts and the gate, 64 gated columns (acts columns j0 + [0, 64) and
  //    C + j0 + [0, 64)) a pass, over K = 3C: [x[t-d] | x[t] | x[t+d]]
  for (int j0 = 0; j0 < C; j0 += 64) {
    auto load = [&](T* sA, T* sB, int k0) {
      // every BK-wide stage lies inside one tap
      const int tap = k0 / C;
      const int ch0 = k0 - tap * C;
      const int shift = (tap - 1) * dilation;
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
        cp_async16(sA + r * A_LD + kc,
                   ok ? x + ((size_t)b * T_len + t) * C + ch0 + kc : x, ok);
      }
      constexpr int B_ROW = BN / V;
      for (int c = tid; c < BK * B_ROW; c += THREADS) {
        const int kr = c / B_ROW, jc = (c % B_ROW) * V;
        const int col = jc < 64 ? j0 + jc : C + j0 + (jc - 64);
        cp_async16(sB + kr * B_LD + jc, w_in + (size_t)(k0 + kr) * 2 * C + col, true);
      }
    };
    product<T, BM, false>(smem, 3 * C, nullptr, 0, load);

    for (int e = tid; e < BM * 64; e += THREADS) {
      const int r = e / 64, j = e % 64;
      const int row = m0 + r;
      float g = 0.f;
      if (row < M) {
        const T* c_row = cond + (size_t)row * 2 * C;
        const float a_t = sC[r * C_LD + j] + to_f(b_in[j0 + j]) + to_f(c_row[j0 + j]);
        const float a_s = sC[r * C_LD + 64 + j] + to_f(b_in[C + j0 + j])
                          + to_f(c_row[C + j0 + j]);
        g = tanhf(a_t) * (1.f / (1.f + expf(-a_s)));
      }
      gate[r * g_ld + j0 + j] = from_f<T>(g);
    }
    __syncthreads();     // the next pass refills the ring under sC
  }

  // 2. rs = gated @ w_rs + b_rs, 128 columns a pass, A read from the gate tile
  const int skip_ch = residual ? N - C : N;
  const int skip0 = residual ? C : 0;
  for (int n0 = 0; n0 < N; n0 += BN) {
    auto load = [&](T*, T* sB, int k0) {
      constexpr int B_ROW = BN / V;
      for (int c = tid; c < BK * B_ROW; c += THREADS) {
        const int kr = c / B_ROW, jc = (c % B_ROW) * V;
        cp_async16(sB + kr * B_LD + jc, w_rs + (size_t)(k0 + kr) * N + n0 + jc, true);
      }
    };
    product<T, BM, true>(smem, C, gate, g_ld, load);

    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, j = e % BN;
      const int row = m0 + r;
      if (row >= M) continue;
      const int col = n0 + j;
      const float v = sC[r * C_LD + j] + to_f(b_rs[col]);
      if (residual && col < C) {
        const size_t at = (size_t)row * C + col;
        x_out[at] = from_f<T>(to_f(x[at]) + v);
      } else {
        skip[(size_t)row * skip_ch + col - skip0] = from_f<T>(v);
      }
    }
    __syncthreads();
  }
}

int run_layer_f32(const void* x, const void* cond, const void* w_in, const void* b_in,
                  const void* w_rs, const void* b_rs, void* x_out, void* skip, int B,
                  int T_len, int C, int N, int dilation, int residual, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wn_layer_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<float>(MAX_C));
  if (err != cudaSuccess) return (int)err;
  const int M = B * T_len;
  const dim3 grid((M + BM - 1) / BM);
  wn_layer_kernel<float><<<grid, THREADS, smem_bytes<float>(C), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(cond),
      static_cast<const float*>(w_in), static_cast<const float*>(b_in),
      static_cast<const float*>(w_rs), static_cast<const float*>(b_rs),
      static_cast<float*>(x_out), static_cast<float*>(skip), M, T_len, C, N, dilation, residual);
  return (int)cudaGetLastError();
}

namespace sm90 {

// -1: the CUDA driver refused a tensor map (alignment or strides)
int run_layer(const void* x, const void* cond, const void* w_in, const void* b_in,
              const void* w_rs, const void* b_rs, void* x_out, void* skip, void* gated,
              int B, int T_len, int C, int N, int dilation, int residual, cudaStream_t stream) {
  const auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap m_x, m_c, m_xo, m_g, m_skip, m_in, m_rs;
  if (!hop::make_map(&m_x, BF16, 2, x, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_c, BF16, 2, cond, 2 * C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_xo, BF16, 2, residual ? x_out : x, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_g, BF16, 2, gated, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_skip, BF16, 2, skip, C, T_len, B, BK, BM, true) ||
      !hop::make_map(&m_in, BF16, 2, w_in, 2 * C, 3 * C, 1, 64, BK, true) ||
      !hop::make_map(&m_rs, BF16, 2, w_rs, N, C, 1, 64, BK, true))
    return -1;
  const int in_smem = smem_bytes(IN_CHUNKS, IN_COND_EXTRA, IN_COND_STAGES);
  const int rs_smem = smem_bytes(RS_CHUNKS, RS_EXTRA);
  cudaError_t err = cudaFuncSetAttribute(
      wn_in_wgmma<bf16, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, in_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wn_rs_wgmma<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rs_smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = B * ((T_len + BM - 1) / BM);
  const auto grid = [&](int tiles) { return tiles < sms ? tiles : sms; };
  // S = 0: no mel segment; the map in its place is never read
  wn_in_wgmma<bf16, true><<<grid(row_tiles * (C / 128)), THREADS, in_smem, stream>>>(
      m_x, m_x, m_in, m_c, static_cast<const bf16*>(b_in), static_cast<bf16*>(gated), B, T_len,
      C, 0, 0, dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // every skip tile is written in bf16 from rs alone (first, skip_out); the
  // f32 skip map in its place is never read or written
  wn_rs_wgmma<bf16><<<grid(row_tiles * (N / 128)), THREADS, rs_smem, stream>>>(
      m_g, m_rs, m_x, m_xo, m_x, m_skip, static_cast<const bf16*>(b_rs), B, T_len, C, N, 0,
      1, residual, 1);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// x (B, T, C), cond (B, T, 2C), w_in (3, C, 2C), b_in (2C), w_rs (C, N),
// b_rs (N), all in one dtype (bf16 when is_bf16, else f32), contiguous and
// 16-byte aligned.  N = 2C with `residual` (x_out (B, T, C) receives x + rs[:, :C],
// skip (B, T, C) rs[:, C:]), N = C without (skip (B, T, C) receives rs; x_out
// is not written).  gated (B, T, C, bf16) is the bf16 path's scratch.
// Requires C % 128 == 0 and C <= 512.  Returns the CUDA error code of the
// launches (0 on success), or -1 when the CUDA driver refuses a tensor map.
extern "C" int wn_layer_forward(int is_bf16, const void* x, const void* cond,
                                const void* w_in, const void* b_in,
                                const void* w_rs, const void* b_rs,
                                void* x_out, void* skip, void* gated, int B, int T_len,
                                int C, int N, int dilation, int residual, void* stream) {
  if (C % 128 != 0 || C > MAX_C || N != (residual ? 2 * C : C) || dilation < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return sm90::run_layer(x, cond, w_in, b_in, w_rs, b_rs, x_out, skip, gated, B, T_len, C,
                           N, dilation, residual, (cudaStream_t)stream);
  return run_layer_f32(x, cond, w_in, b_in, w_rs, b_rs, x_out, skip, B, T_len, C, N,
                       dilation, residual, (cudaStream_t)stream);
}
