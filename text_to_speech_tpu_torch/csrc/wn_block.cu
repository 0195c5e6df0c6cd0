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
// bf16 (the serving and wn_train_fused path), `sm90::` below: warp-specialised
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

#include "wn_tile.cuh"
#include "wn_wgmma.cuh"

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

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                     // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;                      // k a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;                // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;        // 16 KB
constexpr int CHUNK = 64 * BK * 2;          // one 64-column weight box, 8 KB
constexpr int BOX = BM * 128;               // one 128-byte-wide box of a tile's rows, 16 KB
// in: 128 x 256 accumulator tiles (four weight chunks); rs: 128 x 128 (two
// chunks), a 64 KB staging tile for x or the skip sum and 32 KB for the
// output
constexpr int IN_CHUNKS = 4, RS_CHUNKS = 2;
constexpr int RS_EXTRA = 6 * BOX;
constexpr int smem_bytes(int chunks, int extra) {
  return STAGES * (A_BYTES + chunks * CHUNK) + extra + 1024 + (2 * STAGES + 2) * 8;
}

// the ring of stages (1024-byte aligned for the swizzle), `extra` bytes
// of staging tiles behind it, and the barriers: full[s] completes when
// stage s has landed, empty[s] when the consumers are done with it;
// e_full / e_empty do the same for the staging tile
template <int CHUNKS>
struct Ring {
  static constexpr int STAGE = A_BYTES + CHUNKS * CHUNK;
  unsigned char* base;
  unsigned char* extra;
  uint64_t *full, *empty, *e_full, *e_empty;
  __device__ unsigned char* a(int s) const { return base + s * STAGE; }
  __device__ unsigned char* b(int s) const { return base + s * STAGE + A_BYTES; }
};

template <int CHUNKS>
__device__ __forceinline__ Ring<CHUNKS> make_ring(unsigned char* smem, int extra) {
  Ring<CHUNKS> r;
  r.base = smem + ((1024 - (hop::smem_u32(smem) & 1023)) & 1023);
  r.extra = r.base + STAGES * Ring<CHUNKS>::STAGE;
  r.full = reinterpret_cast<uint64_t*>(r.extra + extra);
  r.empty = r.full + STAGES;
  r.e_full = r.empty + STAGES;
  r.e_empty = r.e_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&r.full[s], 1);
      hop::mbar_init(&r.empty[s], 8);       // lane 0 of each consumer warp
    }
    hop::mbar_init(r.e_full, 1);
    hop::mbar_init(r.e_empty, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// One tile's stages from the producer thread, ring steps it0 .. it0 + nk - 1:
// stage kb gets A from `load_a(dst, bar, kb)` and the weight boxes at
// columns n[q], k row k_of(kb), of `layer`.
template <int CHUNKS, typename LoadA, typename KOf>
__device__ __forceinline__ void produce(const Ring<CHUNKS>& r, int it0, int nk,
                                        const CUtensorMap* map_w, const int (&n)[CHUNKS],
                                        int layer, LoadA load_a, KOf k_of) {
  for (int kb = 0; kb < nk; ++kb) {
    const int it = it0 + kb, s = it % STAGES;
    hop::mbar_wait(&r.empty[s], ((it / STAGES) & 1) ^ 1);
    hop::mbar_expect_tx(&r.full[s], Ring<CHUNKS>::STAGE);
    load_a(r.a(s), &r.full[s], kb);
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q)
      hop::tma_load(r.b(s) + q * CHUNK, map_w, &r.full[s], n[q], k_of(kb), layer);
  }
}

// A consumer warpgroup's product: rows [64 wg, +64) of the tile times all
// 64 CHUNKS columns, over ring steps it0 .. it0 + nk - 1, into acc.  One
// stage's products stay in flight while the next stage's are issued; a
// stage goes back to the producer once its products have completed.
template <int CHUNKS>
__device__ __forceinline__ void consume(const Ring<CHUNKS>& r, int it0, int nk, int wg,
                                        float (&acc)[32 * CHUNKS]) {
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < nk; ++kb) {
    const int it = it0 + kb, s = it % STAGES;
    hop::mbar_wait(&r.full[s], (it / STAGES) & 1);
    const unsigned char* a = r.a(s) + wg * 64 * 128;
    const unsigned char* b = r.b(s);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = hop::desc_sw128(a + 32 * k, 16, 1024);
      const uint64_t db = hop::desc_sw128(b + 2048 * k, CHUNK, 1024);
      if constexpr (CHUNKS == 4) hop::wgmma_bf16_n256(acc, da, db, kb > 0 || k > 0);
      else hop::wgmma_bf16_n128(acc, da, db, kb > 0 || k > 0);
    }
    hop::wgmma_commit();
    if (kb > 0) {
      hop::wgmma_wait<1>();
      if (lane == 0) hop::mbar_arrive(&r.empty[(it - 1) % STAGES]);
    }
  }
  hop::wgmma_wait<0>();
  if (lane == 0) hop::mbar_arrive(&r.empty[(it0 + nk - 1) % STAGES]);
  hop::fence_regs(acc);
}

// Tile `tile` of a GEMM whose row tiles run fastest (so the blocks at work
// at one time share their weight columns): batch row b, first time step
// t0, column tile n.
struct Tile {
  int b, t0, n;
  __device__ Tile(int tile, int T_len, int row_tiles) {
    const int tiles_t = (T_len + BM - 1) / BM, m = tile % row_tiles;
    n = tile / row_tiles;
    b = m / tiles_t;
    t0 = (m % tiles_t) * BM;
  }
};

// Byte offset of element (row, col) in a staging tile of 128-byte-wide
// boxes of BM rows, 128-byte swizzled as TMA reads and writes them.
template <typename E>
__device__ __forceinline__ int staged(int row, int col) {
  constexpr int PER = 128 / sizeof(E);      // elements a box row
  const int byte = (col % PER) * (int)sizeof(E);
  return (col / PER) * BOX + row * 128 + ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15);
}

__device__ __forceinline__ float gate(float a_t, float a_s) {
  return tanhf(a_t) * (1.f / (1.f + expf(-a_s)));
}

// Layer `layer`, first GEMM, with the gate in the epilogue.  A tile is
// rows [t0, t0 + 128) of batch row b and gated columns [128 n, +128).  The
// grid is persistent: block i takes tiles i, i + gridDim.x, ..., and the
// producer runs on into the next tile while the consumers finish one.  The
// gated pairs go to memory straight from registers (staging them for a TMA
// store made ptxas spill here and cost 10 us a layer on an H100).
__global__ void __launch_bounds__(THREADS, 1)
wn_in_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_sp,
            const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
            bf16* __restrict__ gated, int B, int T_len, int C, int S, int layer, int dilation) {
  extern __shared__ unsigned char smem[];
  const Ring<IN_CHUNKS> r = make_ring<IN_CHUNKS>(smem, 0);
  const int row_tiles = B * ((T_len + BM - 1) / BM);
  const int n_tiles = row_tiles * (C / 128);
  const int kb_tap = C / BK;
  const int nk = 3 * kb_tap + (S + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&map_x);
      hop::prefetch_map(&map_sp);
      hop::prefetch_map(&map_w);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk) {
        const Tile tl(tile, T_len, row_tiles);
        const int n0 = tl.n * 128;
        const int n[4] = {n0, n0 + 64, C + n0, C + n0 + 64};
        produce(r, it, nk, &map_w, n, layer,
                [&](unsigned char* dst, uint64_t* bar, int kb) {
                  if (kb < 3 * kb_tap) {
                    const int tap = kb / kb_tap;
                    hop::tma_load(dst, &map_x, bar, (kb - tap * kb_tap) * BK,
                                  tl.t0 + (tap - 1) * dilation, tl.b);
                  } else {
                    hop::tma_load(dst, &map_sp, bar, (kb - 3 * kb_tap) * BK, tl.t0, tl.b);
                  }
                },
                [&](int kb) {
                  return kb < 3 * kb_tap ? kb * BK : 3 * C + (kb - 3 * kb_tap) * BK;
                });
      }
    }
  } else {
    hop::regs_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk) {
      const Tile tl(tile, T_len, row_tiles);
      const int n0 = tl.n * 128;
      float acc[128];
      consume(r, it, nk, wg - 1, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tl.t0 + (wg - 1) * 64 + warp * 16 + g + 8 * h;
        if (t >= T_len) continue;
        bf16* row = gated + ((size_t)tl.b * T_len + t) * C + n0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = 8 * j + 2 * tq;
          const float2 bt = *reinterpret_cast<const float2*>(bias + n0 + n);
          const float2 bs = *reinterpret_cast<const float2*>(bias + C + n0 + n);
          const float g0 = gate(acc[4 * j + 2 * h] + bt.x, acc[64 + 4 * j + 2 * h] + bs.x);
          const float g1 = gate(acc[4 * j + 2 * h + 1] + bt.y, acc[64 + 4 * j + 2 * h + 1] + bs.y);
          *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(g0, g1);
        }
      }
    }
  }
}

// Layer `layer`, second GEMM: rs = gated @ w_rs + b_rs, with the residual
// update and the skip sum in the epilogue.  A tile is rows [t0, t0 + 128)
// of batch row b and rs columns [128 n, +128) of N: residual columns
// (x += rs) or skip columns (skip += rs; the last layer writes the output),
// never both, as C % 128 == 0.  Persistent as above.  The producer loads the
// tile's x or skip sum into the staging tile by TMA behind its stages, so it
// lands while the products run; the consumers add to it there and one TMA
// store writes it back (x and skip in place; the output from a second tile).
__global__ void __launch_bounds__(THREADS, 1)
wn_rs_wgmma(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_skip,
            const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bias,
            int B, int T_len, int C, int N, int layer, int first, int last) {
  extern __shared__ unsigned char smem[];
  const Ring<RS_CHUNKS> r = make_ring<RS_CHUNKS>(smem, RS_EXTRA);
  unsigned char* stage_e = r.extra;             // x (2 boxes) or the skip sum (4)
  unsigned char* stage_out = r.extra + 4 * BOX; // the output (2 boxes)
  const int row_tiles = B * ((T_len + BM - 1) / BM);
  const int n_tiles = row_tiles * (N / 128);
  const int nk = C / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&map_g);
      hop::prefetch_map(&map_w);
      int it = 0, ti = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk, ++ti) {
        const Tile tl(tile, T_len, row_tiles);
        const int n0 = tl.n * 128;
        const int n[2] = {n0, n0 + 64};
        produce(r, it, nk, &map_w, n, layer,
                [&](unsigned char* dst, uint64_t* bar, int kb) {
                  hop::tma_load(dst, &map_g, bar, kb * BK, tl.t0, tl.b);
                },
                [](int kb) { return kb * BK; });
        // the staging tile, once the previous tile's store has read it
        hop::mbar_wait(r.e_empty, (ti & 1) ^ 1);
        if (!last && n0 < C) {
          hop::mbar_expect_tx(r.e_full, 2 * BOX);
          for (int q = 0; q < 2; ++q)
            hop::tma_load(stage_e + q * BOX, &map_x, r.e_full, n0 + 64 * q, tl.t0, tl.b);
        } else if (!first) {
          hop::mbar_expect_tx(r.e_full, 4 * BOX);
          const int c0 = last ? n0 : n0 - C;
          for (int q = 0; q < 4; ++q)
            hop::tma_load(stage_e + q * BOX, &map_skip, r.e_full, c0 + 32 * q, tl.t0, tl.b);
        } else {
          hop::mbar_arrive(r.e_full);
        }
      }
    }
  } else {
    hop::regs_inc<232>();
    const int ctid = threadIdx.x - 128;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk, ++ti) {
      const Tile tl(tile, T_len, row_tiles);
      const int n0 = tl.n * 128;
      const bool residual = !last && n0 < C;
      float acc[64];
      consume(r, it, nk, wg - 1, acc);
      hop::mbar_wait(r.e_full, ti & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg - 1) * 64 + warp * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = 8 * j + 2 * tq;
          const float2 bv = *reinterpret_cast<const float2*>(bias + n0 + n);
          const float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
          if (residual) {
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(stage_e + staged<bf16>(row, n));
            const float2 old = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(old.x + v0, old.y + v1);
          } else {
            float2* p = reinterpret_cast<float2*>(stage_e + staged<float>(row, n));
            const float2 old = first ? make_float2(0.f, 0.f) : *p;
            if (last) {
              *reinterpret_cast<__nv_bfloat162*>(stage_out + staged<bf16>(row, n)) =
                  __floats2bfloat162_rn(old.x + v0, old.y + v1);
            } else {
              *p = make_float2(old.x + v0, old.y + v1);
            }
          }
        }
      }
      hop::fence_proxy_async();
      hop::bar_sync(1, 256);
      if (ctid == 0) {
        const int c0 = last ? n0 : n0 - C;
        if (residual) {
          for (int q = 0; q < 2; ++q)
            hop::tma_store(&map_x, stage_e + q * BOX, n0 + 64 * q, tl.t0, tl.b);
        } else if (last) {
          for (int q = 0; q < 2; ++q)
            hop::tma_store(&map_out, stage_out + q * BOX, c0 + 64 * q, tl.t0, tl.b);
        } else {
          for (int q = 0; q < 4; ++q)
            hop::tma_store(&map_skip, stage_e + q * BOX, c0 + 32 * q, tl.t0, tl.b);
        }
        hop::bulk_commit();
        hop::bulk_wait_read();
        hop::mbar_arrive(r.e_empty);
      }
    }
    if (ctid == 0) hop::bulk_wait();
  }
}

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
      wn_in_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, in_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wn_rs_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, rs_smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = B * ((T_len + BM - 1) / BM);
  const auto grid = [&](int tiles) { return tiles < sms ? tiles : sms; };
  for (int i = 0; i < L; ++i) {
    wn_in_wgmma<<<grid(row_tiles * (C / 128)), THREADS, in_smem, stream>>>(
        m_x, m_sp, m_in, b_in_cond + (size_t)i * 2 * C, static_cast<bf16*>(gated), B, T_len,
        C, S, i, 1 << i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool last = i == L - 1;
    const int N = last ? C : 2 * C;
    wn_rs_wgmma<<<grid(row_tiles * (N / 128)), THREADS, rs_smem, stream>>>(
        m_g, last ? m_last : m_rs, m_x, m_skip, m_out,
        last ? b_rs_last : b_rs + (size_t)i * 2 * C, B, T_len, C, N, last ? 0 : i, i == 0,
        last);
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
