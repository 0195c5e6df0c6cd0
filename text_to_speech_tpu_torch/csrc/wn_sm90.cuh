// The WN layer's two GEMMs for Hopper (sm_90a), shared by the whole-block
// kernel K1 (wn_block.cu, bf16) and the one-layer kernel K4 (wn_layer.cu,
// bf16): warp-specialised wgmma kernels on a persistent grid, fed by TMA.
// wn_block.cu's header describes the design; what the two kernels differ
// in is a template argument or a runtime flag here:
//
//                      K1 (wn_block)                  K4 (wn_layer)
//   in-GEMM K          3C + S (the mel segment)       3C (S = 0)
//   in-epilogue        f32 bias b_in + b_cond         b_in (bf16) + cond[row, j],
//                                                     cond[row, C + j] (bf16), in f32
//   rs residual        x updated in place             x_out = x + rs[:, :C], a new tensor
//   rs skip columns    f32 skip sum; the last layer   skip = rs in bf16, every layer
//                      writes the output
//   dilations          2^i <= 128                     any >= 1 (TMA zero-fills boxes
//                                                     wholly outside [0, T) too)

#pragma once

#include "wn_wgmma.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
// K4's in-GEMM: a 64 KB staging tile for cond beside a 3-stage ring
constexpr int IN_COND_STAGES = 3, IN_COND_EXTRA = 4 * BOX;
constexpr int smem_bytes(int chunks, int extra, int stages = STAGES) {
  return stages * (A_BYTES + chunks * CHUNK) + extra + 1024 + (2 * stages + 2) * 8;
}

// the ring of stages (1024-byte aligned for the swizzle), `extra` bytes
// of staging tiles behind it, and the barriers: full[s] completes when
// stage s has landed, empty[s] when the consumers are done with it;
// e_full / e_empty do the same for the staging tile.  NST stages.
template <int CHUNKS, int NST = STAGES>
struct Ring {
  static constexpr int STAGE = A_BYTES + CHUNKS * CHUNK;
  unsigned char* base;
  unsigned char* extra;
  uint64_t *full, *empty, *e_full, *e_empty;
  __device__ unsigned char* a(int s) const { return base + s * STAGE; }
  __device__ unsigned char* b(int s) const { return base + s * STAGE + A_BYTES; }
};

// e_empty completes on `e_arrivals` arrivals
template <int CHUNKS, int NST = STAGES>
__device__ __forceinline__ Ring<CHUNKS, NST> make_ring(unsigned char* smem, int extra,
                                                       int e_arrivals = 1) {
  Ring<CHUNKS, NST> r;
  r.base = smem + ((1024 - (hop::smem_u32(smem) & 1023)) & 1023);
  r.extra = r.base + NST * Ring<CHUNKS, NST>::STAGE;
  r.full = reinterpret_cast<uint64_t*>(r.extra + extra);
  r.empty = r.full + NST;
  r.e_full = r.empty + NST;
  r.e_empty = r.e_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hop::mbar_init(&r.full[s], 1);
      hop::mbar_init(&r.empty[s], 8);       // lane 0 of each consumer warp
    }
    hop::mbar_init(r.e_full, 1);
    hop::mbar_init(r.e_empty, e_arrivals);
    hop::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// One tile's stages from the producer thread, ring steps it0 .. it0 + nk - 1:
// stage kb gets A from `load_a(dst, bar, kb)` and the weight boxes at
// columns n[q], k row k_of(kb), of `layer`.
template <int CHUNKS, int NST, typename LoadA, typename KOf>
__device__ __forceinline__ void produce(const Ring<CHUNKS, NST>& r, int it0, int nk,
                                        const CUtensorMap* map_w, const int (&n)[CHUNKS],
                                        int layer, LoadA load_a, KOf k_of) {
  for (int kb = 0; kb < nk; ++kb) {
    const int it = it0 + kb, s = it % NST;
    hop::mbar_wait(&r.empty[s], ((it / NST) & 1) ^ 1);
    hop::mbar_expect_tx(&r.full[s], Ring<CHUNKS, NST>::STAGE);
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
template <int CHUNKS, int NST>
__device__ __forceinline__ void consume(const Ring<CHUNKS, NST>& r, int it0, int nk, int wg,
                                        float (&acc)[32 * CHUNKS]) {
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < nk; ++kb) {
    const int it = it0 + kb, s = it % NST;
    hop::mbar_wait(&r.full[s], (it / NST) & 1);
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
      if (lane == 0) hop::mbar_arrive(&r.empty[(it - 1) % NST]);
    }
  }
  hop::wgmma_wait<0>();
  if (lane == 0) hop::mbar_arrive(&r.empty[(it0 + nk - 1) % NST]);
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

// two neighbouring values of a bias or of cond, as f32
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Layer `layer`, first GEMM, with the gate in the epilogue.  A tile is
// rows [t0, t0 + 128) of batch row b and gated columns [128 n, +128).  The
// grid is persistent: block i takes tiles i, i + gridDim.x, ..., and the
// producer runs on into the next tile while the consumers finish one.  The
// gated pairs go to memory straight from registers (staging them for a TMA
// store made ptxas spill here and cost 10 us a layer on an H100).
// BiasT is the bias's type (K1: f32 b_in + b_cond; K4: b_in in bf16); with
// COND (K4) the epilogue adds cond (B, T, 2C, bf16) after the bias: the
// producer loads the tile's four cond boxes (its tanh and sigmoid columns)
// into a staging tile by TMA behind the tile's stages, so they land while
// the last products run, and the ring keeps 3 stages to make room (plain
// loads at the fragment's positions were slower on an H100).
// S = 0 drops the mel segment.
template <typename BiasT, bool COND>
__global__ void __launch_bounds__(THREADS, 1)
wn_in_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_sp,
            const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_c,
            const BiasT* __restrict__ bias, bf16* __restrict__ gated, int B, int T_len, int C,
            int S, int layer, int dilation) {
  constexpr int NST = COND ? IN_COND_STAGES : STAGES;
  extern __shared__ unsigned char smem[];
  const Ring<IN_CHUNKS, NST> r =
      make_ring<IN_CHUNKS, NST>(smem, COND ? IN_COND_EXTRA : 0, COND ? 8 : 1);
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
      int it = 0, ti = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk, ++ti) {
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
        if constexpr (COND) {
          // the cond tile, once the previous tile's epilogue has read it
          hop::mbar_wait(r.e_empty, (ti & 1) ^ 1);
          hop::mbar_expect_tx(r.e_full, 4 * BOX);
          for (int q = 0; q < 4; ++q)
            hop::tma_load(r.extra + q * BOX, &map_c, r.e_full, n[q], tl.t0, tl.b);
        }
      }
    }
  } else {
    hop::regs_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += nk, ++ti) {
      const Tile tl(tile, T_len, row_tiles);
      const int n0 = tl.n * 128;
      float acc[128];
      consume(r, it, nk, wg - 1, acc);
      if constexpr (COND) hop::mbar_wait(r.e_full, ti & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg - 1) * 64 + warp * 16 + g + 8 * h;
        const int t = tl.t0 + row;
        if (t >= T_len) continue;
        bf16* out = gated + ((size_t)tl.b * T_len + t) * C + n0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = 8 * j + 2 * tq;
          const float2 bt = pair(bias + n0 + n);
          const float2 bs = pair(bias + C + n0 + n);
          float a_t0 = acc[4 * j + 2 * h] + bt.x, a_t1 = acc[4 * j + 2 * h + 1] + bt.y;
          float a_s0 = acc[64 + 4 * j + 2 * h] + bs.x, a_s1 = acc[64 + 4 * j + 2 * h + 1] + bs.y;
          if constexpr (COND) {
            const float2 ct = pair(reinterpret_cast<const bf16*>(r.extra + staged<bf16>(row, n)));
            const float2 cs =
                pair(reinterpret_cast<const bf16*>(r.extra + 2 * BOX + staged<bf16>(row, n)));
            a_t0 += ct.x; a_t1 += ct.y; a_s0 += cs.x; a_s1 += cs.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + n) =
              __floats2bfloat162_rn(gate(a_t0, a_s0), gate(a_t1, a_s1));
        }
      }
      if constexpr (COND) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(r.e_empty);
      }
    }
  }
}

// Layer `layer`, second GEMM: rs = gated @ w_rs + b_rs, with the residual
// and skip outputs in the epilogue.  A tile is rows [t0, t0 + 128) of batch
// row b and rs columns [128 n, +128) of N: residual columns (only with
// `residual_layer`: x_out = x + rs, where K1 passes x's own map as map_xo
// and K4 a new tensor's) or skip columns, never both, as C % 128 == 0.  The
// skip columns either add to the f32 skip sum (K1's layers before the last;
// from zero with `first`), or, with `skip_out`, go to map_out in bf16 (K1's
// last layer: the sum plus rs; K4: rs alone, `first` set).  Persistent as
// above.  The producer loads the tile's x or skip sum into the staging tile
// by TMA behind its stages, so it lands while the products run; the
// consumers add to it there and one TMA store writes it back (x and the
// skip sum in place; the output from a second tile).
template <typename BiasT>
__global__ void __launch_bounds__(THREADS, 1)
wn_rs_wgmma(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_xo,
            const __grid_constant__ CUtensorMap map_skip,
            const __grid_constant__ CUtensorMap map_out, const BiasT* __restrict__ bias,
            int B, int T_len, int C, int N, int layer, int first, int residual_layer,
            int skip_out) {
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
        if (residual_layer && n0 < C) {
          hop::mbar_expect_tx(r.e_full, 2 * BOX);
          for (int q = 0; q < 2; ++q)
            hop::tma_load(stage_e + q * BOX, &map_x, r.e_full, n0 + 64 * q, tl.t0, tl.b);
        } else if (!first) {
          hop::mbar_expect_tx(r.e_full, 4 * BOX);
          const int c0 = residual_layer ? n0 - C : n0;
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
      const bool residual = residual_layer && n0 < C;
      float acc[64];
      consume(r, it, nk, wg - 1, acc);
      hop::mbar_wait(r.e_full, ti & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg - 1) * 64 + warp * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = 8 * j + 2 * tq;
          const float2 bv = pair(bias + n0 + n);
          const float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
          if (residual) {
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(stage_e + staged<bf16>(row, n));
            const float2 old = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(old.x + v0, old.y + v1);
          } else {
            float2* p = reinterpret_cast<float2*>(stage_e + staged<float>(row, n));
            const float2 old = first ? make_float2(0.f, 0.f) : *p;
            if (skip_out) {
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
        const int c0 = residual_layer ? n0 - C : n0;
        if (residual) {
          for (int q = 0; q < 2; ++q)
            hop::tma_store(&map_xo, stage_e + q * BOX, n0 + 64 * q, tl.t0, tl.b);
        } else if (skip_out) {
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

}  // namespace sm90

}  // namespace
