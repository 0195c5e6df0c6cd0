// WaveGlow WN coupling block with int8 products, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_wn_block_int8` (text_to_speech_tpu/ops/
// pallas_kernels.py, body `_wn_block_int8_kernel`).  It computes the same
// function as `wn_block_int8_reference` there: for each of the L layers i,
//
//   qx, sx = rowquant(x)                 (per time step: scale = max(amax, 1e-8)
//                                          / 127, q = clip(rint(x / scale)))
//   acc    = sum over taps k of int32(qx[t + k] . w_in[i, k]) * sx[t + k]
//   acts   = acc * s_in + int32(qspect . w_cond[i]) * sspect * s_cond + b
//   gated  = tanh(acts[:, :C]) * sigmoid(acts[:, C:])
//   qg, sg = rowquant(gated)             (or qg = clip(rint(127 gated)) and
//                                          s_rs / 127 with static_gate_scale)
//   rs     = int32(qg . w_rs[i]) * sg * s_rs + b_rs
//   x     += rs[:, :C]  (the true stream, stored in T; the next layer
//                        quantizes the f32 sum)
//   skip  += rs[:, C:]  (f32; the last layer's rs is all skip)
//
// and returns skip in T (float or bf16).  Rows outside [0, T) read as q = 0
// with scale 0, which is the per-layer SAME padding of the reference.
// Every scale product and sum is written with __fmul_rn / __fadd_rn, in the
// reference's order, so that nvcc cannot contract it into an FMA: the plain
// version then agrees to the bit up to tanhf / expf, whose last-place
// differences can flip a rounding tie of the gate's quantization.
//
// Design: 2L + 2 launches a block (18 at L = 8), every row quantization
// after the first inside a GEMM.
//   row_quant (twice a call): the mel and the first layer's x; one warp a
//     row, int8 and one f32 scale.  The x launch also clears the first
//     gate-amax buffer.
//   in_wgmma (a layer): M = B*T rows, N = 2C, K = 3C + S in four segments
//     (three taps, the mel), on wgmma m64n128k32 s8 with i32 accumulators,
//     128 x 128 tiles on a persistent grid.  The producer thread streams the
//     im2col A tile by TMA from the 3-D map of qx (C, T, B) at time
//     coordinate t0 + (k-1) d, zero-filled outside [0, T) (the scale there
//     reads as 0 too), the mel from its own map, and the K-major weights
//     (L, 2C, 3C + S) as two 64-row boxes (gated columns [n0, +64) and their
//     sigmoid partners), so the gate runs in registers.  The taps alternate
//     between two i32 accumulators: a tap's sums are added, times its rows'
//     scale, into the f32 sum once the next segment's first products are
//     in flight, so no tap boundary drains the wgmma pipeline (draining
//     cost 19 of 73 us a layer on an H100).  The taps are unrolled for
//     C / 128 = 1 .. 4 stages each: with runtime trip counts ptxas could
//     not follow the groups and serialized every wgmma (C7514).  The
//     epilogue writes the f32 gate and one atomicMax a row (on the bits of
//     |gate|, which order like the values) into the layer's amax buffer,
//     and clears the other buffer, which the previous layer's rs_wgmma read
//     last; with the static gate scale it writes the int8 gate.
//   rs_wgmma (a layer): one block owns 64 rows and all N columns.  It
//     quantizes the f32 gate tile (TMA through the ring) with the row amax
//     into an int8 A tile that stays in shared memory (or TMA-loads the int8
//     gate there), then streams the K-major weights (N, C) through the ring
//     in 256-column pairs, one 128-column chunk a consumer warpgroup.  First
//     the C residual columns: x += rs from registers, each row's amax over
//     all C columns across both warpgroups, and the next layer's qx and sx
//     written directly; then the skip columns.  No f32 x and no separate x
//     pass remain.  The residual chunks stay in registers until the row
//     amax is known: at most two a warpgroup, so C <= 512.
// x's row scales are read from sx by the consumers rather than by TMA: a
// (T, B) f32 map needs T % 4 == 0 (16-byte strides), and the kernel takes
// any length.
//
// Bound on an H100 SXM: per grouped row a block takes
//   2 * ((3C + S) * 2C * L + C * 2C * (L - 1) + C * C)
// int8 operations, 43.5 M at C = 512, S = 640, L = 8; 356 G for a 256-frame
// utterance (T = 8192), 0.18 ms at 1979 TOP/s dense int8.  Its bytes (22 MB
// of int8 weights, 27 MB of bf16 x, mel and output) take 0.015 ms at
// 3.35 TB/s: the block is bound by operations.  As in wn_block.cu, L2
// stands in the way: the 128 x 128 in_wgmma tiles (two i32 and one f32
// accumulator fill the registers at n128) and the per-block weight stream
// of rs_wgmma move about 3.5 GB a block at T = 8192 (`l2_bytes` in
// ops/wn_block_int8.py).

#include "wn_wgmma.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int ROWS_PER_BLOCK = 8;   // row_quant: one warp a row
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// Pairs of the stream and of the skip sum, which a thread reads and then
// writes in place: read through L2 only (ld.global.cg).  A default load
// followed by a store to the same line stalled the epilogues about tenfold
// on an H100.
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// round half to even, clip to [-127, 127]
__device__ __forceinline__ int quant(float v) {
  return max(-127, min(127, __float2int_rn(v)));
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, EPS), 127.f);
}

// ---- per-row quantization ------------------------------------------------------

// q[row] = clip(rint(src[row] / s)), s = max(amax(|src[row]|), 1e-8) / 127;
// one warp per row of W values (W % 4 == 0).  `clear` (or null): a buffer
// of M values set to 0.
template <typename Src>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
row_quant(const Src* __restrict__ src, int M, int W, int8_t* __restrict__ q,
          float* __restrict__ scale, unsigned* __restrict__ clear) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const Src* r = src + (size_t)row * W;
  float amax = 0.f;
  for (int k = lane * 4; k < W; k += 128) {
    const float4 v = load4(r + k);
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = row_scale(amax);
  for (int k = lane * 4; k < W; k += 128) {
    const float4 v = load4(r + k);
    const char4 c = make_char4(quant(__fdiv_rn(v.x, s)), quant(__fdiv_rn(v.y, s)),
                               quant(__fdiv_rn(v.z, s)), quant(__fdiv_rn(v.w, s)));
    *reinterpret_cast<char4*>(q + (size_t)row * W + k) = c;
  }
  if (lane == 0) {
    scale[row] = s;
    if (clear != nullptr) clear[row] = 0u;
  }
}

// ---- the ring -------------------------------------------------------------------

// `stages` slots of `slot` bytes (1024-byte aligned) with their full /
// empty barriers, then `extra` bytes for the kernel (1024-byte aligned)
struct Ring {
  unsigned char* base;
  unsigned char* extra;
  uint64_t* full;
  uint64_t* empty;
  int slot, stages;
  __device__ unsigned char* at(int s) const { return base + s * slot; }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem, int slot, int stages, int extra) {
  Ring r;
  r.slot = slot;
  r.stages = stages;
  r.base = smem + ((1024 - (hop::smem_u32(smem) & 1023)) & 1023);
  r.extra = r.base + stages * slot;
  r.full = reinterpret_cast<uint64_t*>(r.extra + extra);
  r.empty = r.full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&r.full[s], 1);
      hop::mbar_init(&r.empty[s], 8);       // lane 0 of each consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// step n of the ring: its slot and the parity of its round
__device__ __forceinline__ int slot_of(const Ring& r, int n) { return n % r.stages; }
__device__ __forceinline__ uint32_t parity_of(const Ring& r, int n) {
  return (n / r.stages) & 1;
}

// ---- layer i, first product: in_wgmma --------------------------------------------

namespace in8 {
constexpr int BM = 128;               // rows: two consumer warpgroups of 64
constexpr int BK = 128;               // k a stage: one 128-byte swizzle row of int8
constexpr int A_BYTES = BM * BK;      // 16 KB
constexpr int B_BYTES = 128 * BK;     // 128 columns: two 64-row boxes of 8 KB
constexpr int SLOT = A_BYTES + B_BYTES;
constexpr int STAGES = 6;
constexpr int SMEM_BYTES = STAGES * SLOT + 1024 + 2 * STAGES * 8;
}  // namespace in8

// A tile is rows [t0, t0 + 128) of batch row b and gate columns [64 n, +64):
// acts columns [64 n, +64) (tile columns 0..63) and [C + 64 n, +64)
// (64..127).  Row tiles run fastest, so the blocks at work at one time
// share their weight columns.  The grid is persistent: block i takes tiles
// i, i + gridDim.x, ..., and the producer runs on into the next tile while
// the consumers finish one.
template <bool STATIC_GATE, int KB_TAP>
__global__ void __launch_bounds__(THREADS, 1)
in_wgmma(const __grid_constant__ CUtensorMap map_xq, const __grid_constant__ CUtensorMap map_spq,
         const __grid_constant__ CUtensorMap map_w, const float* __restrict__ sx,
         const float* __restrict__ ssp, const float* __restrict__ s_in,
         const float* __restrict__ s_cond, const float* __restrict__ bias,
         float* __restrict__ gated, int8_t* __restrict__ gq, unsigned* __restrict__ amax,
         unsigned* __restrict__ amax_clear, int B, int T_len, int C, int S, int layer,
         int dilation) {
  using namespace in8;
  extern __shared__ unsigned char smem[];
  const Ring r = make_ring(smem, SLOT, STAGES, 0);
  const int tiles_t = (T_len + BM - 1) / BM, row_tiles = B * tiles_t;
  const int n_tiles = row_tiles * (C / 64);
  const int kb_tap = KB_TAP;           // C / BK
  const int nk = 3 * kb_tap + (S + BK - 1) / BK;
  const int role = threadIdx.x / 128;
  if (role == 0) {
    hop::regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&map_xq);
      hop::prefetch_map(&map_spq);
      hop::prefetch_map(&map_w);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m = tile % row_tiles, n0 = tile / row_tiles * 64;
        const int b = m / tiles_t, t0 = m % tiles_t * BM;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = slot_of(r, it);
          hop::mbar_wait(&r.empty[s], parity_of(r, it) ^ 1);
          hop::mbar_expect_tx(&r.full[s], SLOT);
          int k0;
          if (kb < 3 * kb_tap) {
            const int tap = kb / kb_tap;
            k0 = kb * BK;
            hop::tma_load(r.at(s), &map_xq, &r.full[s], k0 - tap * C, t0 + (tap - 1) * dilation,
                          b);
          } else {
            k0 = 3 * C + (kb - 3 * kb_tap) * BK;
            hop::tma_load(r.at(s), &map_spq, &r.full[s], k0 - 3 * C, t0, b);
          }
          hop::tma_load(r.at(s) + A_BYTES, &map_w, &r.full[s], k0, n0, layer);
          hop::tma_load(r.at(s) + A_BYTES + B_BYTES / 2, &map_w, &r.full[s], k0, C + n0, layer);
        }
      }
    }
    return;
  }
  hop::regs_inc<232>();
  const int wg = role - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m = tile % row_tiles, n0 = tile / row_tiles * 64;
    const int b = m / tiles_t, t0 = m % tiles_t * BM;
    // this thread's two rows: tile rows 64 wg + 16 warp + g (+ 8)
    int t_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) t_row[h] = t0 + wg * 64 + warp * 16 + g + 8 * h;

    // The taps alternate between two i32 accumulators (taps 0 and 2 in
    // acc0, tap 1 and then the mel in acc1).  Each stage's products stay in
    // flight while the next stage's are issued; a tap's sums are added,
    // times its rows' scale (read when the tap starts), into the f32 sum
    // once the next segment's first products are issued and the tap's have
    // completed, so no segment boundary drains the pipeline.  The taps are
    // unrolled (KB_TAP stages each) so that ptxas can follow the groups.
    int acc0[64], acc1[64];
    float facc[64], sc[3][2];
#pragma unroll
    for (int e = 0; e < 64; ++e) facc[e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t_row[h] + (tap - 1) * dilation;
        sc[tap][h] = t >= 0 && t < T_len ? sx[(size_t)b * T_len + t] : 0.f;
      }
    const int it0 = it;
    // one stage of products into acc; then the previous stage goes back
    auto stage = [&](int (&acc)[64], bool restart) {
      const int s = slot_of(r, it);
      hop::mbar_wait(&r.full[s], parity_of(r, it));
      const unsigned char* a = r.at(s) + wg * 64 * 128;
      const unsigned char* bt = r.at(s) + A_BYTES;
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)
        hop::wgmma_s8_n128(acc, hop::desc_sw128(a + 32 * k, 16, 1024),
                           hop::desc_sw128(bt + 32 * k, 16, 1024), !(restart && k == 0));
      hop::wgmma_commit();
      if (it > it0) {
        hop::wgmma_wait<1>();
        if (lane == 0) hop::mbar_arrive(&r.empty[slot_of(r, it - 1)]);
      }
      ++it;
    };
    // in_acc += float(prev) * (row scale of tap `tap`), prev's products done
    auto fold = [&](int (&prev)[64], int tap) {
      hop::fence_regs(prev);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * h + c;
            facc[e] = __fadd_rn(facc[e], __fmul_rn(__int2float_rn(prev[e]), sc[tap][h]));
          }
    };
#pragma unroll
    for (int k = 0; k < KB_TAP; ++k) stage(acc0, k == 0);
#pragma unroll
    for (int k = 0; k < KB_TAP; ++k) {
      stage(acc1, k == 0);
      if (k == 0) fold(acc0, 0);
    }
#pragma unroll
    for (int k = 0; k < KB_TAP; ++k) {
      stage(acc0, k == 0);
      if (k == 0) fold(acc1, 1);
    }
    stage(acc1, true);
    fold(acc0, 2);
    for (int kb = 3 * KB_TAP + 1; kb < nk; ++kb) stage(acc1, false);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc1);
    if (lane == 0) hop::mbar_arrive(&r.empty[slot_of(r, it - 1)]);
    int (&acc)[64] = acc1;

    // acc holds the mel's products
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // every lane runs the row-max shuffles; only rows inside [0, T) store
      const bool valid = t_row[h] < T_len;
      const size_t row = (size_t)b * T_len + t_row[h];
      const float s_sp = valid ? ssp[row] : 0.f;
      float mx = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        float gv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * h + c, jn = n + c;
          const float a_t = __fadd_rn(
              __fadd_rn(__fmul_rn(facc[e], s_in[jn]),
                        __fmul_rn(__fmul_rn(__int2float_rn(acc[e]), s_sp), s_cond[jn])),
              bias[jn]);
          const float a_s = __fadd_rn(
              __fadd_rn(__fmul_rn(facc[32 + e], s_in[C + jn]),
                        __fmul_rn(__fmul_rn(__int2float_rn(acc[32 + e]), s_sp), s_cond[C + jn])),
              bias[C + jn]);
          gv[c] = __fmul_rn(tanhf(a_t), 1.f / (1.f + expf(-a_s)));
          mx = fmaxf(mx, fabsf(gv[c]));
        }
        const size_t at = row * C + n;
        if (!valid) continue;
        if (STATIC_GATE) {
          *reinterpret_cast<char2*>(gq + at) =
              make_char2(quant(__fmul_rn(gv[0], 127.f)), quant(__fmul_rn(gv[1], 127.f)));
        } else {
          *reinterpret_cast<float2*>(gated + at) = make_float2(gv[0], gv[1]);
        }
      }
      if (!STATIC_GATE) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (valid && tq == 0) {
          atomicMax(amax + row, __float_as_uint(mx));
          if (n0 == 0) amax_clear[row] = 0u;
        }
      }
    }
  }
}

// ---- layer i, second product: rs_wgmma ---------------------------------------------

namespace rs8 {
constexpr int BM = 64;                // rows a block
constexpr int BK = 128;               // k a weight stage (int8 bytes)
constexpr int SLOT = 256 * BK;        // a 256-column weight pair; or 64 rows x 128 f32 of gate
constexpr int STAGES = 4;
constexpr int MAX_C = 512;            // two residual chunks of 128 a consumer warpgroup
// after the ring: the int8 A tile (C / 128 blocks of 64 x 128), the two
// warpgroups' row maxima, the row scales of the gate, the tile's barrier
constexpr int EXTRA = MAX_C * BM + 2 * BM * 4 + BM * 4 + 64;
constexpr int SMEM_BYTES = STAGES * SLOT + EXTRA + 1024 + 2 * STAGES * 8;
}  // namespace rs8

// The 128-byte-swizzled K-major int8 A tile: byte (row, k) of k block kb.
__device__ __forceinline__ int a_offset(int row, int k) {
  return (k >> 7) * (rs8::BM * 128) + row * 128 + ((((k & 127) >> 4) ^ (row & 7)) << 4) + (k & 15);
}

// A consumer warpgroup's product of the resident A tile with one 128-column
// chunk of `n_steps` weight stages (ring steps step0, step0 + 1, ...), the
// chunk being rows [128 half, +128) of each 256-row stage.  `active` false:
// the stages are only released (the other warpgroup's chunk is real).
__device__ __forceinline__ void rs_product(const Ring& r, const unsigned char* a_tile,
                                           int step0, int n_steps, int half, bool active,
                                           int (&acc)[64]) {
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < n_steps; ++kb) {
    const int n = step0 + kb, s = slot_of(r, n);
    hop::mbar_wait(&r.full[s], parity_of(r, n));
    if (active) {
      const unsigned char* a = a_tile + kb * (rs8::BM * 128);
      const unsigned char* bt = r.at(s) + half * 128 * 128;
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < rs8::BK / 32; ++k)
        hop::wgmma_s8_n128(acc, hop::desc_sw128(a + 32 * k, 16, 1024),
                           hop::desc_sw128(bt + 32 * k, 16, 1024), kb > 0 || k > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
    }
    if (lane == 0) hop::mbar_arrive(&r.empty[s]);
  }
  hop::fence_regs(acc);
}

// Block b owns rows [t0, t0 + 64) of batch row b and all N columns:
// N = 2C (residual, then skip) for layers 0..L-2, N = C (skip) for the last.
template <typename T, bool STATIC_GATE>
__global__ void __launch_bounds__(THREADS, 1)
rs_wgmma(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
         const unsigned* __restrict__ amax, const float* __restrict__ s_w,
         const float* __restrict__ bias, T* __restrict__ x, int8_t* __restrict__ xq,
         float* __restrict__ sx, float* __restrict__ skip, T* __restrict__ out,
         int T_len, int C, int layer, int first, int last) {
  using namespace rs8;
  extern __shared__ unsigned char smem[];
  const Ring r = make_ring(smem, SLOT, STAGES, EXTRA);
  unsigned char* a_tile = r.extra;
  float* red = reinterpret_cast<float*>(r.extra + MAX_C * BM);     // [2][64]
  float* s_gate = red + 2 * BM;                                     // [64]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(s_gate + BM);
  const int tiles_t = (T_len + BM - 1) / BM;
  const int b = blockIdx.x / tiles_t, t0 = (blockIdx.x % tiles_t) * BM;
  const int kb_c = C / BK;                    // k stages a chunk; gate stages
  const int rc = last ? 0 : C / 128;          // residual chunks
  const int sc = C / 128;                     // skip chunks
  const int pairs_r = (rc + 1) / 2, pairs_s = (sc + 1) / 2;
  const int gate_steps = STATIC_GATE ? 0 : kb_c;
  if (threadIdx.x == 0) {
    hop::mbar_init(a_full, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    hop::regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&map_g);
      hop::prefetch_map(&map_w);
      int n = 0;
      auto step = [&](auto load) {
        const int s = slot_of(r, n);
        hop::mbar_wait(&r.empty[s], parity_of(r, n) ^ 1);
        hop::mbar_expect_tx(&r.full[s], SLOT);
        load(r.at(s), &r.full[s]);
        ++n;
      };
      if (STATIC_GATE) {
        // the int8 gate straight into the A tile
        hop::mbar_expect_tx(a_full, kb_c * BM * 128);
        for (int kb = 0; kb < kb_c; ++kb)
          hop::tma_load(a_tile + kb * BM * 128, &map_g, a_full, kb * BK, t0, b);
      } else {
        // the f32 gate, 64 rows x 128 columns a stage
        for (int kb = 0; kb < kb_c; ++kb)
          step([&](unsigned char* dst, uint64_t* bar) {
            hop::tma_load(dst, &map_g, bar, kb * BK, t0, b);
          });
      }
      // weight pairs: residual columns [256 p, +256), then skip columns
      for (int p = 0; p < pairs_r + pairs_s; ++p) {
        const int n_row = p < pairs_r ? 256 * p : rc * 128 + 256 * (p - pairs_r);
        for (int kb = 0; kb < kb_c; ++kb)
          step([&](unsigned char* dst, uint64_t* bar) {
            hop::tma_load(dst, &map_w, bar, kb * BK, n_row, layer);
          });
      }
    }
    return;
  }
  hop::regs_inc<232>();
  const int wg = role - 1;
  const int ctid = threadIdx.x - 128;         // 0..255 over both consumer warpgroups
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;

  // the int8 A tile
  if (STATIC_GATE) {
    hop::mbar_wait(a_full, 0);
  } else {
    if (ctid < BM) {
      const int t = t0 + ctid;
      s_gate[ctid] = row_scale(t < T_len ? __uint_as_float(amax[(size_t)b * T_len + t]) : 0.f);
    }
    hop::bar_sync(1, 256);
    for (int kb = 0; kb < kb_c; ++kb) {
      const int s = slot_of(r, kb);
      hop::mbar_wait(&r.full[s], parity_of(r, kb));
      const float* src = reinterpret_cast<const float*>(r.at(s));
      // task i: row i / 32, four values at column 4 (i % 32)
#pragma unroll
      for (int it = 0; it < BM * 32 / 256; ++it) {
        const int i = ctid + 256 * it, row = i >> 5, col = (i & 31) * 4;
        const float4 v = *reinterpret_cast<const float4*>(src + row * BK + col);
        const float sg = s_gate[row];
        const char4 q = make_char4(quant(__fdiv_rn(v.x, sg)), quant(__fdiv_rn(v.y, sg)),
                                   quant(__fdiv_rn(v.z, sg)), quant(__fdiv_rn(v.w, sg)));
        *reinterpret_cast<char4*>(a_tile + a_offset(row, kb * BK + col)) = q;
      }
      if (lane == 0) hop::mbar_arrive(&r.empty[s]);
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);
  }

  int t_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) t_row[h] = t0 + warp * 16 + g + 8 * h;
  // rs value of fragment element e at column col
  auto value = [&](int p, int col, int h) {
    const float pf = __int2float_rn(p);
    const float v = STATIC_GATE ? __fmul_rn(pf, __fmul_rn(s_w[col], 1.f / 127.f))
                                : __fmul_rn(__fmul_rn(pf, s_gate[warp * 16 + g + 8 * h]), s_w[col]);
    return __fadd_rn(v, bias[col]);
  };
  int step = gate_steps;

  // residual columns: x += rs, then the next layer's qx and sx from the f32 sums
  if (rc > 0) {
    int acc[2][64];                   // chunks 2p + wg; after the epilogue, the f32 sums' bits
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p < pairs_r) {
        rs_product(r, a_tile, step, kb_c, wg, 2 * p + wg < rc, acc[p]);
        step += kb_c;
      }
    }
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= pairs_r || 2 * p + wg >= rc) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t_row[h] >= T_len) continue;
        const size_t row = (size_t)b * T_len + t_row[h];
        const int col0 = (2 * p + wg) * 128 + 2 * tq;
        // the row's old values first, all in flight together, then the stores
        float2 old[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) old[j] = load2(x + row * C + col0 + 8 * j);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = 4 * j + 2 * h;
          const int col = col0 + 8 * j;
          const float n0 = __fadd_rn(old[j].x, value(acc[p][e], col, h));
          const float n1 = __fadd_rn(old[j].y, value(acc[p][e + 1], col + 1, h));
          store2(x + row * C + col, n0, n1);
          acc[p][e] = __float_as_int(n0);
          acc[p][e + 1] = __float_as_int(n1);
          m[h] = fmaxf(m[h], fmaxf(fabsf(n0), fabsf(n1)));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      if (tq == 0) red[wg * BM + warp * 16 + g + 8 * h] = m[h];
    }
    hop::bar_sync(1, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // every lane runs the shuffles; only rows inside [0, T) store
      const bool valid = t_row[h] < T_len;
      const int lr = warp * 16 + g + 8 * h;
      const float s = row_scale(fmaxf(red[lr], red[BM + lr]));
      const size_t row = (size_t)b * T_len + t_row[h];
      if (valid && wg == 0 && tq == 0) sx[row] = s;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p >= pairs_r || 2 * p + wg >= rc) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = 4 * j + 2 * h;
          const unsigned q =
              (quant(__fdiv_rn(__int_as_float(acc[p][e]), s)) & 0xff) |
              (quant(__fdiv_rn(__int_as_float(acc[p][e + 1]), s)) & 0xff) << 8;
          // the 8 bytes of columns 8j .. 8j + 7 from the row's four lanes
          const unsigned lo = q | __shfl_down_sync(0xffffffffu, q, 1) << 16;
          const unsigned hi = __shfl_down_sync(0xffffffffu, lo, 2);
          if (valid && tq == 0)
            *reinterpret_cast<uint2*>(xq + row * C + (2 * p + wg) * 128 + 8 * j) =
                make_uint2(lo, hi);
        }
      }
    }
  }

  // skip columns, one 128-column chunk a warpgroup at a time; the chunk's
  // skip sums are read before its products, so their latency overlaps them
  for (int p = 0; p < pairs_s; ++p) {
    const int chunk = 2 * p + wg;
    float2 prev[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const size_t at = ((size_t)b * T_len + t_row[h]) * C + chunk * 128 + 8 * j + 2 * tq;
        prev[h][j] = first || chunk >= sc || t_row[h] >= T_len ? make_float2(0.f, 0.f)
                                                                : load2(skip + at);
      }
    int acc[64];
    rs_product(r, a_tile, step, kb_c, wg, chunk < sc, acc);
    step += kb_c;
    if (chunk >= sc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t_row[h] >= T_len) continue;
      const size_t row = (size_t)b * T_len + t_row[h];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = 4 * j + 2 * h;
        const int col = chunk * 128 + 8 * j + 2 * tq;      // of the skip columns
        const int wcol = rc * 128 + col;                   // of w and its vectors
        const float s0 = __fadd_rn(prev[h][j].x, value(acc[e], wcol, h));
        const float s1 = __fadd_rn(prev[h][j].y, value(acc[e + 1], wcol + 1, h));
        if (last) store2(out + row * C + col, s0, s1);
        else store2(skip + row * C + col, s0, s1);
      }
    }
  }
}

struct Args {
  void *x;
  const void* spect;
  const int8_t *w_in_cond, *w_rs, *w_rs_last;
  const float *s_in, *s_cond, *b_in_cond, *s_rs, *b_rs, *s_rs_last, *b_rs_last;
  float* gated;
  unsigned* amax;
  int8_t *xq, *spq, *gq;
  float *sx, *ssp, *skip;
  void* out;
};

// -1: the CUDA driver refused a tensor map
template <typename T, bool STATIC_GATE>
int run_block(const Args& a, int B, int T_len, int C, int S, int L, cudaStream_t stream) {
  const int M = B * T_len;
  const int K = 3 * C + S;
  const auto I8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap m_xq, m_sp, m_in, m_g, m_rs, m_last;
  const bool ok =
      hop::make_map(&m_xq, I8, 1, a.xq, C, T_len, B, in8::BK, in8::BM, true) &&
      hop::make_map(&m_sp, I8, 1, a.spq, S, T_len, B, in8::BK, in8::BM, true) &&
      hop::make_map(&m_in, I8, 1, a.w_in_cond, K, 2 * C, L, in8::BK, 64, true) &&
      (STATIC_GATE ? hop::make_map(&m_g, I8, 1, a.gq, C, T_len, B, rs8::BK, rs8::BM, true)
                   : hop::make_map(&m_g, F32, 4, a.gated, C, T_len, B, rs8::BK, rs8::BM, false)) &&
      hop::make_map(&m_rs, I8, 1, a.w_rs, C, 2 * C, L - 1, rs8::BK, 256, true) &&
      hop::make_map(&m_last, I8, 1, a.w_rs_last, C, C, 1, rs8::BK, 256, true);
  if (!ok) return -1;
  // the first GEMM, unrolled for C / 128 = 1 .. 4 stages a tap
  using InKernel = decltype(&in_wgmma<STATIC_GATE, 1>);
  const InKernel in_kernels[4] = {in_wgmma<STATIC_GATE, 1>, in_wgmma<STATIC_GATE, 2>,
                                  in_wgmma<STATIC_GATE, 3>, in_wgmma<STATIC_GATE, 4>};
  const InKernel in_kernel = in_kernels[C / 128 - 1];
  cudaError_t err = cudaFuncSetAttribute(
      in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, in8::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rs_wgmma<T, STATIC_GATE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, rs8::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;

  unsigned* amax[2] = {a.amax, a.amax + M};
  const dim3 rows((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  row_quant<T><<<rows, ROWS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const T*>(a.spect), M, S, a.spq, a.ssp, nullptr);
  row_quant<T><<<rows, ROWS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const T*>(a.x), M, C, a.xq, a.sx, amax[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int in_tiles = B * ((T_len + in8::BM - 1) / in8::BM) * (C / 64);
  const dim3 grid_in(in_tiles < sms ? in_tiles : sms);
  const dim3 grid_rs(B * ((T_len + rs8::BM - 1) / rs8::BM));
  for (int i = 0; i < L; ++i) {
    in_kernel<<<grid_in, THREADS, in8::SMEM_BYTES, stream>>>(
        m_xq, m_sp, m_in, a.sx, a.ssp, a.s_in + (size_t)i * 2 * C, a.s_cond + (size_t)i * 2 * C,
        a.b_in_cond + (size_t)i * 2 * C, a.gated, a.gq, amax[i % 2], amax[(i + 1) % 2],
        B, T_len, C, S, i, 1 << i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool last = i == L - 1;
    rs_wgmma<T, STATIC_GATE><<<grid_rs, THREADS, rs8::SMEM_BYTES, stream>>>(
        m_g, last ? m_last : m_rs, amax[i % 2], last ? a.s_rs_last : a.s_rs + (size_t)i * 2 * C,
        last ? a.b_rs_last : a.b_rs + (size_t)i * 2 * C, static_cast<T*>(a.x), a.xq, a.sx,
        a.skip, static_cast<T*>(a.out), T_len, C, last ? 0 : i, i == 0, last);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_block(const Args& a, int B, int T_len, int C, int S, int L, int static_gate,
              cudaStream_t stream) {
  if (static_gate) return run_block<T, true>(a, B, T_len, C, S, L, stream);
  return run_block<T, false>(a, B, T_len, C, S, L, stream);
}

}  // namespace

// ptrs, in order: x (the block's working buffer: the start conv's output,
// B x T x C in T, overwritten with the residual stream), spect (B x T x S,
// T); w_in_cond (L, 2C, 3C + S) int8, s_in, s_cond, b_in_cond (L, 2C) f32;
// w_rs (L - 1, 2C, C) int8, s_rs, b_rs (L - 1, 2C) f32; w_rs_last (C, C)
// int8 output-major, s_rs_last, b_rs_last (C) f32; scratch: gated (B*T x C
// f32, null with a static gate scale), amax (2 x B*T u32), xq (B*T x C
// int8), sx (B*T f32), spq (B*T x S int8), ssp (B*T f32), gq (B*T x C
// int8), skip (B*T x C f32); out (B x T x C, T) receives the skip sum.
// ints: is_bf16, B, T, C, S, L, static_gate.  Requires C % 128 == 0,
// C <= 512, S % 64 == 0, L >= 2 and 16-byte aligned pointers.  Returns the
// CUDA error code of the launches (0 on success), -1 when the CUDA driver
// refuses a tensor map.
extern "C" int wn_block_int8_forward(void* const* ptrs, const long long* ints, void* stream) {
  Args a;
  int i = 0;
  a.x = ptrs[i++];
  a.spect = ptrs[i++];
  a.w_in_cond = (const int8_t*)ptrs[i++];
  a.s_in = (const float*)ptrs[i++];
  a.s_cond = (const float*)ptrs[i++];
  a.b_in_cond = (const float*)ptrs[i++];
  a.w_rs = (const int8_t*)ptrs[i++];
  a.s_rs = (const float*)ptrs[i++];
  a.b_rs = (const float*)ptrs[i++];
  a.w_rs_last = (const int8_t*)ptrs[i++];
  a.s_rs_last = (const float*)ptrs[i++];
  a.b_rs_last = (const float*)ptrs[i++];
  a.gated = (float*)ptrs[i++];
  a.amax = (unsigned*)ptrs[i++];
  a.xq = (int8_t*)ptrs[i++];
  a.sx = (float*)ptrs[i++];
  a.spq = (int8_t*)ptrs[i++];
  a.ssp = (float*)ptrs[i++];
  a.gq = (int8_t*)ptrs[i++];
  a.skip = (float*)ptrs[i++];
  a.out = ptrs[i++];
  const int is_bf16 = (int)ints[0], B = (int)ints[1], T_len = (int)ints[2];
  const int C = (int)ints[3], S = (int)ints[4], L = (int)ints[5], static_gate = (int)ints[6];
  if (B < 1 || T_len < 1 || C % 128 || C > rs8::MAX_C || S % 64 || L < 2)
    return (int)cudaErrorInvalidValue;
  if (!static_gate && a.gated == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return run_block<__nv_bfloat16>(a, B, T_len, C, S, L, static_gate, s);
  return run_block<float>(a, B, T_len, C, S, L, static_gate, s);
}
