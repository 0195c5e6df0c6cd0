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
// Design.  Per layer:
//   row_quant: one warp per row; writes int8 and one f32 scale.  Run on the
//     mel once per call, on x before every layer, and on the f32 gate (which
//     stays f32 until then, as in the TPU kernel) unless the gate scale is
//     static, in which case in_kernel's epilogue writes the int8 gate.
//   in_kernel: M = B*T rows, N = 2C, K = 3C + S in four segments (three
//     taps, the mel).  Each segment's products stay in int32; where a tap's
//     segment ends, its sum converts to f32 times that tap's row scale and
//     adds to an f32 accumulator, because each tap carries its own row
//     scale and the i32 sums cannot be added first.  The loader builds the
//     A tile by im2col from rows t-d, t, t+d of qx and row t of the mel.
//     A warp owns columns j and C+j, so the gate runs in its registers.
//   rs_kernel: M = B*T, K = C, N = 2C (C for the last layer); its epilogue
//     updates x in place, writes the f32 sum for the next row_quant, and
//     accumulates skip in f32; the last layer writes the output.
// The GEMMs run 128 x 128 block tiles, 8 warps of 32 x 64, over a 3-stage
// cp.async ring of 64-byte k slices (out-of-range rows zero-filled) on
// mma.sync.m16n8k32 s8 x s8 -> s32; the shared-memory row stride of 80
// bytes makes the 32-bit fragment loads free of bank conflicts.
//
// Bound on an H100 SXM: per grouped row a block takes
//   2 * ((3C + S) * 2C * L + C * 2C * (L - 1) + C * C)
// int8 operations, 43.5 M at C = 512, S = 640, L = 8; 356 G for a 256-frame
// utterance (T = 8192), 0.18 ms at 1979 TOP/s dense int8.  Its bytes (22 MB
// of int8 weights, 27 MB of bf16 x, mel and output) take 0.015 ms at
// 3.35 TB/s: the block is bound by operations.  Not done yet, and left to
// later work: wgmma with TMA, keeping the activations and their scales
// on-chip across layers as the TPU kernel keeps them in VMEM (the row
// passes here move about 6 x M x C bytes a layer through L2 and memory).

#include "wn_tile.cuh"

#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows per block
constexpr int BN = 128;       // accumulator columns per block
constexpr int BK = 64;        // int8 reduction depth per stage (bytes)
constexpr int LD = BK + 16;   // shared-memory row stride (bytes)
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int STAGE_BYTES = (BM + BN) * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// round half to even, clip to [-127, 127]
__device__ __forceinline__ int quant(float v) {
  return max(-127, min(127, __float2int_rn(v)));
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16 x 32, row) . b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- per-row quantization --------------------------------------------------

// q[row] = clip(rint(src[row] / s)), s = max(amax(|src[row]|), 1e-8) / 127;
// one warp per row of W values (W % 4 == 0).
template <typename Src>
__global__ void __launch_bounds__(THREADS)
row_quant(const Src* __restrict__ src, int M, int W, int8_t* __restrict__ q,
          float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const Src* r = src + (size_t)row * W;
  float amax = 0.f;
  for (int k = lane * 4; k < W; k += 128) {
    const float4 v = load4(r + k);
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, EPS), 127.f);
  for (int k = lane * 4; k < W; k += 128) {
    const float4 v = load4(r + k);
    const char4 c = make_char4(quant(__fdiv_rn(v.x, s)), quant(__fdiv_rn(v.y, s)),
                               quant(__fdiv_rn(v.z, s)), quant(__fdiv_rn(v.w, s)));
    *reinterpret_cast<char4*>(q + (size_t)row * W + k) = c;
  }
  if (lane == 0) scale[row] = s;
}

// ---- the tiled int8 product ---------------------------------------------------

// A warp's 32 x 64 share of the block tile: 2 m16 tiles x 8 n8 tiles.
// Fragment element (mi, ni, e) sits at tile row wm*32 + mi*16 + g + 8*(e/2)
// and at column n_of(ni) + 2*tq + e%2 (g = lane / 4, tq = lane % 4).
struct Warp {
  int wm, wn, g, tq;
  __device__ Warp() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = warp & 3; wn = warp >> 2; g = lane >> 2; tq = lane & 3;
  }
  __device__ int row(int mi, int e) const { return wm * 32 + mi * 16 + g + (e >> 1) * 8; }
};

// Runs stages [0, K / BK) of the product into acc; `load(a_s, b_s, k0)`
// issues the copies of one stage, `n_of(ni)` gives the B-tile row (tile
// column) of n8 tile ni, and `after(kt)` runs once stage kt is multiplied.
template <typename Load, typename NOf, typename After>
__device__ __forceinline__ void product(unsigned char* smem, int K, const Warp& w,
                                        int (&acc)[2][8][4], Load load, NOf n_of,
                                        After after) {
  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(smem + s * STAGE_BYTES, smem + s * STAGE_BYTES + BM * LD, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) {
      unsigned char* st = smem + (next % STAGES) * STAGE_BYTES;
      load(st, st + BM * LD, next * BK);
    }
    cp_async_commit();
    const unsigned char* a_s = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* b_s = a_s + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const unsigned char* p = a_s + (w.wm * 32 + mi * 16 + w.g) * LD + kk + w.tq * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * LD);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * LD + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const unsigned char* p = b_s + (n_of(ni) + w.g) * LD + kk + w.tq * 4;
        const unsigned b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    after(kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// copies one stage's BM (or BN) rows of 64 bytes: `src(r)` gives row r's
// address at the stage's k offset, or null for a zero row
template <int ROWS, typename Src>
__device__ __forceinline__ void load_rows(unsigned char* dst, Src src, const void* any) {
  for (int c = threadIdx.x; c < ROWS * (BK / 16); c += THREADS) {
    const int r = c >> 2, kc = (c & 3) * 16;
    const unsigned char* p = src(r);
    cp_async16(dst + r * LD + kc, p != nullptr ? p + kc : any, p != nullptr);
  }
}

// Layer i, first product, with the gate in the epilogue.  Block (bx, by)
// owns rows [bx*BM, +BM) and gate columns [by*64, +64): acts columns
// [by*64, +64) (tile columns 0..63) and [C + by*64, +64) (64..127).  Warp
// (wm, wn) holds tile columns wn*32 + [0, 32) in n8 tiles 0..3 and the
// matching 64 + wn*32 + [0, 32) in n8 tiles 4..7.
template <bool STATIC_GATE>
__global__ void __launch_bounds__(THREADS)
in_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
          const int8_t* __restrict__ spq, const float* __restrict__ ssp,
          const int8_t* __restrict__ w, const float* __restrict__ s_in,
          const float* __restrict__ s_cond, const float* __restrict__ bias,
          float* __restrict__ gated, int8_t* __restrict__ gq,
          int M, int T_len, int C, int S, int dilation) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Warp wp;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * 64;
  const int K = 3 * C + S;

  auto load = [&](unsigned char* a_s, unsigned char* b_s, int k0) {
    // every stage lies inside one segment: tap 0, 1, 2 or the mel
    if (k0 < 3 * C) {
      const int tap = k0 / C, ch0 = k0 - tap * C, shift = (tap - 1) * dilation;
      load_rows<BM>(a_s, [&](int r) -> const unsigned char* {
        const int row = m0 + r;
        if (row >= M) return nullptr;
        const int b = row / T_len, t = row - b * T_len + shift;
        if (t < 0 || t >= T_len) return nullptr;
        return reinterpret_cast<const unsigned char*>(xq + ((size_t)b * T_len + t) * C + ch0);
      }, xq);
    } else {
      const int ch0 = k0 - 3 * C;
      load_rows<BM>(a_s, [&](int r) -> const unsigned char* {
        const int row = m0 + r;
        if (row >= M) return nullptr;
        return reinterpret_cast<const unsigned char*>(spq + (size_t)row * S + ch0);
      }, spq);
    }
    load_rows<BN>(b_s, [&](int r) -> const unsigned char* {
      const int col = r < 64 ? n0 + r : C + n0 + (r - 64);
      return reinterpret_cast<const unsigned char*>(w + (size_t)col * K + k0);
    }, w);
  };
  auto n_of = [&](int ni) { return (ni < 4 ? 0 : 64) + wp.wn * 32 + (ni & 3) * 8; };

  int acc[2][8][4] = {};
  float in_acc[2][8][4] = {};
  // where a tap's segment ends: in_acc += float(acc) * (row scale of that tap)
  auto after = [&](int kt) {
    const int k_end = (kt + 1) * BK;
    if (k_end > 3 * C || k_end % C) return;
    const int shift = (k_end / C - 2) * dilation;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wp.row(mi, 2 * h);
        float s = 0.f;
        if (row < M) {
          const int b = row / T_len, t = row - b * T_len + shift;
          if (t >= 0 && t < T_len) s = sx[(size_t)b * T_len + t];
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            int& a = acc[mi][ni][2 * h + c];
            float& f = in_acc[mi][ni][2 * h + c];
            f = __fadd_rn(f, __fmul_rn(__int2float_rn(a), s));
            a = 0;
          }
      }
  };
  product(smem, K, wp, acc, load, n_of, after);

  // acc now holds the mel's products
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wp.row(mi, 2 * h);
      if (row >= M) continue;
      const float s_sp = ssp[row];
      float gv[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n0 + wp.wn * 32 + ni * 8 + wp.tq * 2 + c;
          const int e = 2 * h + c;
          const float a_t = __fadd_rn(
              __fadd_rn(__fmul_rn(in_acc[mi][ni][e], s_in[j]),
                        __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), s_sp), s_cond[j])),
              bias[j]);
          const float a_s = __fadd_rn(
              __fadd_rn(__fmul_rn(in_acc[mi][ni + 4][e], s_in[C + j]),
                        __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni + 4][e]), s_sp),
                                  s_cond[C + j])),
              bias[C + j]);
          gv[ni][c] = __fmul_rn(tanhf(a_t), 1.f / (1.f + expf(-a_s)));
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const size_t at = (size_t)row * C + n0 + wp.wn * 32 + ni * 8 + wp.tq * 2;
        if (STATIC_GATE) {
          *reinterpret_cast<char2*>(gq + at) =
              make_char2(quant(__fmul_rn(gv[ni][0], 127.f)),
                         quant(__fmul_rn(gv[ni][1], 127.f)));
        } else {
          *reinterpret_cast<float2*>(gated + at) = make_float2(gv[ni][0], gv[ni][1]);
        }
      }
    }
}

// Layer i, second product: rs = qg . w_rs * sg * s_rs + b_rs, with the
// residual update and the skip sum in the epilogue.
template <typename T, bool STATIC_GATE>
__global__ void __launch_bounds__(THREADS)
rs_kernel(const int8_t* __restrict__ gq, const float* __restrict__ gs,
          const int8_t* __restrict__ w, const float* __restrict__ s_w,
          const float* __restrict__ bias, T* __restrict__ x, float* __restrict__ x_f32,
          float* __restrict__ skip, T* __restrict__ out, int M, int C, int first, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Warp wp;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  auto load = [&](unsigned char* a_s, unsigned char* b_s, int k0) {
    load_rows<BM>(a_s, [&](int r) -> const unsigned char* {
      const int row = m0 + r;
      if (row >= M) return nullptr;
      return reinterpret_cast<const unsigned char*>(gq + (size_t)row * C + k0);
    }, gq);
    load_rows<BN>(b_s, [&](int r) -> const unsigned char* {
      return reinterpret_cast<const unsigned char*>(w + (size_t)(n0 + r) * C + k0);
    }, w);
  };
  auto n_of = [&](int ni) { return wp.wn * 64 + ni * 8; };
  int acc[2][8][4] = {};
  product(smem, C, wp, acc, load, n_of, [](int) {});

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wp.row(mi, 2 * h);
      if (row >= M) continue;
      const float s_g = STATIC_GATE ? 1.f : gs[row];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col0 = n0 + wp.wn * 64 + ni * 8 + wp.tq * 2;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = __int2float_rn(acc[mi][ni][2 * h + c]);
          const float sc = s_w[col0 + c];
          v[c] = STATIC_GATE ? __fmul_rn(p, __fmul_rn(sc, 1.f / 127.f))
                             : __fmul_rn(__fmul_rn(p, s_g), sc);
          v[c] = __fadd_rn(v[c], bias[col0 + c]);
        }
        if (!last && col0 < C) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const size_t at = (size_t)row * C + col0 + c;
            const float nx = __fadd_rn(to_f(x[at]), v[c]);
            x[at] = from_f<T>(nx);
            if (x_f32 != nullptr) x_f32[at] = nx;
          }
        } else {
          const size_t at = (size_t)row * C + (last ? col0 : col0 - C);
          float2 prev = first ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(skip + at);
          const float s0 = __fadd_rn(prev.x, v[0]), s1 = __fadd_rn(prev.y, v[1]);
          if (last) {
            out[at] = from_f<T>(s0);
            out[at + 1] = from_f<T>(s1);
          } else {
            *reinterpret_cast<float2*>(skip + at) = make_float2(s0, s1);
          }
        }
      }
    }
}

struct Args {
  void *x;
  const void* spect;
  const int8_t *w_in_cond, *w_rs, *w_rs_last;
  const float *s_in, *s_cond, *b_in_cond, *s_rs, *b_rs, *s_rs_last, *b_rs_last;
  float *x_f32, *gated;
  int8_t *xq, *spq, *gq;
  float *sx, *ssp, *gs, *skip;
  void* out;
};

template <typename T, bool STATIC_GATE>
int run_block(const Args& a, int B, int T_len, int C, int S, int L, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      in_kernel<STATIC_GATE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      rs_kernel<T, STATIC_GATE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;

  const int M = B * T_len;
  const int K = 3 * C + S;
  const dim3 block(THREADS);
  const dim3 grid_rows((M + THREADS / 32 - 1) / (THREADS / 32));
  const dim3 grid_in((M + BM - 1) / BM, C / 64);
  T* x = static_cast<T*>(a.x);
  // the stream the next layer quantizes: its f32 copy, or x itself in f32
  const float* x_src = a.x_f32 != nullptr ? a.x_f32 : reinterpret_cast<const float*>(a.x);

  row_quant<T><<<grid_rows, block, 0, stream>>>(static_cast<const T*>(a.spect), M, S, a.spq, a.ssp);
  row_quant<T><<<grid_rows, block, 0, stream>>>(x, M, C, a.xq, a.sx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < L; ++i) {
    in_kernel<STATIC_GATE><<<grid_in, block, SMEM_BYTES, stream>>>(
        a.xq, a.sx, a.spq, a.ssp, a.w_in_cond + (size_t)i * 2 * C * K,
        a.s_in + (size_t)i * 2 * C, a.s_cond + (size_t)i * 2 * C,
        a.b_in_cond + (size_t)i * 2 * C, a.gated, a.gq, M, T_len, C, S, 1 << i);
    if (!STATIC_GATE)
      row_quant<float><<<grid_rows, block, 0, stream>>>(a.gated, M, C, a.gq, a.gs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool last = i == L - 1;
    const int N = last ? C : 2 * C;
    const int8_t* w = last ? a.w_rs_last : a.w_rs + (size_t)i * 2 * C * C;
    const float* s = last ? a.s_rs_last : a.s_rs + (size_t)i * 2 * C;
    const float* b = last ? a.b_rs_last : a.b_rs + (size_t)i * 2 * C;
    const dim3 grid_rs((M + BM - 1) / BM, N / BN);
    rs_kernel<T, STATIC_GATE><<<grid_rs, block, SMEM_BYTES, stream>>>(
        a.gq, a.gs, w, s, b, x, a.x_f32, a.skip, static_cast<T*>(a.out), M, C, i == 0, last);
    if (!last)
      row_quant<float><<<grid_rows, block, 0, stream>>>(x_src, M, C, a.xq, a.sx);
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
// int8 output-major, s_rs_last, b_rs_last (C) f32; scratch: x_f32 (B*T x C
// f32, null when T is float), gated (B*T x C f32, null with a static gate
// scale), xq (B*T x C int8), sx (B*T f32), spq (B*T x S int8), ssp (B*T
// f32), gq (B*T x C int8), gs (B*T f32), skip (B*T x C f32); out (B x T x
// C, T) receives the skip sum.
// ints: is_bf16, B, T, C, S, L, static_gate.  Requires C % 128 == 0,
// S % 64 == 0, L >= 2 and 16-byte aligned pointers.  Returns the CUDA error
// code of the launches (0 on success).
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
  a.x_f32 = (float*)ptrs[i++];
  a.gated = (float*)ptrs[i++];
  a.xq = (int8_t*)ptrs[i++];
  a.sx = (float*)ptrs[i++];
  a.spq = (int8_t*)ptrs[i++];
  a.ssp = (float*)ptrs[i++];
  a.gq = (int8_t*)ptrs[i++];
  a.gs = (float*)ptrs[i++];
  a.skip = (float*)ptrs[i++];
  a.out = ptrs[i++];
  const int is_bf16 = (int)ints[0], B = (int)ints[1], T_len = (int)ints[2];
  const int C = (int)ints[3], S = (int)ints[4], L = (int)ints[5], static_gate = (int)ints[6];
  if (B < 1 || T_len < 1 || C % 128 || S % 64 || L < 2) return (int)cudaErrorInvalidValue;
  if (is_bf16 && a.x_f32 == nullptr) return (int)cudaErrorInvalidValue;
  if (!static_gate && a.gated == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return run_block<__nv_bfloat16>(a, B, T_len, C, S, L, static_gate, s);
  return run_block<float>(a, B, T_len, C, S, L, static_gate, s);
}
