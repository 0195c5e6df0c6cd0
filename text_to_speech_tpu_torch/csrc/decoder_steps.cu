// K Tacotron-2 decoder steps in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `decoder_steps` (text_to_speech_tpu/ops/
// decoder_kernel.py, body `_decoder_kernel`).  Per step and batch row it
// computes the same function:
//
//   x      = dropout(relu(dropout(relu(frame @ w0 + b0 + extra)) @ w1 + b1))
//   h_att  = LSTM([x | ctx | h_att] @ att_w + att_b)          gates i, f, g, o
//   pq     = h_att @ q_w
//   feat   = conv31([prev, cum]) folded with location_dense   (62, A) weight
//   e[s]   = sum_a tanh(pq + pm[s] + feat[s]) * v,  masked with -1e9, with an
//            optional window around the previous step's argmax
//   attn   = softmax(e);  cum += attn;  prev = attn;  main = argmax(attn)
//   ctx    = sum_s attn[s] * mem[s]       (product in T, sum in f32)
//   h_dec  = LSTM([h_att | ctx | h_dec] @ dec_w + dec_b)
//   frame | gate = [h_dec | ctx] @ proj_w + proj_b, sigmoid on the gate
//
// Products accumulate in f32; h_att, h_dec, ctx and the prenet activations
// round to T (float or bf16) where the TPU kernel rounds; c, frame and the
// alignments stay f32.  The state lives in device buffers that the kernel
// updates in place, so the next launch continues where this one stopped.
//
// What bounds it.  At NVIDIA width the two LSTM weights are 18.2 M values,
// 72.7 MB in f32: more than the 50 MB L2 and far more than all shared
// memory, so they stream from device memory on every step, and with at
// most 8 rows the products are matrix-vector work bound by those bytes
// (21.7 us a step at 3.35 TB/s in f32).  The steps are a serial chain, so
// the least time of a launch is K times that, not the bytes read once.
//
// Design.  One persistent grid, one block of 512 threads on every SM,
// launched cooperatively so that every block is resident; the phases of a
// step are separated by grid-wide barriers (four a step):
//   rows   : the block that owns a batch row computes the previous step's
//            projection and this step's prenet (Philox dropout);
//   att    : every block computes the attention LSTM for its slabs;
//   rows   : the row's block computes the attention and the context;
//   dec    : every block computes the decoder LSTM for its slabs.
// An LSTM weight is packed into slabs of 8 units: slab s holds, for every
// input k, the 32 columns (i, f, g, o) x 8 units contiguously, so a block
// streams one contiguous slab with 16-byte loads (8-byte in bf16), a warp
// covers 4 consecutive k rows, and the four gates of a unit end up in one
// thread: the pointwise LSTM update needs no further barrier.  Partial sums
// over k are combined in a fixed order (warp shuffles, then the 16 warps in
// turn), so results do not change from launch to launch.  h_att and h_dec
// are read by all blocks while their owners write the new values, so each
// has a second buffer and the two alternate by step.  State that another
// block wrote is read with ld.global.cg (L2), never through L1.
//
// Dropout keeps a value iff philox4x32-10(key = seed, counter = (absolute
// step, row, unit, layer)) word 0 >= threshold: independent of the grid, of
// the launch length and of the block that computes it.
//
// int8 LSTM mode (the TPU kernel's `int8_lstm`): att_w and dec_w are int8
// with one f32 scale per output column.  Every block quantizes the staged
// input row [x | ctx | h] itself (scale = max(amax, 1e-8) * (1/127), q =
// rint(x / scale) clipped to 127), so no further barrier is needed; the
// products are __dp4a on 4 int8 k values against 4 int8 weights with int32
// sums, exact in any order, and z = float(sum) * row scale * column scale +
// bias.  The int8 slabs are laid out (U / 8, K / 4, 32, 4): for every group
// of 4 k rows, the 32 columns of the slab, each as its 4 k bytes.  They are
// half the bytes of bf16 (18.2 MB at NVIDIA width), which fits the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLAB_UNITS = 8;               // LSTM units per weight slab
constexpr int SLAB_COLS = 4 * SLAB_UNITS;   // gate columns per slab
constexpr int K_LANES = 4 * WARPS;          // k rows in flight per block
constexpr int LOC_TAPS = 31;
constexpr int LOC_PAD = LOC_TAPS / 2;
constexpr int MAX_ROWS = 8;

struct Params {
  // weights (T unless float)
  const void *w0, *w1, *att_k, *q_w, *loc_w, *dec_k, *proj_t;
  const float *b0, *b1, *att_b, *v_w, *dec_b, *proj_b;
  // inputs
  const void *mem, *pm;
  const float* mask;
  const int* enc_len;
  const float* extra;
  const long long* seed;
  // state, updated in place
  float* frame;
  void* h_att;
  float* c_att;
  void* h_dec;
  float* c_dec;
  void* ctx;
  float *prev, *cum;
  int* main_idx;
  // scratch
  float* x;
  void *h_att_alt, *h_dec_alt;
  // outputs
  float *steps, *attn;
  // optional (may be null): clock stamps of the block that owns row 0, 8 a
  // step, then (globaltimer ns, clock) at the start and at the end
  long long* stamps;
  // int8 LSTM mode: per-column scales of att_w and dec_w (null otherwise)
  const float *s_att, *s_dec;
  int B, S, n_mel, P0, P1, D, U, A, K, step0;
  int deterministic, use_window, win_len, win_offset;
  unsigned drop_threshold;
  float drop_scale;
};

// ---- element access ---------------------------------------------------------

__device__ inline float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

// read-only data (weights, memory): through the read-only path
__device__ inline float ldg1(const float* p) { return __ldg(p); }
__device__ inline float ldg1(const __nv_bfloat16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ inline float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ inline float4 ldg4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  float4 o;
  o.x = __uint_as_float(r.x << 16);
  o.y = __uint_as_float(r.x & 0xffff0000u);
  o.z = __uint_as_float(r.y << 16);
  o.w = __uint_as_float(r.y & 0xffff0000u);
  return o;
}

// state that other blocks write between barriers: from L2
__device__ inline float ldcg1(const float* p) { return __ldcg(p); }
__device__ inline float ldcg1(const __nv_bfloat16* p) {
  return bf16_bits_to_float(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ inline float round_to(float v, float*) { return v; }
__device__ inline float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T>
__device__ inline float rounded(float v) { return round_to(v, static_cast<T*>(nullptr)); }

__device__ inline void store1(float* p, float v) { *p = v; }
__device__ inline void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ inline float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

// clock stamp i of this block, for the phase breakdown
__device__ inline void stamp(long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[i] = clock64();
}

__device__ inline long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// ---- philox4x32-10 ----------------------------------------------------------

__device__ inline unsigned philox_word0(unsigned k0, unsigned k1, unsigned c0,
                                        unsigned c1, unsigned c2, unsigned c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return c0;
}

// ---- reductions over the block, in a fixed order ------------------------------

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__device__ inline float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

// ---- shared memory ----------------------------------------------------------

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// offsets in floats; every array starts at a multiple of 4 floats
struct Layout {
  int in_s, in_q, row_s, red, vec, fr, x0, x1, part, pq, v, locw, prevp, cump, e, attn, scratch, total;
};

__host__ __device__ inline Layout make_layout(int NB, int S, int n_mel, int P0, int P1,
                                              int D, int U, int A) {
  Layout l;
  const int k_att = P1 + D + U, k_dec = 2 * U + D;
  int at = 0;
  l.in_s = at;    at += up4((k_att > k_dec ? k_att : k_dec) * NB);
  l.in_q = at;    at += up4((k_att > k_dec ? k_att : k_dec) / 4 * NB);   // int32 words
  l.row_s = at;   at += MAX_ROWS;
  l.red = at;     at += WARPS * SLAB_UNITS * NB * 4;
  l.vec = at;     at += up4(U + D);
  l.fr = at;      at += up4(n_mel + 1);
  l.x0 = at;      at += up4(P0);
  l.x1 = at;      at += up4(P1);
  l.part = at;    at += THREADS * 4;
  l.pq = at;      at += up4(A);
  l.v = at;       at += up4(A);
  l.locw = at;    at += 2 * LOC_TAPS * up4(A);
  l.prevp = at;   at += up4(S + 2 * LOC_PAD);
  l.cump = at;    at += up4(S + 2 * LOC_PAD);
  l.e = at;       at += up4(S);
  l.attn = at;    at += up4(S);
  l.scratch = at; at += 4 * WARPS;
  l.total = at;
  return l;
}

// ---- small matrix-vector product: out[N] = in[Kd] @ W[Kd, N] -------------------
// W row-major in T and read-only; N % 4 == 0 and N / 4 <= THREADS.  The k
// rows are dealt to THREADS / (N / 4) lanes, whose partial sums are added
// in lane order.

template <typename T>
__device__ void matvec(const T* __restrict__ W, int Kd, int N, const float* in_s,
                       float* out_s, float* part) {
  const int n4 = N >> 2;
  const int nl = THREADS / n4;
  const int lane = threadIdx.x / n4, c = threadIdx.x - lane * n4;
  if (lane < nl) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const T* w = W + 4 * c;
    int k = lane;
    for (; k + 7 * nl < Kd; k += 8 * nl) {
      float4 wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = ldg4(w + (size_t)(k + j * nl) * N);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xv = in_s[k + j * nl];
        acc.x += xv * wv[j].x; acc.y += xv * wv[j].y;
        acc.z += xv * wv[j].z; acc.w += xv * wv[j].w;
      }
    }
    for (; k < Kd; k += nl) {
      const float4 wv = ldg4(w + (size_t)k * N);
      const float xv = in_s[k];
      acc.x += xv * wv.x; acc.y += xv * wv.y; acc.z += xv * wv.z; acc.w += xv * wv.w;
    }
    reinterpret_cast<float4*>(part)[lane * n4 + c] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float s = 0.f;
    for (int l = 0; l < nl; ++l) s += part[(l * n4 + (n >> 2)) * 4 + (n & 3)];
    out_s[n] = s;
  }
  __syncthreads();
}

// ---- LSTM phase ---------------------------------------------------------------

template <int NB>
__device__ inline void load_rows(const float* s, float (&x)[NB]) {
  if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(s)[i];
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z; x[4 * i + 3] = v.w;
    }
  } else if constexpr (NB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = s[0];
  }
}

template <int NB>
__device__ inline void fma_rows(float (&acc)[NB][4], const float4 w, const float* s) {
  float x[NB];
  load_rows<NB>(s, x);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    acc[b][0] += x[b] * w.x; acc[b][1] += x[b] * w.y;
    acc[b][2] += x[b] * w.z; acc[b][3] += x[b] * w.w;
  }
}

// one segment of an LSTM's input, rows [0, B) of a (B, len) array, into
// in_s[(off + k) * NB + b]; rows [B, NB) read as zero
template <int NB, typename V>
__device__ inline void stage(float* in_s, int off, const V* src, int len, int B) {
  for (int i = threadIdx.x; i < len * NB; i += THREADS) {
    const int b = i / len, k = i - b * len;
    in_s[(off + k) * NB + b] = b < B ? ldcg1(src + (size_t)b * len + k) : 0.f;
  }
}

// int8 LSTM mode: rows [0, NB) of in_s → in_q[k4 * NB + b], the int8 values
// of rows 4 k4 .. 4 k4 + 3 packed in one word, and their scales row_s[b].
// Every block computes the same values from the same staged rows.
__device__ inline int quant8(float v) { return max(-127, min(127, __float2int_rn(v))); }

template <int NB>
__device__ void quantize_rows(const float* in_s, int Kd, int* in_q, float* row_s,
                              float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // THREADS and 32 are multiples of NB: a thread sees one row, b = tid % NB
  float amax = 0.f;
  for (int i = threadIdx.x; i < Kd * NB; i += THREADS) amax = fmaxf(amax, fabsf(in_s[i]));
#pragma unroll
  for (int o = 16; o >= NB; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane < NB) scratch[warp * NB + lane] = amax;
  __syncthreads();
  if (threadIdx.x < NB) {
    float m = 0.f;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, scratch[w * NB + threadIdx.x]);
    row_s[threadIdx.x] = __fmul_rn(fmaxf(m, 1e-8f), 1.f / 127.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Kd / 4 * NB; i += THREADS) {
    const int k4 = i / NB, b = i - k4 * NB;
    const float s = row_s[b];
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (unsigned)(quant8(__fdiv_rn(in_s[(4 * k4 + j) * NB + b], s)) & 0xff) << (8 * j);
    in_q[i] = (int)word;
  }
  __syncthreads();
}

template <int NB>
__device__ inline void dp4a_rows(int (&acc)[NB][4], const uint4 w, const int* q) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int x = q[b];
    acc[b][0] = __dp4a(x, (int)w.x, acc[b][0]);
    acc[b][1] = __dp4a(x, (int)w.y, acc[b][1]);
    acc[b][2] = __dp4a(x, (int)w.z, acc[b][2]);
    acc[b][3] = __dp4a(x, (int)w.w, acc[b][3]);
  }
}

// z = in_s @ W + bias for this block's slabs (in int8 mode: from in_q, with
// the row and column scales), then the pointwise update: c (B, U) f32 in
// place, h_out (B, U) in T
template <typename T, int NB, bool Q8>
__device__ void lstm_slabs(const void* __restrict__ wk_, const float* __restrict__ bias,
                           const float* __restrict__ s_w, int Kd, int U, int B,
                           const float* in_s, const int* in_q, const float* row_s,
                           float* red, float* c_state, T* h_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = lane & (SLAB_UNITS - 1), ksub = lane >> 3;
  const int n_slabs = U / SLAB_UNITS;
  for (int slab = blockIdx.x; slab < n_slabs; slab += gridDim.x) {
    if constexpr (Q8) {
      const int K4 = Kd / 4;
      const unsigned char* w = static_cast<const unsigned char*>(wk_)
          + ((size_t)slab * K4 * SLAB_COLS + unit * 4) * 4;
      int acc[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0;
      int k = warp * 4 + ksub;
      for (; k + 3 * K_LANES < K4; k += 4 * K_LANES) {
        uint4 wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k + j * K_LANES) * SLAB_COLS * 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) dp4a_rows<NB>(acc, wv[j], in_q + (k + j * K_LANES) * NB);
      }
      for (; k < K4; k += K_LANES)
        dp4a_rows<NB>(acc, __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * SLAB_COLS * 4)),
                      in_q + k * NB);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          int v = acc[b][g];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          acc[b][g] = v;
        }
      if (ksub == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          reinterpret_cast<int4*>(red)[(warp * SLAB_UNITS + unit) * NB + b] =
              make_int4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      }
    } else {
      const T* w = static_cast<const T*>(wk_) + (size_t)slab * Kd * SLAB_COLS + unit * 4;
      float acc[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      int k = warp * 4 + ksub;
      for (; k + 3 * K_LANES < Kd; k += 4 * K_LANES) {
        float4 wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ldg4(w + (size_t)(k + j * K_LANES) * SLAB_COLS);
#pragma unroll
        for (int j = 0; j < 4; ++j) fma_rows<NB>(acc, wv[j], in_s + (k + j * K_LANES) * NB);
      }
      for (; k < Kd; k += K_LANES)
        fma_rows<NB>(acc, ldg4(w + (size_t)k * SLAB_COLS), in_s + k * NB);
      // the four k rows of a warp, then the warps in turn
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = acc[b][g];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          acc[b][g] = v;
        }
      if (ksub == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          reinterpret_cast<float4*>(red)[(warp * SLAB_UNITS + unit) * NB + b] =
              make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      }
    }
    __syncthreads();
    if (threadIdx.x < SLAB_UNITS * NB) {
      const int b = threadIdx.x / SLAB_UNITS, ul = threadIdx.x % SLAB_UNITS;
      if (b < B) {
        const int u = slab * SLAB_UNITS + ul;
        float4 pre;
        if constexpr (Q8) {
          int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
          for (int wi = 0; wi < WARPS; ++wi) {
            const int4 v = reinterpret_cast<const int4*>(red)[(wi * SLAB_UNITS + ul) * NB + b];
            z.x += v.x; z.y += v.y; z.z += v.z; z.w += v.w;
          }
          // (float(z) * row scale) * column scale + bias, in the TPU kernel's order
          const float rs = row_s[b];
          auto dq = [&](int zi, int col) {
            return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zi), rs), s_w[col]), bias[col]);
          };
          pre = make_float4(dq(z.x, u), dq(z.y, U + u), dq(z.z, 2 * U + u), dq(z.w, 3 * U + u));
        } else {
          float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int wi = 0; wi < WARPS; ++wi) {
            const float4 v = reinterpret_cast<const float4*>(red)[(wi * SLAB_UNITS + ul) * NB + b];
            z.x += v.x; z.y += v.y; z.z += v.z; z.w += v.w;
          }
          pre = make_float4(z.x + bias[u], z.y + bias[U + u], z.z + bias[2 * U + u],
                            z.w + bias[3 * U + u]);
        }
        const float gi = sigmoidf(pre.x);
        const float gf = sigmoidf(pre.y);
        const float gg = tanhf(pre.z);
        const float go = sigmoidf(pre.w);
        const size_t at = (size_t)b * U + u;
        const float c = gf * ldcg1(c_state + at) + gi * gg;
        c_state[at] = c;
        store1(h_out + at, go * tanhf(c));
      }
    }
    __syncthreads();
  }
}

// ---- row phases ---------------------------------------------------------------

// frame | gate of the step that just finished: [h_dec | ctx] @ proj_w + proj_b
template <typename T>
__device__ void project_row(const Params& p, const Layout& l, float* smem, int b,
                            int t, const T* h_dec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kd = p.U + p.D, NO = p.n_mel + 1;
  float* vec = smem + l.vec;
  float* fr = smem + l.fr;
  const T* ctx = static_cast<const T*>(p.ctx);
  for (int i = threadIdx.x; i < Kd; i += THREADS)
    vec[i] = i < p.U ? ldcg1(h_dec + (size_t)b * p.U + i)
                     : ldcg1(ctx + (size_t)b * p.D + (i - p.U));
  __syncthreads();
  const T* proj = static_cast<const T*>(p.proj_t);
  for (int j = warp; j < NO; j += WARPS) {
    const T* wr = proj + (size_t)j * Kd;
    float s = 0.f;
#pragma unroll 4
    for (int k = lane * 4; k < Kd; k += 128) {
      const float4 w = ldg4(wr + k);
      s += w.x * vec[k] + w.y * vec[k + 1] + w.z * vec[k + 2] + w.w * vec[k + 3];
    }
    s = warp_sum(s);
    if (lane == 0) {
      s += p.proj_b[j];
      if (j == p.n_mel) s = sigmoidf(s);
      fr[j] = s;
      p.steps[((size_t)t * p.B + b) * NO + j] = s;
      if (j < p.n_mel) p.frame[(size_t)b * p.n_mel + j] = s;
    }
  }
  __syncthreads();
}

// prenet of step t from the frame in smem: writes x (B, P1), rounded to T
template <typename T>
__device__ void prenet_row(const Params& p, const Layout& l, float* smem, int b, int t,
                           unsigned k0, unsigned k1) {
  float* fr = smem + l.fr;
  float* x0 = smem + l.x0;
  float* x1 = smem + l.x1;
  float* part = smem + l.part;
  const unsigned step = (unsigned)(p.step0 + t);
  for (int j = threadIdx.x; j < p.n_mel; j += THREADS) fr[j] = rounded<T>(fr[j]);
  __syncthreads();
  matvec<T>(static_cast<const T*>(p.w0), p.n_mel, p.P0, fr, x0, part);
  for (int i = threadIdx.x; i < p.P0; i += THREADS) {
    float v = fmaxf(x0[i] + p.b0[i] + p.extra[(size_t)b * p.P0 + i], 0.f);
    if (!p.deterministic)
      v = philox_word0(k0, k1, step, b, i, 0) >= p.drop_threshold ? v * p.drop_scale : 0.f;
    x0[i] = rounded<T>(v);
  }
  __syncthreads();
  matvec<T>(static_cast<const T*>(p.w1), p.P0, p.P1, x0, x1, part);
  for (int i = threadIdx.x; i < p.P1; i += THREADS) {
    float v = fmaxf(x1[i] + p.b1[i], 0.f);
    if (!p.deterministic)
      v = philox_word0(k0, k1, step, b, i, 1) >= p.drop_threshold ? v * p.drop_scale : 0.f;
    p.x[(size_t)b * p.P1 + i] = rounded<T>(v);
  }
  __syncthreads();
}

// location-sensitive attention and the context of step t for row b
template <typename T>
__device__ void attention_row(const Params& p, const Layout& l, float* smem, int b,
                              int t, const T* h_att) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, A = p.A, A_LD = up4(A);
  float* vec = smem + l.vec;
  float* pq = smem + l.pq;
  float* vw = smem + l.v;
  float* locw = smem + l.locw;
  float* prevp = smem + l.prevp;
  float* cump = smem + l.cump;
  float* e = smem + l.e;
  float* at = smem + l.attn;
  float* scratch = smem + l.scratch;
  float* prev = p.prev + (size_t)b * S;
  float* cum = p.cum + (size_t)b * S;

  for (int i = threadIdx.x; i < p.U; i += THREADS) vec[i] = ldcg1(h_att + (size_t)b * p.U + i);
  // the conv reads the alignments in T, zero outside [0, S)
  for (int i = threadIdx.x; i < S + 2 * LOC_PAD; i += THREADS) {
    const int s = i - LOC_PAD;
    const bool in = s >= 0 && s < S;
    prevp[i] = in ? rounded<T>(ldcg1(prev + s)) : 0.f;
    cump[i] = in ? rounded<T>(ldcg1(cum + s)) : 0.f;
  }
  const int main_prev = __ldcg(p.main_idx + b);
  __syncthreads();
  matvec<T>(static_cast<const T*>(p.q_w), p.U, A, vec, pq, smem + l.part);

  // energies: a warp per position, lanes over the attention dimension
  const T* pm = static_cast<const T*>(p.pm) + (size_t)b * S * A;
  for (int s = warp; s < S; s += WARPS) {
    float acc = 0.f;
    for (int a = lane * 4; a < A; a += 128) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* lw = locw + a;
#pragma unroll
      for (int k = 0; k < LOC_TAPS; ++k) {
        const float pv = prevp[s + k];
        const float4 w = *reinterpret_cast<const float4*>(lw + k * A_LD);
        f.x += pv * w.x; f.y += pv * w.y; f.z += pv * w.z; f.w += pv * w.w;
      }
#pragma unroll
      for (int k = 0; k < LOC_TAPS; ++k) {
        const float cv = cump[s + k];
        const float4 w = *reinterpret_cast<const float4*>(lw + (LOC_TAPS + k) * A_LD);
        f.x += cv * w.x; f.y += cv * w.y; f.z += cv * w.z; f.w += cv * w.w;
      }
      const float4 m = ldg4(pm + (size_t)s * A + a);
      const float4 q = *reinterpret_cast<const float4*>(pq + a);
      const float4 v = *reinterpret_cast<const float4*>(vw + a);
      acc += tanhf(q.x + m.x + f.x) * v.x + tanhf(q.y + m.y + f.y) * v.y
           + tanhf(q.z + m.z + f.z) * v.z + tanhf(q.w + m.w + f.w) * v.w;
    }
    acc = warp_sum(acc);
    if (lane == 0) e[s] = acc;
  }
  __syncthreads();

  // mask, window, softmax
  int lo = 0;
  if (p.use_window) {
    int center = max(main_prev, p.win_offset);
    center = min(center, p.enc_len[b] - p.win_len + p.win_offset);
    lo = center - p.win_offset;
  }
  float local_max = -3.0e38f;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    bool keep = p.mask[(size_t)b * S + s] > 0.f;
    if (p.use_window) keep = keep && s >= lo && s <= lo + p.win_len;
    const float v = keep ? e[s] : -1e9f;
    e[s] = v;
    local_max = fmaxf(local_max, v);
  }
  const float e_max = block_max(local_max, scratch);
  float local_sum = 0.f;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float v = expf(e[s] - e_max);
    e[s] = v;
    local_sum += v;
  }
  const float total = block_sum(local_sum, scratch);

  // alignments, cumulative alignments, argmax (the first index on ties)
  float best = -1.f;
  int best_at = 0x7fffffff;
  float* attn_out = p.attn + ((size_t)t * p.B + b) * S;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float a = e[s] / total;
    at[s] = rounded<T>(a);
    attn_out[s] = a;
    cum[s] = ldcg1(cum + s) + a;
    prev[s] = a;
    if (a > best) { best = a; best_at = s; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_at, o);
    if (ov > best || (ov == best && oi < best_at)) { best = ov; best_at = oi; }
  }
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = best;
    scratch[WARPS + warp] = __int_as_float(best_at);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      const float ov = scratch[w];
      const int oi = __float_as_int(scratch[WARPS + w]);
      if (ov > best || (ov == best && oi < best_at)) { best = ov; best_at = oi; }
    }
    p.main_idx[b] = best_at;
  }

  // context: the product in T, the sum in f32
  const T* mem = static_cast<const T*>(p.mem) + (size_t)b * S * p.D;
  T* ctx = static_cast<T*>(p.ctx) + (size_t)b * p.D;
  for (int d = threadIdx.x; d < p.D; d += THREADS) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) acc += rounded<T>(at[s] * ldg1(mem + (size_t)s * p.D + d));
    store1(ctx + d, acc);
  }
  __syncthreads();
}

// ---- the kernel ---------------------------------------------------------------

template <typename T, int NB, bool Q8>
__global__ void __launch_bounds__(THREADS, 1) decoder_steps_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Layout l = make_layout(NB, p.S, p.n_mel, p.P0, p.P1, p.D, p.U, p.A);
  float* in_s = smem + l.in_s;
  int* in_q = reinterpret_cast<int*>(smem + l.in_q);
  float* row_s = smem + l.row_s;
  float* red = smem + l.red;

  // batch rows are dealt to the last blocks of the grid, which own no slab
  // when the grid is larger than the number of slabs
  const int first_row = gridDim.x - 1 - blockIdx.x;
  const bool owns_row = first_row < p.B;

  unsigned k0 = 0, k1 = 0;
  if (owns_row) {
    const int A_LD = up4(p.A);
    const T* loc_w = static_cast<const T*>(p.loc_w);
    for (int i = threadIdx.x; i < 2 * LOC_TAPS * A_LD; i += THREADS) {
      const int j = i / A_LD, a = i - j * A_LD;
      smem[l.locw + i] = a < p.A ? ldg1(loc_w + (size_t)j * p.A + a) : 0.f;
    }
    for (int i = threadIdx.x; i < A_LD; i += THREADS)
      smem[l.v + i] = i < p.A ? p.v_w[i] : 0.f;
    if (!p.deterministic) {
      const unsigned long long seed = (unsigned long long)p.seed[0];
      k0 = (unsigned)seed;
      k1 = (unsigned)(seed >> 32);
    }
    __syncthreads();
  }

  // stamps: before and after each of a step's four barriers
  long long* stamps = first_row == 0 ? p.stamps : nullptr;
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[8 * p.K] = globaltimer_ns();
    stamps[8 * p.K + 1] = clock64();
  }

  T* h_att[2] = {static_cast<T*>(p.h_att), static_cast<T*>(p.h_att_alt)};
  T* h_dec[2] = {static_cast<T*>(p.h_dec), static_cast<T*>(p.h_dec_alt)};
  const T* ctx = static_cast<const T*>(p.ctx);
  const int k_att = p.P1 + p.D + p.U, k_dec = 2 * p.U + p.D;

  for (int t = 0; t <= p.K; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    for (int b = first_row; b < p.B; b += gridDim.x) {
      if (t > 0) {
        project_row<T>(p, l, smem, b, t - 1, h_dec[cur]);
      } else {
        for (int j = threadIdx.x; j < p.n_mel; j += THREADS)
          smem[l.fr + j] = ldcg1(p.frame + (size_t)b * p.n_mel + j);
        __syncthreads();
      }
      if (t < p.K) prenet_row<T>(p, l, smem, b, t, k0, k1);
    }
    if (t == p.K) break;
    stamp(stamps, 8 * t);
    grid.sync();
    stamp(stamps, 8 * t + 1);

    stage<NB>(in_s, 0, p.x, p.P1, p.B);
    stage<NB>(in_s, p.P1, ctx, p.D, p.B);
    stage<NB>(in_s, p.P1 + p.D, h_att[cur], p.U, p.B);
    __syncthreads();
    if constexpr (Q8) quantize_rows<NB>(in_s, k_att, in_q, row_s, red);
    lstm_slabs<T, NB, Q8>(p.att_k, p.att_b, p.s_att, k_att, p.U, p.B, in_s, in_q, row_s,
                          red, p.c_att, h_att[nxt]);
    stamp(stamps, 8 * t + 2);
    grid.sync();
    stamp(stamps, 8 * t + 3);

    for (int b = first_row; b < p.B; b += gridDim.x)
      attention_row<T>(p, l, smem, b, t, h_att[nxt]);
    stamp(stamps, 8 * t + 4);
    grid.sync();
    stamp(stamps, 8 * t + 5);

    stage<NB>(in_s, 0, h_att[nxt], p.U, p.B);
    stage<NB>(in_s, p.U, ctx, p.D, p.B);
    stage<NB>(in_s, p.U + p.D, h_dec[cur], p.U, p.B);
    __syncthreads();
    if constexpr (Q8) quantize_rows<NB>(in_s, k_dec, in_q, row_s, red);
    lstm_slabs<T, NB, Q8>(p.dec_k, p.dec_b, p.s_dec, k_dec, p.U, p.B, in_s, in_q, row_s,
                          red, p.c_dec, h_dec[nxt]);
    stamp(stamps, 8 * t + 6);
    grid.sync();
    stamp(stamps, 8 * t + 7);
  }
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[8 * p.K + 2] = globaltimer_ns();
    stamps[8 * p.K + 3] = clock64();
  }

  // after an odd number of steps the newest h is in the second buffers
  if (p.K & 1) {
    const int n = p.B * p.U;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
      store1(h_att[0] + i, ldcg1(h_att[1] + i));
      store1(h_dec[0] + i, ldcg1(h_dec[1] + i));
    }
  }
}

template <typename T, int NB, bool Q8>
int launch(const Params& p, cudaStream_t stream) {
  const Layout l = make_layout(NB, p.S, p.n_mel, p.P0, p.P1, p.D, p.U, p.A);
  const int smem = l.total * (int)sizeof(float);
  auto kernel = decoder_steps_kernel<T, NB, Q8>;
  int device = 0, sms = 0, smem_max = 0, cooperative = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (!cooperative) return (int)cudaErrorNotSupported;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident, or the grid barrier would never complete
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params params = p;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms), dim3(THREADS), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool Q8>
int launch_rows(const Params& p, cudaStream_t stream) {
  if (p.B <= 1) return launch<T, 1, Q8>(p, stream);
  if (p.B <= 2) return launch<T, 2, Q8>(p, stream);
  if (p.B <= 4) return launch<T, 4, Q8>(p, stream);
  return launch<T, 8, Q8>(p, stream);
}

template <typename T>
int launch_mode(const Params& p, bool int8, cudaStream_t stream) {
  if (int8) return launch_rows<T, true>(p, stream);
  return launch_rows<T, false>(p, stream);
}

}  // namespace

// ptrs, in order: w0, w1, att_k, q_w, loc_w, dec_k, proj_t (T); b0, b1,
// att_b, v_w, dec_b, proj_b (f32); mem, pm (T); mask (f32), enc_len (i32),
// extra (f32), seed (i64); frame (f32), h_att (T), c_att (f32), h_dec (T),
// c_dec (f32), ctx (T), prev, cum (f32), main (i32); x (f32), h_att_alt,
// h_dec_alt (T); steps, attn (f32); stamps (i64, 8 K + 4, or null);
// s_att, s_dec (f32, 4U, in the logical column order; null unless int8).
// ints, in order: is_bf16, B, S, n_mel, P0, P1, D, U, A, K, step0,
// deterministic, use_window, win_len, win_offset, drop_threshold, int8.
// Layouts: att_k / dec_k (U / 8, K, 32) slabs with column 4 * unit + gate,
// in T, or with int8 (U / 8, K / 4, 32, 4);
// proj_t (n_mel + 1, U + D); every other array as its logical shape,
// row-major.  Requires B <= 8, U % 8 == 0, P0, P1, A, U + D multiples of 4
// and at most 2048, and 16-byte aligned pointers.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int decoder_steps_forward(const void* const* ptrs, const long long* ints,
                                     float drop_scale, void* stream) {
  Params p;
  int i = 0;
  p.w0 = ptrs[i++]; p.w1 = ptrs[i++]; p.att_k = ptrs[i++]; p.q_w = ptrs[i++];
  p.loc_w = ptrs[i++]; p.dec_k = ptrs[i++]; p.proj_t = ptrs[i++];
  p.b0 = (const float*)ptrs[i++]; p.b1 = (const float*)ptrs[i++];
  p.att_b = (const float*)ptrs[i++]; p.v_w = (const float*)ptrs[i++];
  p.dec_b = (const float*)ptrs[i++]; p.proj_b = (const float*)ptrs[i++];
  p.mem = ptrs[i++]; p.pm = ptrs[i++];
  p.mask = (const float*)ptrs[i++]; p.enc_len = (const int*)ptrs[i++];
  p.extra = (const float*)ptrs[i++]; p.seed = (const long long*)ptrs[i++];
  p.frame = (float*)ptrs[i++]; p.h_att = (void*)ptrs[i++]; p.c_att = (float*)ptrs[i++];
  p.h_dec = (void*)ptrs[i++]; p.c_dec = (float*)ptrs[i++]; p.ctx = (void*)ptrs[i++];
  p.prev = (float*)ptrs[i++]; p.cum = (float*)ptrs[i++]; p.main_idx = (int*)ptrs[i++];
  p.x = (float*)ptrs[i++]; p.h_att_alt = (void*)ptrs[i++]; p.h_dec_alt = (void*)ptrs[i++];
  p.steps = (float*)ptrs[i++]; p.attn = (float*)ptrs[i++];
  p.stamps = (long long*)ptrs[i++];
  p.s_att = (const float*)ptrs[i++]; p.s_dec = (const float*)ptrs[i++];
  const bool is_bf16 = ints[0] != 0, int8 = ints[16] != 0;
  p.B = (int)ints[1]; p.S = (int)ints[2]; p.n_mel = (int)ints[3]; p.P0 = (int)ints[4];
  p.P1 = (int)ints[5]; p.D = (int)ints[6]; p.U = (int)ints[7]; p.A = (int)ints[8];
  p.K = (int)ints[9]; p.step0 = (int)ints[10]; p.deterministic = (int)ints[11];
  p.use_window = (int)ints[12]; p.win_len = (int)ints[13]; p.win_offset = (int)ints[14];
  p.drop_threshold = (unsigned)ints[15];
  p.drop_scale = drop_scale;
  const int limit = 4 * THREADS;
  if (p.B < 1 || p.B > MAX_ROWS || p.S < 1 || p.K < 0 || p.U % SLAB_UNITS ||
      p.P0 % 4 || p.P1 % 4 || p.A % 4 || (p.U + p.D) % 4 || p.P0 > limit ||
      p.P1 > limit || p.A > limit)
    return (int)cudaErrorInvalidValue;
  if (int8 && (p.s_att == nullptr || p.s_dec == nullptr || p.D % 4))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch_mode<__nv_bfloat16>(p, int8, (cudaStream_t)stream);
  return launch_mode<float>(p, int8, (cudaStream_t)stream);
}
