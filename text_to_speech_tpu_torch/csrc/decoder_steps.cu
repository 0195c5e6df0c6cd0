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
// What bounds it.  At NVIDIA width the two LSTM weights are 18.2 M values
// (72.7 MB in f32, 36.4 in bf16, 18.2 in int8); with at most 8 rows their
// products are matrix-vector work, bound by bytes, and the steps are a
// serial chain.  The TPU kernel keeps every weight in VMEM for the whole
// launch.  Here each SM keeps what fits of its share in shared memory, and
// the rest of a step is a chain of short phases bound by latency.
//
// Design.  One persistent grid, one block of 512 threads on every SM,
// launched cooperatively so that every block is resident.  A step is seven
// phases, each closed by a grid barrier and each dealt over the grid as
// independent items:
//   prenet_0   : 16-column items of the prenet's first layer (all rows);
//   prenet_1   : 16-column items of its second layer;
//   att_lstm   : block s owns slab s of the attention LSTM (8 units), and
//                folds its 8 new h_att values with its 8 rows of q_w into a
//                partial pq (A values a row);
//   energies   : (row, 16 attention columns, 64 positions): pq from the
//                slabs' partials, the location conv, tanh and v, a partial
//                energy per position;
//   context    : (row, 32 memory columns): the energies from their
//                partials, mask, window, softmax, the context columns, and
//                their fold with the ctx rows of proj_w (a partial frame);
//                the item of the first columns writes the alignments and
//                the argmax;
//   dec_lstm   : block s owns slab s of the decoder LSTM, and folds its 8
//                new h_dec values with its 8 rows of proj_w;
//   frame      : (row, 8 columns): the frame and gate from the partials.
// Partial sums are combined in a fixed order (no float atomics), so the
// results do not depend on timing and 2 x 32 steps equal 64 to the bit.
// Loads that do not depend on the previous phase are issued first, a
// thread keeping several in flight, since each phase is a few round trips.
// The grid barrier is a count in device memory: bar.sync, a release add by
// thread 0, acquire reads until every block has added (trapping after 2^22
// reads instead of hanging the card).
//
// Residency.  An LSTM weight is packed into slabs of 8 units: slab s holds,
// for every input k, the 32 columns (i, f, g, o) x 8 units contiguously (in
// int8, groups of 4 k rows, each column as its 4 bytes).  At launch each
// block copies the first rows of its two slabs, with its q_w and proj_w
// rows, into shared memory (one cp.async.bulk each, completing on an
// mbarrier that the LSTM phases wait on); how many rows is computed on the
// host from the 227 KB the phases' work area leaves.  The rest of each slab
// is read in its LSTM phase, where every block streams at once, with
// 16-byte loads that skip L1 and are evict-first in L2, 128 bytes a thread
// in flight: the L2 keeps the row phases' working set.  In int8 mode every
// weight fits at NVIDIA width.  Streaming the slabs' tails during the row
// phases instead (while their items run on other blocks) made those items,
// which are bound by latency, several times slower, and a ring of bulk
// copies refilled stage by stage streamed at a fraction of these loads'
// rate inside the kernel (see PERF.md).
//
// Dropout keeps a value iff philox4x32-10(key = seed, counter = (absolute
// step, row, unit, layer)) word 0 >= threshold: independent of the grid, of
// the launch length and of the block that computes it.
//
// int8 LSTM mode (the TPU kernel's `int8_lstm`): att_w and dec_w are int8
// with one f32 scale per output column.  Every block quantizes the input row
// [x | ctx | h] itself from device memory (scale = max(amax, 1e-8) * (1/127),
// q = rint(x / scale) clipped to 127); the products are __dp4a on 4 int8 k
// values against 4 int8 weights with int32 sums, exact in any order, and
// z = float(sum) * row scale * column scale + bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "wn_wgmma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLAB_UNITS = 8;               // LSTM units per weight slab
constexpr int SLAB_COLS = 4 * SLAB_UNITS;   // gate columns per slab
constexpr int K_LANES = 4 * WARPS;          // k rows in flight per block
constexpr int LOC_TAPS = 31;
constexpr int LOC_PAD = LOC_TAPS / 2;
constexpr int MAX_ROWS = 8;
constexpr int ATT_COLS = 16;                // attention columns of an energies item
constexpr int CTX_COLS = 32;                // memory columns of a context item
constexpr int PRE_COLS = 16;                // output columns of a prenet item
constexpr int LOADS = 8;                    // independent loads a thread keeps in flight
constexpr int ENERGY_POS = 64;              // positions of an energies item
constexpr int FRAME_COLS = 8;               // output columns of a frame item
constexpr int SUB_FLOATS = 4096;            // input values staged at once (f32, bf16)
constexpr int N_PHASES = 7;

static_assert(WARPS == ATT_COLS, "an energies item gives a warp to each column");

// Shared-memory plan of a launch, computed on the host.  Offsets in bytes;
// a "unit" of a slab is one k row (f32, bf16) or a group of 4 (int8).
struct Plan {
  int smem, off_res_att, off_res_dec, off_q, off_pw, off_bar, off_work;
  int unit, k_att_units, k_dec_units, res_att, res_dec;
  int sub_rows;   // f32, bf16: input rows staged at once
  int n_slabs, n_att_items, n_pos_items, n_ctx_items, n_frame_items, grid;
  // scratch, in floats: prenet layer 0, pq partials, energy partials, frame
  // partials, argmax (int), the grid barrier's count (unsigned, zero at launch)
  int sc_x0, sc_pq, sc_e, sc_proj, sc_main, sc_bar, sc_total;
};

struct Params {
  // weights (T unless float)
  const void *w0, *w1, *att_k, *q_w, *loc_w, *dec_k, *proj_w;
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
  float* scratch;
  // outputs
  float *steps, *attn;
  // optional (may be null): clock stamps of block 0, two a phase (its work
  // done, the barrier passed), then (globaltimer ns, clock) at the start
  // and at the end
  long long* stamps;
  // int8 LSTM mode: per-column scales of att_w and dec_w (null otherwise)
  const float *s_att, *s_dec;
  int B, S, n_mel, P0, P1, D, U, A, K, step0;
  int deterministic, use_window, win_len, win_offset;
  unsigned drop_threshold;
  float drop_scale;
  Plan plan;
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
__device__ inline float4 bf16x4(uint2 r) {
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}
__device__ inline float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// shared memory
__device__ inline float lds1(const float* p) { return *p; }
__device__ inline float lds1(const __nv_bfloat16* p) {
  return bf16_bits_to_float(*reinterpret_cast<const unsigned short*>(p));
}
__device__ inline float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 lds4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
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

__device__ inline void stamp(long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[i] = clock64();
}

__device__ inline long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// one contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(hop::smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes),
         "r"(hop::smem_u32(bar))
      : "memory");
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

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int up128(int n) { return (n + 127) & ~127; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// store(i, load(i)) for i in [0, n), LOADS loads a thread in flight before
// the first store: the phases' staging is bound by latency, not bytes
template <typename Load, typename Store>
__device__ inline void gather(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += LOADS * THREADS) {
    float v[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = i0 + j * THREADS;
      v[j] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) store(i, v[j]);
    }
  }
}

// sum over i in [first, n) step `step` of load(i), in that order, four
// loads in flight
template <typename Load>
__device__ inline float strided_sum(int first, int n, int step, Load load) {
  float s = 0.f;
  for (int i0 = first; i0 < n; i0 += 4 * step) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i0 + j * step < n ? load(i0 + j * step) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[j];
  }
  return s;
}

// ---- the grid barrier ---------------------------------------------------------------
// A count in device memory, zero at launch: every block adds one when it
// reaches barrier n and waits until the count reaches G (n + 1): a release
// add after the block's barrier, acquire reads until then.  The wait traps
// after 2^22 reads instead of hanging the card.

__device__ inline void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(count) : "memory");
    for (unsigned tries = 0;; ++tries) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (tries == (1u << 22)) __trap();
    }
  }
  __syncthreads();
}

// ---- LSTM phase -----------------------------------------------------------------

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

// rows [0, rows) of a slab span in shared memory against the staged input
// (in_s[k * NB + b], from the span's first row): thread (warp, k lane,
// unit) takes rows warp * 4 + k lane + 64 j, its unit's four gate columns
template <typename T, int NB>
__device__ inline void fma_span(float (&acc)[NB][4], const T* w, int rows, const float* in_s) {
  const int lane = threadIdx.x & 31;
  const T* wu = w + (lane & (SLAB_UNITS - 1)) * 4;
  int r = (threadIdx.x >> 5) * 4 + (lane >> 3);
  for (; r + K_LANES < rows; r += 2 * K_LANES) {
    const float4 a = lds4(wu + r * SLAB_COLS);
    const float4 b = lds4(wu + (r + K_LANES) * SLAB_COLS);
    fma_rows<NB>(acc, a, in_s + r * NB);
    fma_rows<NB>(acc, b, in_s + (r + K_LANES) * NB);
  }
  if (r < rows) fma_rows<NB>(acc, lds4(wu + r * SLAB_COLS), in_s + r * NB);
}

// the same for int8 groups of 4 k rows against in_q[g * NB + b]
template <int NB>
__device__ inline void dp4a_span(int (&acc)[NB][4], const unsigned char* w, int groups,
                                 const int* in_q) {
  const int lane = threadIdx.x & 31;
  const unsigned char* wu = w + (lane & (SLAB_UNITS - 1)) * 16;
  int g = (threadIdx.x >> 5) * 4 + (lane >> 3);
  for (; g + K_LANES < groups; g += 2 * K_LANES) {
    const uint4 a = *reinterpret_cast<const uint4*>(wu + g * SLAB_COLS * 4);
    const uint4 b = *reinterpret_cast<const uint4*>(wu + (g + K_LANES) * SLAB_COLS * 4);
    dp4a_rows<NB>(acc, a, in_q + g * NB);
    dp4a_rows<NB>(acc, b, in_q + (g + K_LANES) * NB);
  }
  if (g < groups)
    dp4a_rows<NB>(acc, *reinterpret_cast<const uint4*>(wu + g * SLAB_COLS * 4), in_q + g * NB);
}

// Weights streamed from device memory, read once a step: past L1 (which
// the shared memory leaves at ~28 KB) and evict-first in L2, so that the
// stream leaves the row phases' working set there.
__device__ inline uint64_t evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
__device__ inline float4 ld_stream(const float* p, uint64_t policy) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(__cvta_generic_to_global(p)), "l"(policy));
  return v;
}
__device__ inline uint2 ld_stream(const __nv_bfloat16* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(__cvta_generic_to_global(p)), "l"(policy));
  return v;
}
__device__ inline uint4 ld_stream(const unsigned char* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(__cvta_generic_to_global(p)), "l"(policy));
  return v;
}
__device__ inline float4 widen(float4 v) { return v; }
__device__ inline float4 widen(uint2 v) { return bf16x4(v); }

// the same spans from device memory: the rows past the resident ones; a
// thread keeps 128 bytes of its rows in flight (kept as loaded until used)
template <typename T, int NB>
__device__ inline void fma_span_dev(float (&acc)[NB][4], const T* w, int rows, const float* in_s) {
  constexpr int N = 32 / sizeof(T);
  using Raw = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
  const uint64_t policy = evict_first();
  const int lane = threadIdx.x & 31;
  const T* wu = w + (lane & (SLAB_UNITS - 1)) * 4;
  for (int r0 = (threadIdx.x >> 5) * 4 + (lane >> 3); r0 < rows; r0 += N * K_LANES) {
    Raw v[N];
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (r0 + u * K_LANES < rows) v[u] = ld_stream(wu + (size_t)(r0 + u * K_LANES) * SLAB_COLS, policy);
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (r0 + u * K_LANES < rows) fma_rows<NB>(acc, widen(v[u]), in_s + (r0 + u * K_LANES) * NB);
  }
}

template <int NB>
__device__ inline void dp4a_span_dev(int (&acc)[NB][4], const unsigned char* w, int groups,
                                     const int* in_q) {
  const uint64_t policy = evict_first();
  const int lane = threadIdx.x & 31;
  const unsigned char* wu = w + (lane & (SLAB_UNITS - 1)) * 16;
  for (int g0 = (threadIdx.x >> 5) * 4 + (lane >> 3); g0 < groups; g0 += LOADS * K_LANES) {
    uint4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int g = g0 + u * K_LANES;
      v[u] = g < groups ? ld_stream(wu + (size_t)g * SLAB_COLS * 4, policy) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (g0 + u * K_LANES < groups) dp4a_rows<NB>(acc, v[u], in_q + (g0 + u * K_LANES) * NB);
  }
}

// The three segments of an LSTM's input row, (B, len) arrays each.
template <typename V0, typename T>
struct Segments {
  const V0* s0; const T* s1; const T* s2;
  int l0, l1, l2;
  __device__ int size() const { return l0 + l1 + l2; }
  __device__ float value(int b, int k) const {
    if (k < l0) return ldcg1(s0 + (size_t)b * l0 + k);
    k -= l0;
    if (k < l1) return ldcg1(s1 + (size_t)b * l1 + k);
    return ldcg1(s2 + (size_t)b * l2 + (k - l1));
  }
};

// f32 and bf16: rows [0, B) of input elements [r0, r1) into
// in_s[(k - r0) * NB + b], rows [B, NB) as zero
template <int NB, typename V0, typename T>
__device__ void stage_range(const Segments<V0, T>& in, int B, int r0, int r1, float* in_s) {
  const int n = r1 - r0;
  gather(n * NB,
         [&](int i) { const int b = i / n; return b < B ? in.value(b, r0 + i - b * n) : 0.f; },
         [&](int i, float v) { const int b = i / n; in_s[(i - b * n) * NB + b] = v; });
  __syncthreads();
}

__device__ inline int quant8(float v) { return max(-127, min(127, __float2int_rn(v))); }

// int8 LSTM mode: rows [0, B) of the input row → in_q[k4 * NB + b], the int8
// values of k rows 4 k4 .. 4 k4 + 3 packed in one word, and their scales
// row_s[b].  Read from device memory twice (the amax, then the values), so
// no f32 copy of the row takes shared memory.  Every block computes the same
// values from the same rows.
template <int NB, typename V0, typename T>
__device__ void quantize_rows(const Segments<V0, T>& in, int B, int* in_q, float* row_s,
                              float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kd = in.size();
  // element i is (k = i / NB, b = i % NB): THREADS and 32 are multiples of
  // NB, so a thread sees one row, b = tid % NB
  const int b_own = threadIdx.x % NB;
  float amax = 0.f;
  if (b_own < B) {
    for (int k0 = threadIdx.x / NB; k0 < Kd; k0 += LOADS * (THREADS / NB)) {
      float v[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int k = k0 + j * (THREADS / NB);
        v[j] = k < Kd ? fabsf(in.value(b_own, k)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LOADS; ++j) amax = fmaxf(amax, v[j]);
    }
  }
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
  const int n4 = Kd / 4 * NB;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 2 * THREADS) {
    float v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * THREADS, k4 = i / NB, b = i - k4 * NB;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[h][j] = i < n4 && b < B ? in.value(b, 4 * k4 + j) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * THREADS, k4 = i / NB, b = i - k4 * NB;
      if (i >= n4) continue;
      unsigned word = 0;
      if (b < B) {
        const float sc = row_s[b];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (unsigned)(quant8(__fdiv_rn(v[h][j], sc)) & 0xff) << (8 * j);
      }
      in_q[i] = (int)word;
    }
  }
  __syncthreads();
}

// int8: groups [0, G) of this block's slab `seg` (0 attention, 1 decoder)
// against in_q[g * NB + b]: the resident groups from shared memory, the rest
// from device memory (`w_dev`: the slab's first byte there)
template <int NB>
__device__ void slab_rows_q8(int (&acc)[NB][4], const Params& p, const unsigned char* smem,
                             const unsigned char* w_dev, int seg, int G, const int* in_q) {
  const Plan& pl = p.plan;
  const int R = min(G, seg ? pl.res_dec : pl.res_att);
  dp4a_span<NB>(acc, smem + (seg ? pl.off_res_dec : pl.off_res_att), R, in_q);
  if (R < G) dp4a_span_dev<NB>(acc, w_dev + (size_t)R * pl.unit, G - R, in_q + R * NB);
}

// f32 and bf16: rows [r0, r1) of slab `seg` against the input row, in
// pieces of at most SUB_FLOATS / NB staged rows; the resident rows from
// shared memory, the rest from device memory
template <typename T, int NB, typename V0>
__device__ void slab_range(float (&acc)[NB][4], const Params& p, const unsigned char* smem,
                           const unsigned char* w_dev, int seg, int r0, int r1,
                           const Segments<V0, T>& in, float* in_s) {
  const Plan& pl = p.plan;
  const int R = seg ? pl.res_dec : pl.res_att;
  const unsigned char* res_w = smem + (seg ? pl.off_res_dec : pl.off_res_att);
  for (int r = r0; r < r1;) {
    const int e = min(r1, r + pl.sub_rows);
    const int r_res = min(e, R), r_dev = max(r, R);
    stage_range<NB>(in, p.B, r, e, in_s);
    if (r < r_res)
      fma_span<T, NB>(acc, reinterpret_cast<const T*>(res_w + (size_t)r * pl.unit), r_res - r, in_s);
    if (r_dev < e)
      fma_span_dev<T, NB>(acc, reinterpret_cast<const T*>(w_dev + (size_t)r_dev * pl.unit),
                          e - r_dev, in_s + (r_dev - r) * NB);
    __syncthreads();   // before in_s is staged again
    r = e;
  }
}

// the four k lanes of a warp, then red[(warp * 8 + unit) * NB + b]
template <int NB, typename Acc>
__device__ inline void reduce_k_lanes(Acc (&acc)[NB][4], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      Acc v = acc[b][g];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][g] = v;
    }
  if (lane < SLAB_UNITS) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if constexpr (std::is_same<Acc, int>::value)
        reinterpret_cast<int4*>(red)[(warp * SLAB_UNITS + lane) * NB + b] =
            make_int4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      else
        reinterpret_cast<float4*>(red)[(warp * SLAB_UNITS + lane) * NB + b] =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
  }
  __syncthreads();
}

// the 16 warps' partial sums of (unit ul, row b), in order
template <int NB>
__device__ inline float4 sum_warps(const float* red, int ul, int b) {
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int wi = 0; wi < WARPS; ++wi) {
    const float4 v = reinterpret_cast<const float4*>(red)[(wi * SLAB_UNITS + ul) * NB + b];
    z.x += v.x; z.y += v.y; z.z += v.z; z.w += v.w;
  }
  return z;
}
template <int NB>
__device__ inline int4 sum_warps_int(const float* red, int ul, int b) {
  int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int wi = 0; wi < WARPS; ++wi) {
    const int4 v = reinterpret_cast<const int4*>(red)[(wi * SLAB_UNITS + ul) * NB + b];
    z.x += v.x; z.y += v.y; z.z += v.z; z.w += v.w;
  }
  return z;
}

// The LSTM phase of this block's slab: z = input @ W + bias for its 8 units,
// the pointwise update (c (B, U) f32 in place, h_out (B, U) in T), and the
// fold of the 8 new h values with the slab's 8 rows of `fold_w` (8, N) in
// shared memory into fold_out[(slab * B + b) * N + n].
template <typename T, int NB, bool Q8, typename V0>
__device__ void lstm_phase(const Params& p, unsigned char* smem, const unsigned char* w_dev,
                           int seg, const Segments<V0, T>& in, const float* __restrict__ bias,
                           const float* __restrict__ s_w, float* c_state, T* h_out,
                           const T* fold_w, int N, float* fold_out) {
  const Plan& pl = p.plan;
  const int slab = blockIdx.x, B = p.B, U = p.U;
  unsigned char* work = smem + pl.off_work;
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(smem + pl.off_bar);

  // work area: staged input (or its int8 words and row scales), the k-lane
  // partial sums, the new h values
  float* in_s = reinterpret_cast<float*>(work);
  int* in_q = reinterpret_cast<int*>(work);
  const int in_floats = Q8 ? up4(in.size() / 4 * NB) : up4(pl.sub_rows * NB);
  float* row_s = in_s + in_floats;
  float* red = row_s + MAX_ROWS;
  float* hbuf = red + WARPS * SLAB_UNITS * NB * 4;

  // the pointwise update's operands, loaded ahead of the products
  const int pb = threadIdx.x / SLAB_UNITS, pu = slab * SLAB_UNITS + threadIdx.x % SLAB_UNITS;
  const bool pointwise = threadIdx.x < SLAB_UNITS * NB && pb < B;
  float c_prev = 0.f, bias4[4] = {0.f, 0.f, 0.f, 0.f}, scale4[4] = {0.f, 0.f, 0.f, 0.f};
  if (pointwise) {
    c_prev = ldcg1(c_state + (size_t)pb * U + pu);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bias4[g] = bias[g * U + pu];
      if constexpr (Q8) scale4[g] = s_w[g * U + pu];
    }
  }
  hop::mbar_wait(res_bar, 0);
  using Acc = typename std::conditional<Q8, int, float>::type;
  Acc acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0;
  if constexpr (Q8) {
    quantize_rows<NB>(in, B, in_q, row_s, red);
    slab_rows_q8<NB>(acc, p, smem, w_dev, seg, seg ? pl.k_dec_units : pl.k_att_units, in_q);
  } else {
    slab_range<T, NB>(acc, p, smem, w_dev, seg, 0, in.size(), in, in_s);
  }
  reduce_k_lanes<NB>(acc, red);
  if (threadIdx.x < SLAB_UNITS * NB) {
    const int ul = threadIdx.x % SLAB_UNITS;
    float h = 0.f;
    if (pointwise) {
      float4 pre;
      if constexpr (Q8) {
        const int4 z = sum_warps_int<NB>(red, ul, pb);
        // (float(z) * row scale) * column scale + bias, in the TPU kernel's order
        const float rs = row_s[pb];
        auto dq = [&](int zi, int g) {
          return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zi), rs), scale4[g]), bias4[g]);
        };
        pre = make_float4(dq(z.x, 0), dq(z.y, 1), dq(z.z, 2), dq(z.w, 3));
      } else {
        const float4 z = sum_warps<NB>(red, ul, pb);
        pre = make_float4(z.x + bias4[0], z.y + bias4[1], z.z + bias4[2], z.w + bias4[3]);
      }
      const float gi = sigmoidf(pre.x);
      const float gf = sigmoidf(pre.y);
      const float gg = tanhf(pre.z);
      const float go = sigmoidf(pre.w);
      const size_t at = (size_t)pb * U + pu;
      const float c = gf * c_prev + gi * gg;
      c_state[at] = c;
      h = rounded<T>(go * tanhf(c));
      store1(h_out + at, h);
    }
    hbuf[threadIdx.x] = h;
  }
  __syncthreads();
  // the fold: 8 units of h against the slab's 8 rows of fold_w
  for (int i = threadIdx.x; i < B * N; i += THREADS) {
    const int b = i / N, n = i - b * N;
    float s = 0.f;
#pragma unroll
    for (int ul = 0; ul < SLAB_UNITS; ++ul) s += hbuf[b * SLAB_UNITS + ul] * lds1(fold_w + ul * N + n);
    fold_out[((size_t)slab * B + b) * N + n] = s;
  }
  __syncthreads();
}

// ---- row phases, dealt over the grid ------------------------------------------------

// out[b][c] = sum_k in_s[k * NB + b] * W[k][c0 + c] for the PRE_COLS columns
// from c0 (W (Kd, ld) row-major, ld % 4 == 0): 4 column quads x 128 k lanes,
// summed over the k lanes of a warp, then over the warps in turn
template <typename T, int NB>
__device__ void cols_matvec(const T* __restrict__ W, int ld, int Kd, int c0, const float* in_s,
                            float* out, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = threadIdx.x & 3, col = c0 + 4 * q;
  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
  constexpr int KL = THREADS / 4;
  if (col < ld)
    for (int k = threadIdx.x >> 2; k < Kd; k += 2 * KL) {
      const float4 w0 = ldg4(W + (size_t)k * ld + col);
      const float4 w1 = k + KL < Kd ? ldg4(W + (size_t)(k + KL) * ld + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      fma_rows<NB>(acc, w0, in_s + k * NB);
      if (k + KL < Kd) fma_rows<NB>(acc, w1, in_s + (k + KL) * NB);
    }
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = acc[b][g];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][g] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      reinterpret_cast<float4*>(red)[(warp * 4 + q) * NB + b] =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NB * PRE_COLS; i += THREADS) {
    const int b = i / PRE_COLS, c = i - b * PRE_COLS;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[((w * 4 + c / 4) * NB + b) * 4 + (c & 3)];
    out[i] = s;
  }
  __syncthreads();
}

// one prenet layer of step t, its output columns dealt over the grid:
// layer 0 reads the frame (rounded to T) and writes x0, layer 1 reads x0 and
// writes x, each rounded to T after its dropout
template <typename T, int NB>
__device__ void prenet_phase(const Params& p, unsigned char* work, int t, int layer, unsigned k0,
                             unsigned k1) {
  const Plan& pl = p.plan;
  const int Kd = layer ? p.P0 : p.n_mel, N = layer ? p.P1 : p.P0;
  float* x0 = p.scratch + pl.sc_x0;
  float* in_s = reinterpret_cast<float*>(work);
  float* red = in_s + up4(Kd * NB);
  float* out = red + WARPS * 4 * NB * 4;
  const T* W = static_cast<const T*>(layer ? p.w1 : p.w0);
  const float* bias = layer ? p.b1 : p.b0;
  float* dst = layer ? p.x : x0;
  const unsigned step = (unsigned)(p.step0 + t);
  static_assert(NB * PRE_COLS <= THREADS, "a thread per output");
  for (int item = blockIdx.x; item < cdiv(N, PRE_COLS); item += gridDim.x) {
    const int c0 = item * PRE_COLS;
    // the output's bias and addend, loaded ahead
    const int ob = threadIdx.x / PRE_COLS, col = c0 + threadIdx.x % PRE_COLS;
    const bool own = threadIdx.x < NB * PRE_COLS && ob < p.B && col < N;
    const float add = own ? bias[col] : 0.f;
    const float extra = own && !layer ? p.extra[(size_t)ob * p.P0 + col] : 0.f;
    gather(Kd * NB,
           [&](int i) {
             const int k = i / NB, b = i - k * NB;
             return b >= p.B ? 0.f
                  : layer ? ldcg1(x0 + (size_t)b * p.P0 + k)
                          : rounded<T>(ldcg1(p.frame + (size_t)b * p.n_mel + k));
           },
           [&](int i, float v) { in_s[i] = v; });
    __syncthreads();
    cols_matvec<T, NB>(W, N, Kd, c0, in_s, out, red);
    if (own) {
      float v = out[threadIdx.x] + add;
      if (!layer) v += extra;
      v = fmaxf(v, 0.f);
      if (!p.deterministic)
        v = philox_word0(k0, k1, step, ob, col, layer) >= p.drop_threshold ? v * p.drop_scale
                                                                           : 0.f;
      dst[(size_t)ob * N + col] = rounded<T>(v);
    }
    __syncthreads();
  }
}

// partial energies of (row b, attention columns [a0, a0 + 16), positions
// [s0, s0 + 64)): pq from the slabs' partials, the location conv of the
// alignments (read in T, zero outside [0, S)), tanh and v
template <typename T>
__device__ void energies_phase(const Params& p, unsigned char* work) {
  const Plan& pl = p.plan;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, A = p.A, B = p.B;
  const float* pq_part = p.scratch + pl.sc_pq;
  float* e_part = p.scratch + pl.sc_e;
  constexpr int WIN = ENERGY_POS + 2 * LOC_PAD, LW = 2 * LOC_TAPS * ATT_COLS;
  float* prevp = reinterpret_cast<float*>(work);
  float* cump = prevp + up4(WIN);
  float* lw = cump + up4(WIN);
  float* pmt = lw + LW;
  float* pq = pmt + ENERGY_POS * ATT_COLS;
  float* vw = pq + ATT_COLS;
  const T* loc_w = static_cast<const T*>(p.loc_w);
  const int per_row = pl.n_att_items * pl.n_pos_items;
  for (int item = blockIdx.x; item < B * per_row; item += gridDim.x) {
    const int b = item / per_row, r = item - b * per_row;
    const int ab = r / pl.n_pos_items, a0 = ab * ATT_COLS;
    const int s0 = (r - ab * pl.n_pos_items) * ENERGY_POS;
    const int ns = min(ENERGY_POS, S - s0);
    const float* prev = p.prev + (size_t)b * S;
    const float* cum = p.cum + (size_t)b * S;
    const T* pm = static_cast<const T*>(p.pm) + (size_t)b * S * A;
    // pq of column a0 + warp: the slabs' partials, lane-strided; the first
    // 128 are loaded here and summed after the staging below
    float pq_v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sl = lane + 32 * j;
      pq_v[j] = a0 + warp < A && sl < pl.n_slabs
              ? ldcg1(pq_part + ((size_t)sl * B + b) * A + a0 + warp) : 0.f;
    }
    // the alignments' window, the conv weight's columns, the processed
    // memory's tile, v
    const int n_win = ns + 2 * LOC_PAD, n_pm = ns * ATT_COLS;
    gather(2 * n_win + LW + n_pm + ATT_COLS,
           [&](int i) -> float {
             if (i < 2 * n_win) {
               const int c = i / n_win, s = s0 + i - c * n_win - LOC_PAD;
               return s >= 0 && s < S ? rounded<T>(ldcg1((c ? cum : prev) + s)) : 0.f;
             }
             i -= 2 * n_win;
             if (i < LW) {
               const int a = a0 + i % ATT_COLS;
               return a < A ? ldg1(loc_w + (size_t)(i / ATT_COLS) * A + a) : 0.f;
             }
             i -= LW;
             if (i < n_pm) {
               const int a = a0 + i % ATT_COLS;
               return a < A ? ldg1(pm + (size_t)(s0 + i / ATT_COLS) * A + a) : 0.f;
             }
             i -= n_pm;
             return a0 + i < A ? p.v_w[a0 + i] : 0.f;
           },
           [&](int i, float v) {
             if (i < 2 * n_win) {
               const int c = i / n_win;
               (c ? cump : prevp)[i - c * n_win] = v;
               return;
             }
             i -= 2 * n_win;
             if (i < LW) { lw[i] = v; return; }
             i -= LW;
             if (i < n_pm) { pmt[i] = v; return; }
             vw[i - n_pm] = v;
           });
    float pq_lane = ((pq_v[0] + pq_v[1]) + pq_v[2]) + pq_v[3];
    if (a0 + warp < A)
      pq_lane += strided_sum(lane + 128, pl.n_slabs, 32, [&](int sl) {
        return ldcg1(pq_part + ((size_t)sl * B + b) * A + a0 + warp);
      });
    pq_lane = warp_sum(pq_lane);
    if (lane == 0) pq[warp] = pq_lane;
    __syncthreads();
    // a lane per column, two neighbouring positions a thread (each tap's
    // weight read once for both), a half warp per pair of positions
    static_assert(ENERGY_POS == 2 * (THREADS / ATT_COLS), "one pass over the positions");
    const int aa = threadIdx.x & (ATT_COLS - 1), j = 2 * (threadIdx.x / ATT_COLS);
    float v0 = 0.f, v1 = 0.f;
    if (a0 + aa < A && j < ns) {
      float f0 = 0.f, f1 = 0.f;
#pragma unroll
      for (int k = 0; k < LOC_TAPS; ++k) {
        const float w = lw[k * ATT_COLS + aa];
        f0 += prevp[j + k] * w;
        f1 += prevp[j + 1 + k] * w;
      }
#pragma unroll
      for (int k = 0; k < LOC_TAPS; ++k) {
        const float w = lw[(LOC_TAPS + k) * ATT_COLS + aa];
        f0 += cump[j + k] * w;
        f1 += cump[j + 1 + k] * w;
      }
      v0 = tanhf(pq[aa] + pmt[j * ATT_COLS + aa] + f0) * vw[aa];
      if (j + 1 < ns) v1 = tanhf(pq[aa] + pmt[(j + 1) * ATT_COLS + aa] + f1) * vw[aa];
    }
#pragma unroll
    for (int o = 1; o < ATT_COLS; o <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    float* e_out = e_part + ((size_t)ab * B + b) * S + s0 + j;
    if (aa == 0 && j < ns) e_out[0] = v0;
    if (aa == 0 && j + 1 < ns) e_out[1] = v1;
    __syncthreads();
  }
}

// (row b, memory columns [d0, d0 + 32)): the energies from their partials,
// mask, window, softmax; the context columns (product in T, sum in f32) and
// their fold with proj_w's ctx rows.  The item of the first columns writes
// the alignments, the cumulative alignments and the argmax.
template <typename T>
__device__ void context_phase(const Params& p, unsigned char* work, int t, const int* main_cur,
                              int* main_nxt) {
  const Plan& pl = p.plan;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, D = p.D, B = p.B, NO = p.n_mel + 1;
  const float* e_part = p.scratch + pl.sc_e;
  float* proj_part = p.scratch + pl.sc_proj;
  float* e = reinterpret_cast<float*>(work);
  float* at = e + up4(S);
  float* scratch = at + up4(S);
  float* part = scratch + 2 * WARPS;
  float* cs = part + THREADS;
  const T* proj_w = static_cast<const T*>(p.proj_w);
  constexpr int POS_LANES = THREADS / CTX_COLS, PROJ_LANES = 4;
  for (int item = blockIdx.x; item < B * pl.n_ctx_items; item += gridDim.x) {
    const int b = item / pl.n_ctx_items, db = item - b * pl.n_ctx_items, d0 = db * CTX_COLS;
    const bool writer = db == 0;
    // loads that do not depend on the energies, issued first: the memory
    // columns of the context (the first 64 positions), the proj_w rows of
    // the fold, the row's cumulative alignment
    const int dd = threadIdx.x % CTX_COLS, sl = threadIdx.x / CTX_COLS, d = d0 + dd;
    const T* mem = static_cast<const T*>(p.mem) + (size_t)b * S * D + d;
    float mv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int s = sl + m * POS_LANES;
      mv[m] = d < D && s < S ? ldg1(mem + (size_t)s * D) : 0.f;
    }
    const int pj = threadIdx.x % NO, pl_ = threadIdx.x / NO;
    float pv[CTX_COLS / PROJ_LANES];
#pragma unroll
    for (int i = 0; i < CTX_COLS / PROJ_LANES; ++i) {
      const int c = pl_ * (CTX_COLS / PROJ_LANES) + i;
      pv[i] = threadIdx.x < PROJ_LANES * NO && d0 + c < D
            ? ldg1(proj_w + (size_t)(p.U + d0 + c) * NO + pj) : 0.f;
    }
    float* cum = p.cum + (size_t)b * S;
    const float cum_own = writer && (int)threadIdx.x < S ? ldcg1(cum + threadIdx.x) : 0.f;
    int lo = 0;
    if (p.use_window) {
      int center = max(__ldcg(main_cur + b), p.win_offset);
      center = min(center, p.enc_len[b] - p.win_len + p.win_offset);
      lo = center - p.win_offset;
    }
    float local_max = -3.0e38f;
    for (int s = threadIdx.x; s < S; s += THREADS) {
      const float m = p.mask[(size_t)b * S + s];
      float v = 0.f;
      for (int ab0 = 0; ab0 < pl.n_att_items; ab0 += 8) {
        float part_e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part_e[j] = ab0 + j < pl.n_att_items ? ldcg1(e_part + ((size_t)(ab0 + j) * B + b) * S + s)
                                               : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v += part_e[j];
      }
      bool keep = m > 0.f;
      if (p.use_window) keep = keep && s >= lo && s <= lo + p.win_len;
      v = keep ? v : -1e9f;
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
    float* attn_out = p.attn + ((size_t)t * B + b) * S;
    float* prev = p.prev + (size_t)b * S;
    for (int s = threadIdx.x; s < S; s += THREADS) {
      const float a = e[s] / total;
      at[s] = rounded<T>(a);
      if (writer) {
        attn_out[s] = a;
        cum[s] = (s == (int)threadIdx.x ? cum_own : ldcg1(cum + s)) + a;
        prev[s] = a;
        if (a > best) { best = a; best_at = s; }
      }
    }
    if (writer) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, best_at, o);
        if (ov > best || (ov == best && oi < best_at)) { best = ov; best_at = oi; }
      }
    }
    __syncthreads();
    if (writer && lane == 0) {
      scratch[warp] = best;
      scratch[WARPS + warp] = __int_as_float(best_at);
    }
    __syncthreads();
    if (writer && threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w) {
        const float ov = scratch[w];
        const int oi = __float_as_int(scratch[WARPS + w]);
        if (ov > best || (ov == best && oi < best_at)) { best = ov; best_at = oi; }
      }
      main_nxt[b] = best_at;
    }

    // context: a column per lane, 16 position lanes, summed in lane order
    {
      float c = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = sl + m * POS_LANES;
        if (s < S) c += rounded<T>(at[s] * mv[m]);
      }
      if (d < D)
        c += strided_sum(sl + 4 * POS_LANES, S, POS_LANES, [&](int s) {
          return rounded<T>(at[s] * ldg1(mem + (size_t)s * D));
        });
      part[threadIdx.x] = c;
    }
    __syncthreads();
    if (threadIdx.x < CTX_COLS) {
      float c = 0.f;
      for (int l = 0; l < POS_LANES; ++l) c += part[l * CTX_COLS + threadIdx.x];
      const float r = d0 + threadIdx.x < D ? rounded<T>(c) : 0.f;
      if (d0 + threadIdx.x < D) store1(static_cast<T*>(p.ctx) + (size_t)b * D + d, r);
      cs[threadIdx.x] = r;
    }
    __syncthreads();
    // the frame's ctx part: these columns against their rows of proj_w, 4
    // lanes of 8 columns an output, summed in lane order
    if (threadIdx.x < PROJ_LANES * NO) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < CTX_COLS / PROJ_LANES; ++i) s += cs[pl_ * (CTX_COLS / PROJ_LANES) + i] * pv[i];
      part[threadIdx.x] = s;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < NO; j += THREADS) {
      float s = 0.f;
      for (int l = 0; l < PROJ_LANES; ++l) s += part[l * NO + j];
      proj_part[((size_t)(pl.n_slabs + db) * B + b) * NO + j] = s;
    }
    __syncthreads();
  }
}

// the frame and gate of step t, (row, 8 output columns) an item: 64 lanes
// sum the partials of a column lane-strided, then the lanes in order
__device__ void frame_phase(const Params& p, unsigned char* work, int t) {
  const Plan& pl = p.plan;
  const int NO = p.n_mel + 1, parts = pl.n_slabs + pl.n_ctx_items;
  const float* proj_part = p.scratch + pl.sc_proj;
  float* red = reinterpret_cast<float*>(work);
  constexpr int LANES = THREADS / FRAME_COLS;
  for (int item = blockIdx.x; item < p.B * pl.n_frame_items; item += gridDim.x) {
    const int b = item / pl.n_frame_items;
    const int j = (item - b * pl.n_frame_items) * FRAME_COLS + threadIdx.x % FRAME_COLS;
    red[threadIdx.x] = j >= NO ? 0.f
        : strided_sum(threadIdx.x / FRAME_COLS, parts, LANES, [&](int q) {
            return ldcg1(proj_part + ((size_t)q * p.B + b) * NO + j);
          });
    __syncthreads();
    if (threadIdx.x < FRAME_COLS && j < NO) {
      float s = 0.f;
      for (int l = 0; l < LANES; ++l) s += red[l * FRAME_COLS + threadIdx.x];
      s += p.proj_b[j];
      if (j == p.n_mel) s = sigmoidf(s);
      p.steps[((size_t)t * p.B + b) * NO + j] = s;
      if (j < p.n_mel) p.frame[(size_t)b * p.n_mel + j] = s;
    }
    __syncthreads();
  }
}

// ---- the kernel ---------------------------------------------------------------

template <typename T, int NB, bool Q8>
__global__ void __launch_bounds__(THREADS, 1) decoder_steps_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = p.plan;
  const int slab = blockIdx.x;
  const bool has_slab = slab < pl.n_slabs;
  unsigned char* work = smem + pl.off_work;
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(smem + pl.off_bar);

  long long* stamps = blockIdx.x == 0 ? p.stamps : nullptr;
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[2 * N_PHASES * p.K] = globaltimer_ns();
    stamps[2 * N_PHASES * p.K + 1] = clock64();
  }

  // this block's slabs: the resident heads, its q_w and proj_w rows, one
  // bulk copy each, waited for where the LSTM phases first read them
  const size_t slab_att = (size_t)pl.k_att_units * pl.unit, slab_dec = (size_t)pl.k_dec_units * pl.unit;
  const unsigned char* att_k = static_cast<const unsigned char*>(p.att_k) + slab * slab_att;
  const unsigned char* dec_k = static_cast<const unsigned char*>(p.dec_k) + slab * slab_dec;
  const int NO = p.n_mel + 1;
  const int q_bytes = SLAB_UNITS * p.A * (int)sizeof(T), pw_bytes = SLAB_UNITS * NO * (int)sizeof(T);
  if (has_slab && threadIdx.x == 0) {
    hop::mbar_init(res_bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (has_slab && threadIdx.x == 0) {
    const int att_bytes = pl.res_att * pl.unit, dec_bytes = pl.res_dec * pl.unit;
    hop::mbar_expect_tx(res_bar, (uint32_t)(att_bytes + dec_bytes + q_bytes + pw_bytes));
    if (att_bytes) bulk_load(smem + pl.off_res_att, att_k, (uint32_t)att_bytes, res_bar);
    if (dec_bytes) bulk_load(smem + pl.off_res_dec, dec_k, (uint32_t)dec_bytes, res_bar);
    bulk_load(smem + pl.off_q, static_cast<const T*>(p.q_w) + (size_t)slab * SLAB_UNITS * p.A,
              (uint32_t)q_bytes, res_bar);
    bulk_load(smem + pl.off_pw, static_cast<const T*>(p.proj_w) + (size_t)slab * SLAB_UNITS * NO,
              (uint32_t)pw_bytes, res_bar);
  }

  unsigned k0 = 0, k1 = 0;
  if (!p.deterministic) {
    const unsigned long long seed = (unsigned long long)p.seed[0];
    k0 = (unsigned)seed;
    k1 = (unsigned)(seed >> 32);
  }
  T* h_att[2] = {static_cast<T*>(p.h_att), static_cast<T*>(p.h_att_alt)};
  T* h_dec[2] = {static_cast<T*>(p.h_dec), static_cast<T*>(p.h_dec_alt)};
  int* main_idx[2] = {p.main_idx, reinterpret_cast<int*>(p.scratch + pl.sc_main)};
  const T* ctx = static_cast<const T*>(p.ctx);
  const T* q_s = reinterpret_cast<const T*>(smem + pl.off_q);
  const T* pw_s = reinterpret_cast<const T*>(smem + pl.off_pw);
  float* pq_part = p.scratch + pl.sc_pq;
  float* proj_part = p.scratch + pl.sc_proj;

  unsigned* count = reinterpret_cast<unsigned*>(p.scratch + pl.sc_bar);
  unsigned passed = 0;
  auto barrier = [&](int t, int phase) {
    stamp(stamps, 2 * (N_PHASES * t + phase));
    grid_sync(count, gridDim.x * ++passed);
    stamp(stamps, 2 * (N_PHASES * t + phase) + 1);
  };
  for (int t = 0; t < p.K; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    prenet_phase<T, NB>(p, work, t, 0, k0, k1);
    barrier(t, 0);
    prenet_phase<T, NB>(p, work, t, 1, k0, k1);
    barrier(t, 1);
    if (has_slab)
      lstm_phase<T, NB, Q8>(p, smem, att_k, 0,
                            Segments<float, T>{p.x, ctx, h_att[cur], p.P1, p.D, p.U}, p.att_b,
                            p.s_att, p.c_att, h_att[nxt], q_s, p.A, pq_part);
    barrier(t, 2);
    energies_phase<T>(p, work);
    barrier(t, 3);
    context_phase<T>(p, work, t, main_idx[cur], main_idx[nxt]);
    barrier(t, 4);
    if (has_slab)
      lstm_phase<T, NB, Q8>(p, smem, dec_k, 1,
                            Segments<T, T>{h_att[nxt], ctx, h_dec[cur], p.U, p.D, p.U}, p.dec_b,
                            p.s_dec, p.c_dec, h_dec[nxt], pw_s, NO, proj_part);
    barrier(t, 5);
    frame_phase(p, work, t);
    barrier(t, 6);
  }
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[2 * N_PHASES * p.K + 2] = globaltimer_ns();
    stamps[2 * N_PHASES * p.K + 3] = clock64();
  }

  // after an odd number of steps the newest h and argmax are in the second
  // buffers
  if (p.K & 1) {
    const int n = p.B * p.U;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
      store1(h_att[0] + i, ldcg1(h_att[1] + i));
      store1(h_dec[0] + i, ldcg1(h_dec[1] + i));
    }
    if (blockIdx.x == 0 && threadIdx.x < p.B) main_idx[0][threadIdx.x] = __ldcg(main_idx[1] + threadIdx.x);
  }
}

// ---- the host side ------------------------------------------------------------------

// The shared-memory plan: the phases' work area, the slab rows resident for
// the whole launch (as many as the rest leaves, the critical ones first).
// Returns false when even the work area does not fit.
template <typename T, bool Q8>
bool make_plan(const Params& p, int NB, int sms, int smem_max, Plan& pl) {
  const int k_att = p.P1 + p.D + p.U, k_dec = 2 * p.U + p.D, NO = p.n_mel + 1;
  const int kmax = k_att > k_dec ? k_att : k_dec;
  pl.unit = Q8 ? 4 * SLAB_COLS : SLAB_COLS * (int)sizeof(T);
  pl.k_att_units = Q8 ? k_att / 4 : k_att;
  pl.k_dec_units = Q8 ? k_dec / 4 : k_dec;
  pl.n_slabs = p.U / SLAB_UNITS;
  pl.n_att_items = cdiv(p.A, ATT_COLS);
  pl.n_pos_items = cdiv(p.S, ENERGY_POS);
  pl.n_ctx_items = cdiv(p.D, CTX_COLS);
  pl.n_frame_items = cdiv(NO, FRAME_COLS);
  pl.grid = sms;
  // work areas in floats (see each phase)
  pl.sub_rows = kmax < SUB_FLOATS / NB ? kmax : SUB_FLOATS / NB;
  const int lstm = (Q8 ? up4(kmax / 4 * NB) : up4(pl.sub_rows * NB)) + MAX_ROWS
                   + WARPS * SLAB_UNITS * NB * 4 + SLAB_UNITS * NB;
  const int prenet = up4((p.P0 > p.n_mel ? p.P0 : p.n_mel) * NB) + WARPS * 4 * NB * 4
                     + NB * PRE_COLS;
  const int energies = 2 * up4(ENERGY_POS + 2 * LOC_PAD) + 2 * LOC_TAPS * ATT_COLS
                       + ENERGY_POS * ATT_COLS + 2 * ATT_COLS;
  const int context = 2 * up4(p.S) + 2 * WARPS + THREADS + CTX_COLS;   // also the frame's
  int work = lstm;
  if (prenet > work) work = prenet;
  if (energies > work) work = energies;
  if (context > work) work = context;
  const int q_bytes = up128(SLAB_UNITS * p.A * (int)sizeof(T));
  const int pw_bytes = up128(SLAB_UNITS * NO * (int)sizeof(T));
  const int bar = 128;
  const int fixed = q_bytes + pw_bytes + bar + up128(work * 4);
  const long long slab_units = (long long)pl.k_att_units + pl.k_dec_units;
  long long avail = (long long)smem_max - fixed - 256;   // room for the alignment of two arrays
  if (avail < 0) return false;
  // as many rows as fit, in proportion to each slab's
  const long long rows = avail / pl.unit;
  pl.res_att = (int)(rows >= slab_units ? pl.k_att_units : rows * pl.k_att_units / slab_units);
  pl.res_dec = (int)(rows >= slab_units ? pl.k_dec_units : rows - pl.res_att);
  int at = 0;
  pl.off_res_att = at; at += up128(pl.res_att * pl.unit);
  pl.off_res_dec = at; at += up128(pl.res_dec * pl.unit);
  pl.off_q = at;       at += q_bytes;
  pl.off_pw = at;      at += pw_bytes;
  pl.off_bar = at;     at += bar;
  pl.off_work = at;    at += up128(work * 4);
  pl.smem = at;
  // scratch in device memory, in floats
  int sc = 0;
  pl.sc_x0 = sc;   sc += up4(p.B * p.P0);
  pl.sc_pq = sc;   sc += up4(pl.n_slabs * p.B * p.A);
  pl.sc_e = sc;    sc += up4(pl.n_att_items * p.B * p.S);
  pl.sc_proj = sc; sc += up4((pl.n_slabs + pl.n_ctx_items) * p.B * NO);
  pl.sc_main = sc; sc += up4(p.B);
  pl.sc_bar = sc;  sc += 4;
  pl.sc_total = sc;
  return pl.smem <= smem_max;
}

int rows_template(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

template <typename T, bool Q8>
int plan_for(const Params& p, Plan& pl) {
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (p.U / SLAB_UNITS > sms) return (int)cudaErrorInvalidValue;
  if (!make_plan<T, Q8>(p, rows_template(p.B), sms, smem_max, pl))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int NB, bool Q8>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = decoder_steps_kernel<T, NB, Q8>;
  int device = 0, cooperative = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (!cooperative) return (int)cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.plan.smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident, or the grid barrier would never complete
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, p.plan.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params params = p;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.plan.grid), dim3(THREADS), args,
                                    (size_t)p.plan.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool Q8>
int launch_rows(const Params& p, cudaStream_t stream) {
  switch (rows_template(p.B)) {
    case 1: return launch<T, 1, Q8>(p, stream);
    case 2: return launch<T, 2, Q8>(p, stream);
    case 4: return launch<T, 4, Q8>(p, stream);
    default: return launch<T, 8, Q8>(p, stream);
  }
}

// ints, in order: is_bf16, B, S, n_mel, P0, P1, D, U, A, K, step0,
// deterministic, use_window, win_len, win_offset, drop_threshold, int8
bool read_ints(const long long* ints, Params& p, bool& is_bf16, bool& int8) {
  is_bf16 = ints[0] != 0;
  int8 = ints[16] != 0;
  p.B = (int)ints[1]; p.S = (int)ints[2]; p.n_mel = (int)ints[3]; p.P0 = (int)ints[4];
  p.P1 = (int)ints[5]; p.D = (int)ints[6]; p.U = (int)ints[7]; p.A = (int)ints[8];
  p.K = (int)ints[9]; p.step0 = (int)ints[10]; p.deterministic = (int)ints[11];
  p.use_window = (int)ints[12]; p.win_len = (int)ints[13]; p.win_offset = (int)ints[14];
  p.drop_threshold = (unsigned)ints[15];
  return !(p.B < 1 || p.B > MAX_ROWS || p.S < 1 || p.K < 1 || p.U % SLAB_UNITS || p.P0 % 4 ||
           p.P1 % 4 || p.A % 4 || (p.U + p.D) % 4 || (int8 && p.D % 4));
}

int plan_of(const Params& p, bool is_bf16, bool int8, Plan& pl) {
  if (is_bf16) return int8 ? plan_for<__nv_bfloat16, true>(p, pl) : plan_for<__nv_bfloat16, false>(p, pl);
  return int8 ? plan_for<float, true>(p, pl) : plan_for<float, false>(p, pl);
}

}  // namespace

// The plan of a launch with these ints (see decoder_steps_forward), on the
// current device: out = [dynamic shared bytes, resident weight bytes per
// block (slab rows, q_w and proj_w rows), streamed bytes per step (all
// blocks), blocks, blocks with a slab, resident units of the attention slab
// and of the decoder slab, bytes per unit, scratch floats].  Returns the
// CUDA error code (0 on success).
extern "C" int decoder_steps_plan(const long long* ints, long long* out) {
  Params p;
  bool is_bf16, int8;
  if (!read_ints(ints, p, is_bf16, int8)) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = plan_of(p, is_bf16, int8, pl);
  if (err) return err;
  const int T_size = is_bf16 ? 2 : 4, NO = p.n_mel + 1;
  out[0] = pl.smem;
  out[1] = (long long)(pl.res_att + pl.res_dec) * pl.unit + SLAB_UNITS * (p.A + NO) * T_size;
  out[2] = (long long)pl.n_slabs * (pl.k_att_units - pl.res_att + pl.k_dec_units - pl.res_dec) * pl.unit;
  out[3] = pl.grid;
  out[4] = pl.n_slabs;
  out[5] = pl.res_att;
  out[6] = pl.res_dec;
  out[7] = pl.unit;
  out[8] = pl.sc_total;
  return 0;
}

// ptrs, in order: w0, w1, att_k, q_w, loc_w, dec_k, proj_w (T); b0, b1,
// att_b, v_w, dec_b, proj_b (f32); mem, pm (T); mask (f32), enc_len (i32),
// extra (f32), seed (i64); frame (f32), h_att (T), c_att (f32), h_dec (T),
// c_dec (f32), ctx (T), prev, cum (f32), main (i32); x (f32), h_att_alt,
// h_dec_alt (T); scratch (f32, decoder_steps_plan's count); steps, attn
// (f32); stamps (i64, 14 K + 4, or null); s_att, s_dec (f32, 4U, in the
// logical column order; null unless int8).
// Layouts: att_k / dec_k (U / 8, K, 32) slabs with column 4 * unit + gate,
// in T, or with int8 (U / 8, K / 4, 32, 4), dec_k's rows in the order
// [ctx | h_att | h_dec]; proj_w (U + D, n_mel + 1);
// every other array as its logical shape, row-major.  Requires B <= 8,
// U % 8 == 0, U / 8 <= the SM count, P0, P1, A, U + D multiples of 4 (D too
// in int8), and 16-byte aligned pointers.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int decoder_steps_forward(const void* const* ptrs, const long long* ints,
                                     float drop_scale, void* stream) {
  Params p;
  bool is_bf16, int8;
  if (!read_ints(ints, p, is_bf16, int8)) return (int)cudaErrorInvalidValue;
  int i = 0;
  p.w0 = ptrs[i++]; p.w1 = ptrs[i++]; p.att_k = ptrs[i++]; p.q_w = ptrs[i++];
  p.loc_w = ptrs[i++]; p.dec_k = ptrs[i++]; p.proj_w = ptrs[i++];
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
  p.scratch = (float*)ptrs[i++];
  p.steps = (float*)ptrs[i++]; p.attn = (float*)ptrs[i++];
  p.stamps = (long long*)ptrs[i++];
  p.s_att = (const float*)ptrs[i++]; p.s_dec = (const float*)ptrs[i++];
  p.drop_scale = drop_scale;
  if (int8 && (p.s_att == nullptr || p.s_dec == nullptr)) return (int)cudaErrorInvalidValue;
  const int err = plan_of(p, is_bf16, int8, p.plan);
  if (err) return err;
  if (is_bf16)
    return int8 ? launch_rows<__nv_bfloat16, true>(p, (cudaStream_t)stream)
                : launch_rows<__nv_bfloat16, false>(p, (cudaStream_t)stream);
  return int8 ? launch_rows<float, true>(p, (cudaStream_t)stream)
              : launch_rows<float, false>(p, (cudaStream_t)stream);
}
