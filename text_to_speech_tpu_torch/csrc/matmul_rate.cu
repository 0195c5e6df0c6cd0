// The tensor-core rate probe: chained products with feedback, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of benchmarks/matmul_rate.py (`build`, body
// `kernel`).  For x (M, K) and w (W, K, N) it computes
//
//   acc = 0
//   for r in range(reps):  acc += x @ w[r % W];  x = next(acc[:, :K])
//   out = acc                       (M, N): int32 for int8 operands,
//                                   float32 for bf16
//   next(acc) = (acc & 127) as int8  |  acc rounded to bf16 (to nearest even)
//
// `grid` times over: the TPU ran its grid in order on one core, each step
// recomputing the same out.  Here the repeats are independent blocks and
// all of them write out, with the same values.
//
// Design.  The chain is row-local: x's next rows depend only on the same
// rows of acc, so a block owns BM = 32 rows of one repeat and carries their
// chain alone, with no exchange between blocks.  It keeps those rows'
// accumulators across all N columns in registers: N / 64 warps (16 at
// N = 1024, 512 threads), each owning 64 columns, 32 x 64 int32 or f32
// values, 64 registers a thread.  x stays in shared memory for the whole
// chain; after each product the warps that own columns below K write the
// next x over it (two block barriers a product).  The weights are taken
// transposed, wt (W, N, K), so that both operands' fragments are four
// consecutive bytes along K: one code path serves mma.sync.m16n8k16 bf16
// -> f32 and mma.sync.m16n8k32 s8 -> s32, the instruction path of the WN
// kernels, in 32-byte k-steps.  Each warp streams its own 64 rows of wt
// through a private 3-stage ring of 64-byte k slices (cp.async, XOR-
// swizzled so the 32-bit fragment loads are free of bank conflicts), so
// the mainloop needs no block barrier.
//
// Bound on an H100 SXM at the probe's shapes (M = K = 512, N = 1024,
// W = 8, reps = grid = 64): 2 M K N reps grid = 2.2e12 operations, 1.11 ms
// at 1979 TOP/s dense int8 and 2.22 ms at 989 TFLOP/s bf16; its bytes (x,
// w, out once) take 3 us.  This kernel is bound by L2 instead: every block
// streams w[r % W] (0.5 MB int8, 1 MB bf16) from L2 for every product, 32
// rows' worth of reuse, so grid * M / 32 * reps * K * N * itemsize bytes
// cross L2 (34 GB int8, 69 GB bf16), against 2 * 32 / itemsize operations
// a byte.  Not done yet, and left to later work: sharing one stream of w
// among the blocks of a cluster (TMA multicast) and wgmma.

#include "wn_tile.cuh"

#include <stdint.h>

namespace {

constexpr int BM = 32;                    // rows a block: two m16 tiles
constexpr int WN = 64;                    // columns a warp: eight n8 tiles
constexpr int KB = 64;                    // bytes of K a ring stage: two k-steps
constexpr int STAGES = 3;                 // ring depth
constexpr int STAGE_BYTES = WN * KB;      // one warp's stage
constexpr int MAX_WARPS = 16;             // N <= 1024
constexpr int MAX_SMEM = 232448;          // a block's shared memory on sm_90

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// byte offset of the 16-byte chunk c (0..3) of row n in a stage: the chunk
// index is XORed with bits 1-2 of the row, so the eight rows of a fragment
// load fall on distinct banks
__device__ __forceinline__ int swizzle(int n, int c) {
  return n * KB + ((c ^ ((n >> 1) & 3)) << 4);
}

template <bool INT8> struct Mma;

template <> struct Mma<true> {
  using Acc = int;
  // d += a (16 x 32, row) . b (32 x 8, col), s8 -> s32
  static __device__ __forceinline__ void run(int (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // the next x: acc & 127 (0..127) as two int8 at row, col and col + 1
  static __device__ __forceinline__ void feed(unsigned char* xs, int x_ld, int row, int col,
                                              int v0, int v1) {
    *reinterpret_cast<unsigned short*>(xs + row * x_ld + col) =
        (unsigned short)((v0 & 127) | ((v1 & 127) << 8));
  }
};

template <> struct Mma<false> {
  using Acc = float;
  // d += a (16 x 16, row) . b (16 x 8, col), bf16 -> f32
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // the next x: acc rounded to bf16 at row, col and col + 1
  static __device__ __forceinline__ void feed(unsigned char* xs, int x_ld, int row, int col,
                                              float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(xs + row * x_ld + 2 * col) =
        __floats2bfloat162_rn(v0, v1);
  }
};

// grid (M / BM, repeats), N / WN warps a block.  x (M, kb bytes a row),
// wt (W, N, kb bytes a row), out (M, N); k = K elements, kb = K bytes.
template <bool INT8>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
matmul_rate_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ wt,
                   typename Mma<INT8>::Acc* __restrict__ out, int N, int k, int kb, int W,
                   int reps) {
  using Acc = typename Mma<INT8>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x_ld = kb + 16;               // 16 bytes of padding a row
  unsigned char* xs = smem;
  unsigned char* ring = smem + BM * x_ld + warp * STAGES * STAGE_BYTES;
  const int row0 = blockIdx.x * BM, col0 = warp * WN;

  for (int c = threadIdx.x; c < BM * (kb / 16); c += blockDim.x) {
    const int r = c / (kb / 16), o = (c % (kb / 16)) * 16;
    cp_async16(xs + r * x_ld + o, x + (size_t)(row0 + r) * kb + o, true);
  }
  cp_async_commit();

  const int chunks = kb / KB, total = reps * chunks;
  // stage i: this warp's WN rows of wt[r % W], bytes k0 .. k0 + KB
  auto load = [&](int i) {
    const int r = i / chunks, k0 = (i % chunks) * KB;
    const unsigned char* src = wt + ((size_t)(r % W) * N + col0) * kb + k0;
    unsigned char* dst = ring + (i % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < STAGE_BYTES / 16 / 32; ++j) {
      const int c = j * 32 + lane, n = c >> 2, q = c & 3;
      cp_async16(dst + swizzle(n, q), src + (size_t)n * kb + q * 16, true);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  Acc acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  cp_async_wait<STAGES - 2>();            // x and the first stage
  __syncthreads();

  int i = 0;
  for (int r = 0; r < reps; ++r) {
    for (int kc = 0; kc < chunks; ++kc, ++i) {
      cp_async_wait<STAGES - 2>();
      __syncwarp();                       // stage i is in; stage i - 1 is read
      if (i + STAGES - 1 < total) load(i + STAGES - 1);
      cp_async_commit();
      const unsigned char* bs = ring + (i % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p = xs + (mi * 16 + g) * x_ld + kc * KB + ks * 32 + 4 * t;
          a[mi][0] = lds32(p);
          a[mi][1] = lds32(p + 8 * x_ld);
          a[mi][2] = lds32(p + 16);
          a[mi][3] = lds32(p + 8 * x_ld + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int n = ni * 8 + g;
          const unsigned b0 = lds32(bs + swizzle(n, 2 * ks) + 4 * t);
          const unsigned b1 = lds32(bs + swizzle(n, 2 * ks + 1) + 4 * t);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) Mma<INT8>::run(acc[mi][ni], a[mi], b0, b1);
        }
      }
    }
    if (r + 1 < reps) {
      __syncthreads();                    // every warp has read this x
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = col0 + ni * 8 + 2 * t;
        if (col < k) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            Mma<INT8>::feed(xs, x_ld, mi * 16 + g, col, acc[mi][ni][0], acc[mi][ni][1]);
            Mma<INT8>::feed(xs, x_ld, mi * 16 + g + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
          }
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mi * 16 + g + 8 * h, col = col0 + ni * 8 + 2 * t;
        Acc* o = out + (size_t)row * N + col;
        o[0] = acc[mi][ni][2 * h];
        o[1] = acc[mi][ni][2 * h + 1];
      }
}

template <bool INT8>
int run(const void* x, const void* wt, void* out, int M, int N, int K, int W, int reps,
        int repeats, cudaStream_t stream) {
  const int kb = K * (INT8 ? 1 : 2);
  const int warps = N / WN;
  const int smem = BM * (kb + 16) + warps * STAGES * STAGE_BYTES;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = matmul_rate_kernel<INT8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(M / BM, repeats), warps * 32, smem, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<const unsigned char*>(wt),
      static_cast<typename Mma<INT8>::Acc*>(out), N, K, kb, W, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) int8 or bf16, wt (W, N, K) the same type, out (M, N) int32 or
// f32.  Returns a CUDA error code; shapes outside the kernel's tiles (M % 32,
// K % 64, N % 64, N <= 1024, K <= N, the shared memory) are
// cudaErrorInvalidValue.
extern "C" int matmul_rate_forward(int is_int8, const void* x, const void* wt, void* out,
                                   int M, int N, int K, int W, int reps, int repeats,
                                   void* stream) {
  if (M % BM != 0 || K % 64 != 0 || N % WN != 0 || N > MAX_WARPS * WN || K > N || W < 1 ||
      reps < 1 || repeats < 1 || repeats > 65535 || M < BM)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return run<true>(x, wt, out, M, N, K, W, reps, repeats, (cudaStream_t)stream);
  return run<false>(x, wt, out, M, N, K, W, reps, repeats, (cudaStream_t)stream);
}
