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
// recomputing the same out.  Here the repeats are independent row tiles and
// all of them write out, with the same values.
//
// Bound on an H100 SXM at the probe's shapes (M = K = 512, N = 1024,
// W = 8, reps = grid = 64): 2 M K N reps grid = 2.2e12 operations, 1.11 ms
// at 1979 TOP/s dense int8 and 2.22 ms at 989 TFLOP/s bf16; its bytes (x,
// w, out once) take 3 us.  What stands in the way is the stream of w:
// w[r % W] (0.5 MB int8, 1 MB bf16) streams in for every product, and a
// block gets 2 x rows operations out of each byte of it.
//
// Design.  The chain is row-local, so the work is cut into row tiles of 64
// rows (wgmma's smallest M) of one repeat.  A 64-row accumulator across
// N = 1024 columns is 256 KB, a whole SM's register file, so the columns of
// a row tile are split over P = ceil(N / 512) blocks of one cluster: block
// p owns columns [512 p, +512), two consumer warpgroups of m64n256 (128
// accumulator registers a thread).  Only acc[:, :K] feeds back (K <= 512),
// so block 0, the chain block, owns the whole feedback: after each product
// it writes the next x, 128-byte swizzled as the A descriptor reads it, into
// the other of its two x buffers and copies that buffer into the partner
// block's (P = 2) with one bulk copy through distributed shared memory,
// which completes on the partner's barrier.  The partner may lag by one
// product: x is double-buffered in both blocks, and both blocks' readers
// release a buffer on the chain block's x_empty barrier before it is
// written again; there is no cluster-wide barrier per product.
//   w streams through a ring of 32 KB stages (512 columns of wt x 64 bytes
// of K, 64-byte swizzled), kept full by one producer thread with TMA.  A
// cluster holds R row tiles (R = 4 where the row tiles divide by 4, so a
// cluster is 8 blocks at P = 2, the portable maximum) and each stage is cut
// into four 128-column slices: block r of the R loads slices r, r + R, ...
// and multicasts them to the R blocks of its column, so each column half of
// w[r % W] leaves L2 once per cluster, not once per block.  A stage goes
// back to the producers once the consumers of all R blocks have released
// it (their arrivals on every peer's empty barrier).
//   Shared memory: two x buffers (64 KB each in bf16 at K = 512, 32 KB in
// int8) and as many 32 KB stages as fit (3 in bf16, 5 in int8 at K = 512).
// int8 wgmma takes K-major B only, so both types read wt (W, N, K), the
// transpose the wrapper makes (8 MB in bf16, a few microseconds a call).
// L2 bytes by this tiling: `l2_bytes` in ops/matmul_rate.py; at the probe's
// shapes 4.3 GB (int8) and 8.6 GB (bf16) of w a call, against 34 and 69 GB
// when every 32-row block streamed w for itself.
//   Measured on an H100 (700 W) at the probe's shapes, beside variants with
// one part removed (benchmarks/torch_port_kernel_variants.py): int8 2.40
// ms, its products alone 2.49, its stream alone 1.96; bf16 4.85, 3.59 and
// 4.37.  int8 is bound by the products and by the hand-off of the next x
// (about 1.3 us a product by the clock stamps); bf16 also by the stream,
// which its 3 stages cannot hide.  The multicast saves L2 reads, not an
// SM's intake.  Row tiles of 128 rows on blocks of 256 columns (half the
// intake per operation, two chain blocks copying into three, one x buffer
// in bf16) ran slower: their hand-off grew to several microseconds a
// product.  The consumers release a stage on their peers' barriers with
// the default (CTA-scope) semantics: with .release.cluster each release
// cost about half a microsecond, the ring ran at that pace, and the probe
// took 4.83 / 8.86 ms.

#include "wn_wgmma.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;          // rows a row tile (wgmma's M)
constexpr int COLS = 512;         // columns a block: two consumer warpgroups x 256
constexpr int SLICE = 128;        // columns of a multicast slice (TMA box rows)
constexpr int KB = 64;            // bytes of K a stage: one 64-byte swizzle row
constexpr int STAGE = COLS * KB;  // 32 KB
constexpr int MAX_STAGES = 8;
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int BARRIERS = 256;     // bytes kept for the barriers

template <bool INT8> struct Op;
template <> struct Op<true> {
  using Acc = int;
  static constexpr int ITEM = 1;
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    hop::wgmma_s8_n256(d, a, b, scale_d);
  }
  // the next x at (row, col), (row, col + 1): acc & 127 (0..127) as int8
  static __device__ __forceinline__ void feed(unsigned char* p, int v0, int v1) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)((v0 & 127) | ((v1 & 127) << 8));
  }
};
template <> struct Op<false> {
  using Acc = float;
  static constexpr int ITEM = 2;
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    hop::wgmma_bf16_n256<0>(d, a, b, scale_d);
  }
  // the next x: acc rounded to bf16
  static __device__ __forceinline__ void feed(unsigned char* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
};

// Byte offset of byte `cb` of row `row` in an x buffer: 128-byte-wide
// column chunks of 64 rows (8 KB each), 128-byte swizzled.
__device__ __forceinline__ int x_offset(int row, int cb) {
  return (cb >> 7) * (ROWS * 128) + row * 128 + ((((cb & 127) >> 4) ^ (row & 7)) << 4) +
         (cb & 15);
}

// Bytes of one x buffer: 64 rows of K, rounded up to whole chunks.
__host__ __device__ constexpr int x_bytes(int k_bytes) { return ROWS * ((k_bytes + 127) / 128 * 128); }

__device__ __forceinline__ long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// grid (row tiles x P), clusters of P x R blocks, rank = r + R p.  x (M, K),
// wt through map_w (W, N, K), out (M, N).  stamps (optional): per block,
// 2 + 4 reps globaltimer readings in ns: the start and the end, then for
// each product x ready, the product done, and in the chain block the
// partner's release of the next buffer and the next x written and sent.
template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
rate_wgmma(const __grid_constant__ CUtensorMap map_w, const unsigned char* __restrict__ x,
           typename Op<INT8>::Acc* __restrict__ out, long long* __restrict__ stamps, int M,
           int N, int K, int W, int reps, int R, int P, int stages) {
  using Acc = typename Op<INT8>::Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const int kb_bytes = K * Op<INT8>::ITEM;
  const int xb = x_bytes(kb_bytes);
  const auto xbuf = [&](int b) { return smem + b * xb; };   // the two x buffers
  unsigned char* ring = smem + 2 * xb;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint64_t* x_full = empty + stages;       // partner: the chain block's copy has landed
  uint64_t* x_empty = x_full + 2;          // chain: both blocks have read the buffer

  const uint32_t rank = hop::cluster_rank();
  const int ri = rank % R, p = rank / R;
  const int tile = blockIdx.x / (P * R) * R + ri;
  const int m0 = tile % (M / ROWS) * ROWS;
  const int nkb = kb_bytes / KB;           // stages a product

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8 * R);     // every consumer warp of the R blocks
    }
    for (int b = 0; b < 2; ++b) {
      hop::mbar_init(&x_full[b], 1);
      hop::mbar_init(&x_empty[b], 8 * P);   // every consumer warp of the row tile
    }
    hop::mbar_fence_init();
  }
  hop::cluster_sync();
  if (stamps != nullptr) stamps += (size_t)blockIdx.x * (2 + 4 * reps);
  if (stamps != nullptr && threadIdx.x == 0) stamps[0] = globaltimer_ns();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::regs_dec<40>();
    // the producer: warp 0 waits as a whole (its lanes must not sit at the
    // closing cluster barrier while lane 0 loops), lane 0 issues
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) hop::prefetch_map(&map_w);
      const uint16_t mask = (uint16_t)(((1 << R) - 1) << (p * R));
      int s = 0, phase = 0;
      for (int r = 0; r < reps; ++r) {
        for (int kb = 0; kb < nkb; ++kb) {
          hop::mbar_wait(&empty[s], phase ^ 1);
          if (threadIdx.x == 0) {
            hop::mbar_expect_tx(&full[s], STAGE);
            for (int q = ri; q < COLS / SLICE; q += R)
              hop::tma_load_multicast(ring + s * STAGE + q * SLICE * KB, &map_w, &full[s],
                                      kb * KB / Op<INT8>::ITEM, p * COLS + q * SLICE, r % W,
                                      mask);
          }
          __syncwarp();
          if (++s == stages) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    hop::regs_inc<232>();
    const int ctid = threadIdx.x - 128, wgi = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;

    // x_0, this tile's rows of x, into buffer 0
    const int chunks = kb_bytes / 16;
    for (int c = ctid; c < ROWS * chunks; c += 256) {
      const int row = c / chunks, cb = c % chunks * 16;
      *reinterpret_cast<uint4*>(xbuf(0) + x_offset(row, cb)) =
          *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * kb_bytes + cb);
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);

    Acc acc[128];
    int s = 0, phase = 0;
    for (int r = 0; r < reps; ++r) {
      const int b = r & 1;
      if (p > 0 && r > 0) {
        if (ctid == 0) hop::mbar_expect_tx(&x_full[b], xb);
        hop::mbar_wait(&x_full[b], ((r - 1) >> 1) & 1);
      }
      if (stamps != nullptr && ctid == 0) stamps[2 + 4 * r] = globaltimer_ns();
      // the product: acc += x (64 x K) . w[r % W][:, this warpgroup's 256 columns]
      int prev = 0;
      for (int kb = 0; kb < nkb; ++kb) {
        hop::mbar_wait(&full[s], phase);
        const unsigned char* bs = ring + s * STAGE + wgi * 256 * KB;
        hop::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int cb = kb * KB + 32 * k;
          const uint64_t da = hop::desc_sw128(xbuf(b) + (cb >> 7) * (ROWS * 128) + (cb & 127),
                                              16, 1024);
          Op<INT8>::mma(acc, da, hop::desc_sw64(bs + 32 * k), r > 0 || kb > 0 || k > 0);
        }
        hop::wgmma_commit();
        if (kb > 0) {
          hop::wgmma_wait<1>();
          if (lane < R) hop::mbar_arrive_remote(&empty[prev], p * R + lane);
        }
        prev = s;
        if (++s == stages) { s = 0; phase ^= 1; }
      }
      hop::wgmma_wait<0>();
      if (lane < R) hop::mbar_arrive_remote(&empty[prev], p * R + lane);
      hop::fence_regs(acc);
      if (stamps != nullptr && ctid == 0) stamps[3 + 4 * r] = globaltimer_ns();
      // this product has read x buffer b, in this block
      if (lane == 0) hop::mbar_arrive_remote(&x_empty[b], ri);

      if (p == 0 && r + 1 < reps) {
        // the next x into buffer b ^ 1, once product r - 1 has read it in
        // both blocks
        if (r > 0) hop::mbar_wait(&x_empty[b ^ 1], ((r - 1) >> 1) & 1);
        if (stamps != nullptr && ctid == 0) stamps[4 + 4 * r] = globaltimer_ns();
        unsigned char* xn = xbuf(b ^ 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = wgi * 256 + 8 * j + 2 * tq;
            if (col < K)
              Op<INT8>::feed(xn + x_offset(row, col * Op<INT8>::ITEM), acc[4 * j + 2 * h],
                             acc[4 * j + 2 * h + 1]);
          }
        }
        hop::fence_proxy_async();
        hop::bar_sync(1, 256);
        if (ctid == 0 && P > 1) hop::bulk_copy_to(xn, xb, &x_full[b ^ 1], ri + R);
        if (stamps != nullptr && ctid == 0) stamps[5 + 4 * r] = globaltimer_ns();
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = p * COLS + wgi * 256 + 8 * j + 2 * tq;
        if (col < N) {
          Acc* o = out + (size_t)row * N + col;
          o[0] = acc[4 * j + 2 * h];
          o[1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
    if (stamps != nullptr && ctid == 0) stamps[1] = globaltimer_ns();
  }
  // peers may still arrive on this block's barriers or read its buffers
  hop::cluster_sync();
}

// the row tiles a cluster holds: 4, 2 or 1, whichever divides them first
int cluster_rows(int tiles) { return tiles % 4 == 0 ? 4 : tiles % 2 == 0 ? 2 : 1; }

// The launch of one call: its configuration (the cluster attribute in
// `cluster`), stages and shared memory.
template <bool INT8>
struct Launch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute cluster[1];
  int stages, smem, R, P;
  Launch(int M, int N, int K, int repeats, cudaStream_t stream) {
    const int xb = x_bytes(K * Op<INT8>::ITEM);
    stages = (MAX_SMEM - 1024 - 2 * xb - BARRIERS) / STAGE;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    smem = 1024 + 2 * xb + stages * STAGE + BARRIERS;
    const int tiles = repeats * (M / ROWS);
    R = cluster_rows(tiles);
    P = (N + COLS - 1) / COLS;
    config.gridDim = dim3(tiles * P);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = P * R;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    config.attrs = cluster;
    config.numAttrs = 1;
  }
};

template <bool INT8>
int run(const void* x, const void* wt, void* out, long long* stamps, int M, int N, int K,
        int W, int reps, int repeats, cudaStream_t stream) {
  constexpr int ITEM = Op<INT8>::ITEM;
  Launch<INT8> launch(M, N, K, repeats, stream);
  if (launch.stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;
  if (!hop::make_map(&map_w, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     ITEM, wt, K, N, W, KB / ITEM, SLICE, CU_TENSOR_MAP_SWIZZLE_64B))
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      rate_wgmma<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, launch.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&launch.config, rate_wgmma<INT8>, map_w,
                           static_cast<const unsigned char*>(x),
                           static_cast<typename Op<INT8>::Acc*>(out), stamps, M, N, K, W, reps,
                           launch.R, launch.P, launch.stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool INT8>
int max_clusters(int M, int N, int K, int repeats) {
  Launch<INT8> launch(M, N, K, repeats, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      rate_wgmma<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, launch.smem);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, rate_wgmma<INT8>, &launch.config);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace

// x (M, K) int8 or bf16, wt (W, N, K) the same type, out (M, N) int32 or
// f32.  Returns a CUDA error code, or -1 when the CUDA driver refuses the
// tensor map; shapes outside the kernel's tiles (M % 64, K % 64, K <= 512,
// K <= N <= 1024, N % 64) are cudaErrorInvalidValue.
// `stamps` may be null (see rate_wgmma).
extern "C" int matmul_rate_forward(int is_int8, const void* x, const void* wt, void* out,
                                   long long* stamps, int M, int N, int K, int W, int reps,
                                   int repeats, void* stream) {
  if (M % ROWS != 0 || M < ROWS || K % 64 != 0 || K < 64 || K > COLS || N % 64 != 0 ||
      N > 2 * COLS || K > N || W < 1 || reps < 1 || repeats < 1 || repeats > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return run<true>(x, wt, out, stamps, M, N, K, W, reps, repeats, (cudaStream_t)stream);
  return run<false>(x, wt, out, stamps, M, N, K, W, reps, repeats, (cudaStream_t)stream);
}

// The clusters of one call's launch that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int matmul_rate_max_clusters(int is_int8, int M, int N, int K, int repeats) {
  return is_int8 ? max_clusters<true>(M, N, K, repeats) : max_clusters<false>(M, N, K, repeats);
}
