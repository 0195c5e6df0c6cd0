"""The tensor-core rate probe: chained products with feedback.

Replaces the TPU kernel of ``benchmarks/matmul_rate.py`` (`build`, its body
`kernel`).  For x (M, K) and w (W, K, N) (W = 8 in the probe) it computes

    acc = 0
    for r in range(reps):  acc += x @ w[r % W];  x = next(acc[:, :K])

``grid`` times over, and returns acc (M, N): int32 with
``next(acc) = (acc & 127).astype(int8)`` for int8 operands, float32 with
``next(acc) = acc.astype(bfloat16)`` for bf16.  The kernel is
``csrc/matmul_rate.cu`` (see its header for the design and its bound).

`matmul_rate` launches the kernel for CUDA tensors and counts its calls in
``matmul_rate.launches``.  For CPU tensors it computes `matmul_rate_plain`,
the same function in plain PyTorch; any other device raises.  The int8
chain is exact in int32 while every sum stays under 2^31 (x <= 127 after the
first product and |w| <= 128, so ``K * 128 * 128 * reps < 2^31`` is enough),
and the two agree to the bit there; in bf16 they sum the same products in
another order.

`main` is the probe itself, as ``benchmarks/matmul_rate.py`` runs it: the
sizes come from ``MM_M``, ``MM_K``, ``MM_N``, ``MM_REPS`` and ``MM_GRID``
(defaults 512, 512, 1024, 64, 64), and it prints the rate of each type:

    python -m text_to_speech_tpu_torch.ops.matmul_rate
"""

import ctypes
import os
import time

import torch

from ..devices import default_device
from ._build import load_library

ROWS = 64                 # rows a row tile; M is a multiple
COLS = 512                # columns a block: a row tile spans ceil(N / COLS) blocks
STAGE = COLS * 64         # a ring stage: 512 columns of wt x 64 bytes of K
MAX_STAGES = 8
MAX_SHARED = 232448       # a block's shared memory on sm_90


def matmul_rate_plain(x, w, reps, grid = 1):
    """`matmul_rate` in plain PyTorch: the grid's repeats stacked as rows
    (the chain is row-local), each product in float32 (exact for int8
    values while a sum stays under 2^24, which K <= 1024 keeps), the sums
    in acc's type."""
    int8 = x.dtype == torch.int8
    K = x.shape[1]
    xs = x.repeat(grid, 1)
    acc = torch.zeros((xs.shape[0], w.shape[-1]), device = x.device,
                      dtype = torch.int32 if int8 else torch.float32)
    for r in range(reps):
        acc += (xs.float() @ w[r % w.shape[0]].float()).to(acc.dtype)
        xs = (acc[:, :K] & 127).to(torch.int8) if int8 else acc[:, :K].to(torch.bfloat16)
    return acc[:x.shape[0]]


def _x_bytes(K, itemsize):
    """One x buffer: 64 rows of K, in whole 128-byte chunks."""
    return ROWS * -(-K * itemsize // 128) * 128


def ring_stages(K, itemsize):
    """Stages of the w ring: as many as fit beside the two x buffers."""
    return min(MAX_STAGES, (MAX_SHARED - 1024 - 2 * _x_bytes(K, itemsize) - 256) // STAGE)


def shared_bytes(K, itemsize):
    """Shared memory of one block: two x buffers, the ring, 1 KB of
    alignment and 256 bytes of barriers."""
    return 1024 + 2 * _x_bytes(K, itemsize) + ring_stages(K, itemsize) * STAGE + 256


def cluster_shape(M, N, grid):
    """(R, P): the row tiles a cluster holds (4, 2 or 1, whichever divides
    the grid's row tiles first) and the blocks a row tile spans."""
    tiles = grid * M // ROWS
    return (4 if tiles % 4 == 0 else 2 if tiles % 2 == 0 else 1), -(-N // COLS)


def l2_bytes(M, K, N, reps, grid, itemsize):
    """Bytes that cross L2 in one call, by the kernel's tiling: each
    cluster reads w[r % W] (its N columns) once a product and multicasts it
    to its R row tiles; each block reads its tile's rows of x once, and
    each row tile writes its rows of out.  The copies of x between the
    blocks of a cluster stay in distributed shared memory."""
    R, P = cluster_shape(M, N, grid)
    tiles = grid * M // ROWS
    return (tiles // R * reps * K * N * itemsize + tiles * P * ROWS * K * itemsize
            + tiles * ROWS * N * 4)


def stamps_size(M, N, reps, grid):
    """Elements of the `stamps` tensor of a call: 2 + 4 reps a block."""
    return grid * M // ROWS * -(-N // COLS) * (2 + 4 * reps)


def product_times_us(stamps, M, N, reps, grid):
    """The kernel's clock stamps (`matmul_rate(..., stamps = ...)`) → a
    summary in µs: the blocks' spans and the rounds of blocks the card ran
    (distinct start times, 1 µs apart or more); medians over the chain
    blocks of a product (x ready → done), of the wait for the partner to
    release the next buffer, of the feed (the next x written and sent) and
    of the whole hand-off (done → the next product's x ready)."""
    R, P = cluster_shape(M, N, grid)
    t = stamps.cpu().double().reshape(-1, 2 + 4 * reps)
    t = t - t[:, 0].min()
    starts = t[:, 0].sort().values
    rounds = 1 + int((starts[1:] - starts[:-1] > 1e3).sum())
    # a cluster's blocks in rank order r + R p: its R chain blocks first
    chain = t[:, 2:].reshape(-1, P, R, reps, 4)[:, 0].reshape(-1, reps, 4)
    median = lambda v: float(v.median()) / 1e3
    return {'block_us': median(t[:, 1] - t[:, 0]), 'rounds': rounds,
            'span_us': float(t[:, 1].max()) / 1e3,
            'product_us': median(chain[:, :, 1] - chain[:, :, 0]),
            'release_wait_us': median(chain[:, 1:-1, 2] - chain[:, 1:-1, 1]),
            'feed_us': median(chain[:, :-1, 3] - chain[:, :-1, 2]),
            'handoff_us': median(chain[:, 1:, 0] - chain[:, :-1, 1])}


def max_clusters(x, N, grid):
    """The clusters of a call's launch that the card holds at once."""
    fn = load_library('matmul_rate').matmul_rate_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(int(x.dtype == torch.int8), x.shape[0], N, x.shape[1], grid)


def _kernel():
    fn = load_library('matmul_rate').matmul_rate_forward
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, ptr, ptr, ptr, ptr] + [i32] * 6 + [ptr]
        fn.restype = i32
    return fn


def _check(x, w, reps, grid):
    if x.dtype not in (torch.int8, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError('matmul_rate takes int8 or bfloat16 x and w of one type, got {} '
                        'and {}'.format(x.dtype, w.dtype))
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError('matmul_rate takes x (M, K) and w (W, K, N); got {} and {}'.format(
            tuple(x.shape), tuple(w.shape)))
    (M, K), N = x.shape, w.shape[2]
    if M % ROWS or M == 0 or K % 64 or K == 0 or K > COLS or N % 64 or N > 2 * COLS or K > N:
        raise ValueError('matmul_rate needs M % 64 == 0, K % 64 == 0, K <= 512, '
                         'N % 64 == 0 and K <= N <= 1024; got M={}, K={}, N={}'.format(M, K, N))
    if reps < 1 or not 1 <= grid <= 65535:
        raise ValueError('matmul_rate needs reps >= 1 and 1 <= grid <= 65535; got {}, {}'
                         .format(reps, grid))
    if w.device != x.device:
        raise ValueError('w is on {}, x on {}'.format(w.device, x.device))
    for name, t in (('x', x), ('w', w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))


def matmul_rate(x, w, reps, grid = 1, stamps = None):
    """x (M, K) and w (W, K, N), int8 or bf16 → acc (M, N), int32 or
    float32, after `reps` chained products, computed `grid` times.
    `stamps`: optional int64 CUDA tensor of `stamps_size` elements that
    receives the kernel's clock stamps (see `product_times_us`)."""
    if x.device.type == 'cpu':
        if stamps is not None:
            raise ValueError('stamps are taken by the CUDA kernel only')
        return matmul_rate_plain(x, w, reps, grid)
    if x.device.type != 'cuda':
        raise ValueError('matmul_rate runs on cuda (or cpu via its plain version), got {}'
                         .format(x.device))
    _check(x, w, reps, grid)
    (M, K), (W, _, N) = x.shape, w.shape
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != x.device
                               or tuple(stamps.shape) != (stamps_size(M, N, reps, grid),)):
        raise ValueError('stamps: expected int64 ({},) on {}'.format(
            stamps_size(M, N, reps, grid), x.device))
    int8 = x.dtype == torch.int8
    # (W, N, K): int8 wgmma reads B K-major only, and bf16 takes the same path
    wt = w.transpose(1, 2).contiguous()
    out = torch.empty((M, N), device = x.device,
                      dtype = torch.int32 if int8 else torch.float32)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(int(int8), x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                     None if stamps is None else stamps.data_ptr(), M, N, K, W, reps, grid,
                     stream)
    if err == -1:
        raise ValueError('matmul_rate: the CUDA driver refused the TMA tensor map of w')
    if err != 0:
        raise RuntimeError('matmul_rate kernel launch failed: CUDA error {}'.format(err))
    matmul_rate.launches += 1
    return out


matmul_rate.launches = 0

ITERS = 4


def probe(name, M, K, N, reps, grid, device):
    """One line of the probe: for `name` ``'int8'`` or ``'bf16'``, the
    script's inputs (ones; ones times 0.01 in bf16), two warm-up calls, then
    `ITERS` calls timed on the host clock up to the sum of the last output.
    Prints the rate and returns {'seconds', 'rate'}."""
    dtype = torch.int8 if name == 'int8' else torch.bfloat16
    x = torch.ones((M, K), dtype = dtype, device = device)
    w = torch.ones((8, K, N), dtype = dtype, device = device)
    if dtype == torch.bfloat16:
        w = w * 0.01
    fn = lambda: matmul_rate(x, w, reps, grid).float().sum()
    float(fn())
    float(fn())
    start = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    float(out)
    seconds = (time.perf_counter() - start) / ITERS
    ops = 2.0 * M * K * N * reps * grid
    print('{}: {:.4f}s  -> {:.0f} T{}/s'.format(
        name, seconds, ops / seconds / 1e12, 'OPS' if name == 'int8' else 'FLOP'), flush = True)
    return {'seconds': seconds, 'rate': ops / seconds}


def main(device = None):
    """The probe of ``benchmarks/matmul_rate.py``, in int8 then bf16, at
    the sizes of ``MM_M``, ``MM_K``, ``MM_N``, ``MM_REPS`` and ``MM_GRID``.
    Returns {name: {'seconds', 'rate'}}.  A failure raises."""
    device = default_device(device)
    sizes = [int(os.environ.get(key, default)) for key, default in
             (('MM_M', 512), ('MM_K', 512), ('MM_N', 1024), ('MM_REPS', 64), ('MM_GRID', 64))]
    return {name: probe(name, * sizes, device) for name in ('int8', 'bf16')}


if __name__ == '__main__':
    main()
