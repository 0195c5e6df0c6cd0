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

ROWS = 32                 # rows a block; M is a multiple
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


def shared_bytes(K, N, itemsize):
    """Shared memory of one block: the block's rows of x and each warp's
    ring of three 64 x 64-byte stages."""
    return ROWS * (K * itemsize + 16) + (N // 64) * 3 * 64 * 64


def l2_bytes(M, K, N, reps, grid, itemsize):
    """Bytes that cross L2 in one call, by the kernel's tiling: each block
    reads w[r % W] for every product, its rows of x once, and writes its
    rows of out."""
    blocks = grid * (M // ROWS)
    return blocks * (reps * K * N * itemsize + ROWS * K * itemsize + ROWS * N * 4)


def _kernel():
    fn = load_library('matmul_rate').matmul_rate_forward
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, ptr, ptr, ptr] + [i32] * 6 + [ptr]
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
    if M % ROWS or K % 64 or N % 64 or N > 1024 or K > N:
        raise ValueError('matmul_rate needs M % 32 == 0, K % 64 == 0, N % 64 == 0, '
                         'N <= 1024 and K <= N; got M={}, K={}, N={}'.format(M, K, N))
    if shared_bytes(K, N, x.element_size()) > MAX_SHARED:
        raise ValueError('matmul_rate: K={}, N={} in {} need {} bytes of shared memory, '
                         'more than {}'.format(K, N, x.dtype,
                                               shared_bytes(K, N, x.element_size()),
                                               MAX_SHARED))
    if reps < 1 or not 1 <= grid <= 65535:
        raise ValueError('matmul_rate needs reps >= 1 and 1 <= grid <= 65535; got {}, {}'
                         .format(reps, grid))
    if w.device != x.device:
        raise ValueError('w is on {}, x on {}'.format(w.device, x.device))
    for name, t in (('x', x), ('w', w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))


def matmul_rate(x, w, reps, grid = 1):
    """x (M, K) and w (W, K, N), int8 or bf16 → acc (M, N), int32 or
    float32, after `reps` chained products, computed `grid` times."""
    if x.device.type == 'cpu':
        return matmul_rate_plain(x, w, reps, grid)
    if x.device.type != 'cuda':
        raise ValueError('matmul_rate runs on cuda (or cpu via its plain version), got {}'
                         .format(x.device))
    _check(x, w, reps, grid)
    (M, K), (W, _, N) = x.shape, w.shape
    int8 = x.dtype == torch.int8
    # (W, N, K): both operands' fragments run along K
    wt = w.transpose(1, 2).contiguous()
    out = torch.empty((M, N), device = x.device,
                      dtype = torch.int32 if int8 else torch.float32)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(int(int8), x.data_ptr(), wt.data_ptr(), out.data_ptr(), M, N, K, W,
                     reps, grid, stream)
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
