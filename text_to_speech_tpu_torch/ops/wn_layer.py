"""One WaveGlow WN layer: CUDA kernel wrapper and plain version.

Replaces the TPU kernel `fused_wn_layer`
(``text_to_speech_tpu/ops/pallas_kernels.py``).  The kernel is
``csrc/wn_layer.cu`` (see its header for the design and its bound): in
bfloat16 the whole-block kernel's two wgmma GEMMs (``csrc/wn_sm90.cuh``),
in float32 FMA tiles.  `grid_tiles` and `l2_bytes` count the bf16 kernels'
tiles and what they move through L2.

`fused_wn_layer` launches the kernel for CUDA tensors and counts its calls in
``fused_wn_layer.launches``.  For CPU tensors it computes `wn_layer_plain`,
the same function in plain PyTorch; any other device raises.  Weights keep
the JAX package's layouts: ``w_in (3, C, 2C)`` (the three dilated taps),
``w_rs (1, C, 2C)``, or ``(1, C, C)`` for the last layer.  Every tensor is in
x's dtype: products run in that dtype with float32 accumulation, the gate
and the outputs round to it.  The TPU kernel's pre-padded input (``pad``) and
its time tile (``tile``) are dropped: x is unpadded and rows outside
``[0, T)`` read as zero.

Neither kernel has a gradient, as the TPU kernel has none (Pallas gives
``pallas_call`` no transpose rule): `fused_wn_layer` raises when autograd
would record it.  Training takes the whole-block kernel instead
(``wn_train_fused``, `models.waveglow_arch.WaveGlow.wn_block_train`).
"""

import ctypes

import torch

from ._build import load_library
from .wn_block import BM, IN_N, RS_N, _shift


def wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, *, dilation, residual = True):
    """`fused_wn_layer` in plain PyTorch: float32 sums on values of x's
    dtype, rounded where the kernel rounds.  Returns (x_out, skip)."""
    dtype = x.dtype
    C = x.shape[-1]
    xf = x.float()
    taps = torch.cat([_shift(xf, dilation), xf, _shift(xf, -dilation)], dim = -1)
    acts = taps @ w_in.reshape(3 * C, 2 * C).float() + b_in.float() + cond.float()
    gated = (torch.tanh(acts[..., :C]) * torch.sigmoid(acts[..., C:])).to(dtype)
    rs = gated.float() @ w_rs[0].float() + b_rs.float()
    if residual:
        return (xf + rs[..., :C]).to(dtype), rs[..., C:].to(dtype)
    return x, rs.to(dtype)


def grid_tiles(B, T, C, residual = True):
    """Tiles of the two bf16 GEMMs of one call: {'in', 'rs'} (128-row tiles,
    cut per batch row; 256 acts columns an in-tile, 128 rs columns an
    rs-tile)."""
    row_tiles = B * -(-T // BM)
    N = 2 * C if residual else C
    return {'in': row_tiles * (2 * C // IN_N), 'rs': row_tiles * (N // RS_N)}


def l2_bytes(B, T, C, residual = True):
    """Bytes that cross L2 in one bfloat16 call, by the kernels' tiling:
    every tile reads, for each of its k stages, its A box and its weight
    boxes (whole TMA boxes, zero-filled ones included); the in-GEMM's
    epilogue reads cond and writes the gate, the rs-GEMM's reads x and
    writes x_out and skip (the last layer: skip alone), each once."""
    M = B * T
    tiles = grid_tiles(B, T, C, residual)
    total = tiles['in'] * 3 * C * (BM + IN_N) * 2
    total += M * 2 * C * 2 + M * C * 2          # cond; the gate
    total += tiles['rs'] * C * (BM + RS_N) * 2
    total += M * C * 2 * (3 if residual else 1)
    return total


def _kernel():
    fn = load_library('wn_layer').wn_layer_forward
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32] + [ptr] * 9 + [i32] * 6 + [ptr]
        fn.restype = i32
    return fn


def _check(x, cond, w_in, b_in, w_rs, b_rs, dilation, residual):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('fused_wn_layer takes float32 or bfloat16, got {}'.format(x.dtype))
    B, T, C = x.shape
    if C % 128 or C > 512 or dilation < 1:
        raise ValueError('fused_wn_layer needs C % 128 == 0, C <= 512 and a dilation '
                         '>= 1; got C={}, dilation={}'.format(C, dilation))
    N = 2 * C if residual else C
    shapes = {'cond': (cond, (B, T, 2 * C)), 'w_in': (w_in, (3, C, 2 * C)),
              'b_in': (b_in, (2 * C,)), 'w_rs': (w_rs, (1, C, N)), 'b_rs': (b_rs, (N,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError('{}: expected {} {}, got {} {}'.format(
                name, shape, x.dtype, tuple(t.shape), t.dtype))
    for name, t in [('x', x)] + [(n, v[0]) for n, v in shapes.items()]:
        if t.device != x.device:
            raise ValueError('{} is on {}, x on {}'.format(name, t.device, x.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))


def fused_wn_layer(x, cond, w_in, b_in, w_rs, b_rs, *, dilation, residual = True):
    """One WN layer: x (B, T, C) and cond (B, T, 2C) (the projected mel) →
    (x_out, skip), both (B, T, C) in x's dtype; ``x_out = x + rs[:, :C]``
    with `residual`, else x itself and ``skip = rs``."""
    args = (x, cond, w_in, b_in, w_rs, b_rs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            'fused_wn_layer has no backward (the TPU kernel has none either): call '
            'it under torch.no_grad(); to train on a kernel, set wn_train_fused, '
            'which runs the whole-block kernel forward with a recomputed backward')
    if x.device.type == 'cpu':
        return wn_layer_plain(* args, dilation = dilation, residual = residual)
    if x.device.type != 'cuda':
        raise ValueError('fused_wn_layer runs on cuda (or cpu via its plain '
                         'version), got {}'.format(x.device))
    _check(* args, dilation, residual)
    B, T, C = x.shape
    bf16 = x.dtype == torch.bfloat16
    x_out = torch.empty_like(x) if residual else None
    skip = torch.empty_like(x)
    gated = torch.empty_like(x) if bf16 else None      # between the two GEMMs
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(
            int(bf16), x.data_ptr(), cond.data_ptr(),
            w_in.data_ptr(), b_in.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
            x_out.data_ptr() if residual else None, skip.data_ptr(),
            gated.data_ptr() if bf16 else None,
            B, T, C, w_rs.shape[-1], dilation, int(residual), stream)
    if err == -1:
        raise ValueError('fused_wn_layer: the CUDA driver refused a TMA tensor map (base '
                         'addresses must be 16-byte aligned, row strides a multiple of 16 '
                         'bytes)')
    if err != 0:
        raise RuntimeError('wn_layer kernel launch failed: CUDA error {}'.format(err))
    fused_wn_layer.launches += 1
    return (x_out if residual else x), skip


fused_wn_layer.launches = 0
