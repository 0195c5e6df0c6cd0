"""The WaveGlow WN coupling block with int8 products: CUDA kernel wrapper,
weight quantizer and plain version.

Replaces the TPU kernel `fused_wn_block_int8`
(``text_to_speech_tpu/ops/pallas_kernels.py``).  The kernel is
``csrc/wn_block_int8.cu`` (see its header for the design and its bound):
warp-specialised wgmma s8 kernels fed by TMA, 2L + 2 launches a block, the
row quantization of the gate and of x inside the GEMMs.  `l2_bytes` counts
what they move through L2.

`fused_wn_block_int8` launches the kernel for CUDA tensors and counts its
calls in ``fused_wn_block_int8.launches``.  For CPU tensors it computes
`wn_block_int8_plain`, the same function in plain PyTorch; any other
device raises.  On CUDA tensors it never falls back: outside the kernel's
envelope it raises.

Weights: `quantize_wn_weights` turns one block's float32 weights in the
JAX package's stacked layout (``WaveGlow._stack_block``, the JAX
``_pack_block``) into int8 with per-output-channel scales, under the JAX
package's names; `pack_wn_int8` lays them out for the kernel:

  - ``w_in_cond (L, 2C, 3C + S)`` int8: output channel n holds, along the
    reduction, the three dilated taps of ``w_in`` then ``w_cond``;
  - ``s_in``, ``s_cond`` ``(L, 2C)``; ``b_in_cond (L, 2C)`` = ``b_in + b_cond``
    in float32, one add, as the reference adds it;
  - ``w_rs (L-1, 2C, C)``, ``s_rs``, ``b_rs (L-1, 2C)``; ``w_rs_last (C, C)``
    (output-major), ``s_rs_last``, ``b_rs_last (C,)``.

Arithmetic (the TPU kernel's, as `wn_block_int8_reference` simulates it):
each activation row (one time step) quantizes on its own,
``scale = max(amax, 1e-8) / 127`` and ``q = clip(round(x / scale), -127,
127)`` with ties to even; the conditioning rows once per call; the three
taps' int32 products each take their own row scale before they are summed,
then the per-channel weight scales and the bias apply; the gate requantizes
per row, or with the fixed scale 1/127 under ``static_gate_scale`` (1/127
then folded into ``s_rs`` and ``s_rs_last``).  The residual adds to the
true stream, which is stored in the buffer dtype, while the next layer
quantizes the float32 sum.  The skip sum stays float32 and is returned in
the buffer dtype.  Rows outside ``[0, T)`` read as q = 0 with scale 0.
The TPU kernel divides by 127 as ``* (1 / 127.)`` and its reference as
``/ 127.``; kernel and plain version here both divide, as the reference.
"""

import ctypes

import torch

from ._build import load_library
from .wn_block import _shift

EPS = 1e-8


def _over_127(t):
    """t / 127 as a true division on every device (PyTorch turns a division
    by a Python number into a product with its reciprocal on a card)."""
    return t / t.new_tensor(127.)


def quantize_wn_weights(packed):
    """One block's float32 weights (JAX names and layouts: ``w_in (L, 3, C,
    2C)``, ``w_cond (L, S, 2C)``, ``w_rs (L-1, C, 2C)``, ``w_rs_last (C, C)``
    and their biases) → symmetric int8 with per-output-channel float32
    scales; the three taps share their channel's scale.  A copy of the JAX
    package's `quantize_wn_weights`, which it matches bit for bit."""
    def q(w, dims):
        w = w.float()
        scale = _over_127(torch.clamp(w.abs().amax(dim = dims, keepdim = True), min = EPS))
        w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        for d in sorted(dims, reverse = True):
            scale = scale.squeeze(d)
        return w_q, scale

    w_in, s_in = q(packed['w_in'], (1, 2))
    w_cond, s_cond = q(packed['w_cond'], (1,))
    w_rs, s_rs = q(packed['w_rs'], (1,))
    w_last, s_last = q(packed['w_rs_last'], (0,))
    f32 = lambda key: packed[key].float()
    return {
        'w_in': w_in, 's_in': s_in, 'b_in': f32('b_in'),
        'w_cond': w_cond, 's_cond': s_cond, 'b_cond': f32('b_cond'),
        'w_rs': w_rs, 's_rs': s_rs, 'b_rs': f32('b_rs'),
        'w_rs_last': w_last, 's_rs_last': s_last, 'b_rs_last': f32('b_rs_last'),
    }


def pack_wn_int8(quant):
    """`quantize_wn_weights` output → the kernel's layout (module docstring)."""
    L, _, C, N = quant['w_in'].shape
    w_in_cond = torch.cat([quant['w_in'].reshape(L, 3 * C, N), quant['w_cond']], dim = 1)
    return {
        'w_in_cond': w_in_cond.transpose(1, 2).contiguous(),
        's_in': quant['s_in'].contiguous(), 's_cond': quant['s_cond'].contiguous(),
        'b_in_cond': (quant['b_in'] + quant['b_cond']).contiguous(),
        'w_rs': quant['w_rs'].transpose(1, 2).contiguous(),
        's_rs': quant['s_rs'].contiguous(), 'b_rs': quant['b_rs'].contiguous(),
        'w_rs_last': quant['w_rs_last'].T.contiguous(),
        's_rs_last': quant['s_rs_last'].contiguous(),
        'b_rs_last': quant['b_rs_last'].contiguous(),
    }


def _row_quant(x):
    """Per-row symmetric int8 (as float values) and the row scales (…, 1)."""
    scale = _over_127(torch.clamp(x.abs().amax(dim = -1, keepdim = True), min = EPS))
    return torch.clamp(torch.round(x / scale), -127, 127), scale


def _int_mm(q, w):
    """Exact integer product of int8-valued `q` (…, K) and int8 `w` (N, K),
    returned in float32 (the int32 sum converted once).  Float64 holds every
    partial sum exactly (|sum| <= K * 127**2 < 2**53), on the CPU and on a
    card alike."""
    return (q.double() @ w.double().T).float()


def wn_block_int8_plain(x, spect, q, static_gate_scale = False):
    """`fused_wn_block_int8` in plain PyTorch: the reference's operations in
    its order, rounding the stream where the kernel stores it."""
    dtype = x.dtype
    C = x.shape[-1]
    L = q['w_in_cond'].shape[0]
    w_in_cond = q['w_in_cond']
    x = x.float()
    sp_q, sp_s = _row_quant(spect.float())
    x_q, x_s = _row_quant(x)
    skip = torch.zeros(x.shape, dtype = torch.float32, device = x.device)
    for i in range(L):
        d = 2 ** i
        acc = 0.
        for tap, k in enumerate((d, 0, -d)):       # rows t - d, t, t + d
            w = w_in_cond[i, :, tap * C: (tap + 1) * C]
            acc = acc + _int_mm(_shift(x_q, k), w) * _shift(x_s, k)
        cond = _int_mm(sp_q, w_in_cond[i, :, 3 * C:]) * sp_s
        acts = acc * q['s_in'][i] + cond * q['s_cond'][i] + q['b_in_cond'][i]
        gated = torch.tanh(acts[..., :C]) * torch.sigmoid(acts[..., C:])
        if static_gate_scale:
            g_q, g_s = torch.clamp(torch.round(gated * 127.), -127., 127.), 1.
            s_rs = q['s_rs'] * (1. / 127.)
            s_last = q['s_rs_last'] * (1. / 127.)
        else:
            (g_q, g_s), s_rs, s_last = _row_quant(gated), q['s_rs'], q['s_rs_last']
        if i == L - 1:
            skip = skip + (_int_mm(g_q, q['w_rs_last']) * g_s * s_last + q['b_rs_last'])
        else:
            rs = _int_mm(g_q, q['w_rs'][i]) * g_s * s_rs[i] + q['b_rs'][i]
            new_x = x + rs[..., :C]
            x_q, x_s = _row_quant(new_x)            # from the float32 sum
            x = new_x.to(dtype).float()             # the stored stream
            skip = skip + rs[..., C:]
    return skip.to(dtype)


MAX_C = 512     # the residual columns of a 64-row tile stay in registers


def grid_tiles(B, T, C):
    """Tiles of one layer's two GEMMs: 128 x 64-gate-column tiles of the
    first, 64-row blocks of the second."""
    return {'in': B * -(-T // 128) * (C // 64), 'rs': B * -(-T // 64)}


def l2_bytes(B, T, C, S, L, itemsize, static_gate_scale = False):
    """Bytes that cross L2 in one call, by the kernels' tiling: the two
    row quantizations; every 128-row in-GEMM tile reads, for each of its
    64-column gate tiles, its A and weight stages (whole TMA boxes) and
    writes its gate; every 64-row rs tile reads its gate rows and all of
    the layer's weights in 256-column pairs, reads and writes x and the skip
    sum, and writes the next layer's qx."""
    M = B * T
    gate = 1 if static_gate_scale else 4
    total = M * (S + C) * (itemsize + 1)                     # row_quant: mel, x
    k_in = 3 * C + 128 * -(-S // 128)
    total += L * B * -(-T // 128) * (C // 64) * k_in * (128 + 128)
    total += L * M * C * gate                                 # the gate written
    rs_tiles = B * -(-T // 64)
    for i in range(L):
        last = i == L - 1
        chunks = C // 128 if last else 2 * C // 128
        pairs = -(-chunks // 2) if last else 2 * -(-(C // 128) // 2)
        total += rs_tiles * (64 * C * gate + pairs * 256 * C)
        if not last:
            total += M * C * (2 * itemsize + 1)              # x read and written, qx
    total += M * C * 4 * (2 * (L - 1) - 1) + M * C * (4 + itemsize)   # skip; output
    return total


def _kernel():
    fn = load_library('wn_block_int8').wn_block_int8_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_WEIGHTS = ('w_in_cond', 's_in', 's_cond', 'b_in_cond', 'w_rs', 's_rs', 'b_rs',
            'w_rs_last', 's_rs_last', 'b_rs_last')


def _check(x, spect, q):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('fused_wn_block_int8 takes float32 or bfloat16, got {}'.format(x.dtype))
    B, T, C = x.shape
    S = spect.shape[-1]
    L = q['w_in_cond'].shape[0]
    if C % 128 or C > MAX_C or S % 64 or L < 2:
        raise ValueError('fused_wn_block_int8 needs C % 128 == 0, C <= {}, S % 64 == 0 '
                         'and L >= 2; got C={}, S={}, L={}'.format(MAX_C, C, S, L))
    i8, f32 = torch.int8, torch.float32
    expected = {
        'spect': (spect, (B, T, S), x.dtype),
        'w_in_cond': (q['w_in_cond'], (L, 2 * C, 3 * C + S), i8),
        's_in': (q['s_in'], (L, 2 * C), f32), 's_cond': (q['s_cond'], (L, 2 * C), f32),
        'b_in_cond': (q['b_in_cond'], (L, 2 * C), f32),
        'w_rs': (q['w_rs'], (L - 1, 2 * C, C), i8),
        's_rs': (q['s_rs'], (L - 1, 2 * C), f32), 'b_rs': (q['b_rs'], (L - 1, 2 * C), f32),
        'w_rs_last': (q['w_rs_last'], (C, C), i8),
        's_rs_last': (q['s_rs_last'], (C,), f32), 'b_rs_last': (q['b_rs_last'], (C,), f32),
    }
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError('{}: expected {} {}, got {} {}'.format(
                name, shape, dtype, tuple(t.shape), t.dtype))
    for name, t in [('x', x)] + [(n, v[0]) for n, v in expected.items()]:
        if t.device != x.device:
            raise ValueError('{} is on {}, x on {}'.format(name, t.device, x.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))


def fused_wn_block_int8(x, spect, q, static_gate_scale = False):
    """Whole WN coupling block in int8: x (B, T, C) start-conv output and
    spect (B, T, S) upsampled mel, both in the buffer dtype, `q` from
    `pack_wn_int8` → skip sum (B, T, C) in the buffer dtype.  The `end`
    conv runs outside."""
    if x.device.type == 'cpu':
        return wn_block_int8_plain(x, spect, q, static_gate_scale)
    if x.device.type != 'cuda':
        raise ValueError('fused_wn_block_int8 runs on cuda (or cpu via its plain '
                         'version), got {}'.format(x.device))
    _check(x, spect, q)
    B, T, C = x.shape
    M, S = B * T, spect.shape[-1]
    on = dict(device = x.device)
    f32, i8 = dict(on, dtype = torch.float32), dict(on, dtype = torch.int8)
    work = x.clone()
    # the f32 gate (the int8 one with the static scale) and the two per-row
    # amax buffers the kernels clear in turn
    gated = None if static_gate_scale else torch.empty((M, C), ** f32)
    gate_q = torch.empty((M, C), ** i8) if static_gate_scale else None
    scratch = [torch.empty((2, M), dtype = torch.int32, device = x.device),   # amax
               torch.empty((M, C), ** i8), torch.empty((M,), ** f32),     # x_q, x_s
               torch.empty((M, S), ** i8), torch.empty((M,), ** f32),     # spect
               gate_q, torch.empty((M, C), ** f32)]                       # gate, skip sum
    out = torch.empty_like(x)
    ptr = lambda t: t.data_ptr() if t is not None else None
    tensors = [work, spect] + [q[k] for k in _WEIGHTS] + [gated] + scratch + [out]
    ptrs = (ctypes.c_void_p * len(tensors))(* (ptr(t) for t in tensors))
    ints = (ctypes.c_longlong * 7)(int(x.dtype == torch.bfloat16), B, T, C, S,
                                   q['w_in_cond'].shape[0], int(bool(static_gate_scale)))
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(ptrs, ints, stream)
    if err == -1:
        raise ValueError('fused_wn_block_int8: the CUDA driver refused a TMA tensor map (base '
                         'addresses must be 16-byte aligned, row strides a multiple of 16 '
                         'bytes)')
    if err != 0:
        raise RuntimeError('wn_block_int8 kernel launch failed: CUDA error {}'.format(err))
    fused_wn_block_int8.launches += 1
    return out


fused_wn_block_int8.launches = 0
