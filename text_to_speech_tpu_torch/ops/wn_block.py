"""The WaveGlow WN coupling block: CUDA kernel wrapper and plain version.

Replaces the TPU kernel `fused_wn_block`
(``text_to_speech_tpu/ops/pallas_kernels.py``).  The kernel is
``csrc/wn_block.cu`` (see its header for the design and its bound): in
bfloat16 warp-specialised wgmma kernels fed by TMA, in float32 FMA tiles.
`l2_bytes` counts what the bf16 kernels move through L2.

`fused_wn_block` calls the op ``torch.ops.tts_torch.wn_block``, which
launches the kernel for CUDA tensors and counts its launches in
``fused_wn_block.launches`` (also inside an exported program), and computes
`wn_block_plain`, the same function in plain PyTorch, for CPU tensors; any
other device raises.  Its fake implementation gives `torch.export` the
output's shape; its flop formula is `wn_block_work`'s count.

Weights come in the kernel's layout, made by `pack_wn_weights` from the JAX
package's stacked layout (``WaveGlow._pack_block``):

  - ``w_in_cond (L, 3C + S, 2C)``: the three dilated taps of ``w_in`` and
    ``w_cond`` stacked along the reduction axis, so that one product over
    ``[x[t-d] | x[t] | x[t+d] | spect[t]]`` gives a layer's pre-activations;
  - ``b_in_cond (L, 2C)`` = ``b_in + b_cond``;
  - ``w_rs (L-1, C, 2C)``, ``b_rs (L-1, 2C)``, ``w_rs_last (C, C)``,
    ``b_rs_last (C,)``.

Weights are in the buffer dtype (float32 or bfloat16), biases always
float32.  Products accumulate in float32, the gated activations and the
residual stream round to the buffer dtype after every layer, the skip sum
stays float32 and is returned in the buffer dtype: the TPU kernel's
contract.  The time padding the TPU kernel needed (``wn_block_pad``) is
dropped: rows outside ``[0, T)`` read as zero.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ._build import load_library


def pack_wn_weights(w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_rs_last,
                    b_rs_last, dtype = torch.float32):
    """The JAX package's stacked block weights → the kernel's layout.

    Biases are rounded to `dtype` first and summed in float32, as the TPU
    kernel adds its `dtype` biases in float32."""
    L, _, C, N = w_in.shape
    w_in_cond = torch.cat([w_in.reshape(L, 3 * C, N), w_cond], dim = 1)
    as_f32 = lambda b: b.to(dtype).float().contiguous()
    return {
        'w_in_cond': w_in_cond.to(dtype).contiguous(),
        'b_in_cond': (b_in.to(dtype).float() + b_cond.to(dtype).float()).contiguous(),
        'w_rs': w_rs.to(dtype).contiguous(),
        'b_rs': as_f32(b_rs),
        'w_rs_last': w_rs_last.to(dtype).contiguous(),
        'b_rs_last': as_f32(b_rs_last),
    }


def _shift(x, d):
    """Row t of the result is row t - d of x (zero outside [0, T))."""
    T = x.shape[1]
    if d >= 0:
        return F.pad(x, (0, 0, d, 0))[:, :T]
    return F.pad(x, (0, 0, 0, -d))[:, -d: -d + T]


def wn_block_plain(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last,
                   b_rs_last):
    """`fused_wn_block` in plain PyTorch: the per-layer SAME-pad chain.

    Computes in float32 on values of the buffer dtype and rounds where the
    kernel rounds, so it is the kernel's reference in both dtypes."""
    dtype = x.dtype
    C = x.shape[-1]
    L = w_in_cond.shape[0]
    xf, sp = x.float(), spect.float()
    skip = torch.zeros(x.shape, dtype = torch.float32, device = x.device)
    for i in range(L):
        d = 2 ** i
        a = torch.cat([_shift(xf, d), xf, _shift(xf, -d), sp], dim = -1)
        acts = a @ w_in_cond[i].float() + b_in_cond[i]
        gated = (torch.tanh(acts[..., :C]) * torch.sigmoid(acts[..., C:]))
        gated = gated.to(dtype).float()
        if i == L - 1:
            skip = skip + (gated @ w_rs_last.float() + b_rs_last)
        else:
            rs = gated @ w_rs[i].float() + b_rs[i]
            xf = (xf + rs[..., :C]).to(dtype).float()
            skip = skip + rs[..., C:]
    return skip.to(dtype)


BM = 128        # rows of the bf16 kernels' tiles; the in-GEMM's cover 256
IN_N, RS_N = 256, 128       # accumulator columns, in-GEMM and rs-GEMM


def grid_tiles(B, T, C):
    """Tiles of one layer's two bf16 GEMMs: {'in', 'rs', 'rs_last'}."""
    row_tiles = B * -(-T // BM)
    return {'in': row_tiles * (2 * C // IN_N), 'rs': row_tiles * (2 * C // RS_N),
            'rs_last': row_tiles * (C // RS_N)}


def l2_bytes(B, T, C, S, L):
    """Bytes that cross L2 in one bfloat16 call, by the kernels' tiling:
    every 128-row tile reads, for each of its column tiles, its A stages
    and its weight stages (whole TMA boxes, zero-filled ones included); the
    in-GEMM's epilogue writes gated, the rs-GEMM's reads and writes x and
    the skip sum and writes the output, each once."""
    M, row_tiles = B * T, B * -(-T // BM)
    tiles = grid_tiles(B, T, C)
    total = L * tiles['in'] * (3 * C + 64 * -(-S // 64)) * (BM + IN_N) * 2
    total += ((L - 1) * tiles['rs'] + tiles['rs_last']) * C * (BM + RS_N) * 2
    total += L * M * C * 2                  # gated
    total += (L - 1) * M * C * 2 * 2        # x, read and written
    total += M * C * 4 * (2 * (L - 1) - 1) + M * C * (4 + 2)    # skip; the output
    return total


def _kernel():
    fn = load_library('wn_block').wn_block_forward
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32] + [ptr] * 11 + [i32] * 5 + [ptr]
        fn.restype = i32
    return fn


def _check(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('fused_wn_block takes float32 or bfloat16, got {}'.format(x.dtype))
    B, T, C = x.shape
    L = w_in_cond.shape[0]
    S = spect.shape[-1]
    if C % 128 or S % 32 or L < 2:
        raise ValueError('fused_wn_block needs C % 128 == 0, S % 32 == 0 and '
                         'L >= 2; got C={}, S={}, L={}'.format(C, S, L))
    shapes = {
        'spect': (spect, (B, T, S), x.dtype),
        'w_in_cond': (w_in_cond, (L, 3 * C + S, 2 * C), x.dtype),
        'b_in_cond': (b_in_cond, (L, 2 * C), torch.float32),
        'w_rs': (w_rs, (L - 1, C, 2 * C), x.dtype),
        'b_rs': (b_rs, (L - 1, 2 * C), torch.float32),
        'w_rs_last': (w_rs_last, (C, C), x.dtype),
        'b_rs_last': (b_rs_last, (C,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError('{}: expected {} {}, got {} {}'.format(
                name, shape, dtype, tuple(t.shape), t.dtype))
    for name, t in [('x', x)] + [(n, v[0]) for n, v in shapes.items()]:
        if t.device != x.device:
            raise ValueError('{} is on {}, x on {}'.format(name, t.device, x.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))


def _launch(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last):
    """The kernel on CUDA tensors: checked, launched and counted."""
    _check(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last)
    B, T, C = x.shape
    work = x.clone()
    gated = torch.empty_like(x)
    skip = torch.empty(x.shape, dtype = torch.float32, device = x.device)
    out = torch.empty_like(x)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(
            int(x.dtype == torch.bfloat16), spect.data_ptr(),
            w_in_cond.data_ptr(), b_in_cond.data_ptr(), w_rs.data_ptr(),
            b_rs.data_ptr(), w_rs_last.data_ptr(), b_rs_last.data_ptr(),
            work.data_ptr(), gated.data_ptr(), skip.data_ptr(), out.data_ptr(),
            B, T, C, spect.shape[-1], w_in_cond.shape[0], stream)
    if err == -1:
        raise ValueError('fused_wn_block: the CUDA driver refused a TMA tensor map (base '
                         'addresses must be 16-byte aligned, row strides a multiple of 16 '
                         'bytes)')
    if err != 0:
        raise RuntimeError('wn_block kernel launch failed: CUDA error {}'.format(err))
    fused_wn_block.launches += 1
    return out


# The block as a `torch.library` op, so that `torch.export` holds it as one
# node: the CPU implementation is the plain version, the CUDA one the kernel
# (it raises outside the envelope), the fake one gives the output's shape.
# Registered at the dispatcher's level (`Library.impl`): `custom_op`'s
# Python layers cost more host time a call than the kernel's own wrapper.
_LIB = torch.library.Library('tts_torch', 'FRAGMENT')
_LIB.define('wn_block(Tensor x, Tensor spect, Tensor w_in_cond, Tensor b_in_cond, '
            'Tensor w_rs, Tensor b_rs, Tensor w_rs_last, Tensor b_rs_last) -> Tensor')
_LIB.impl('wn_block', wn_block_plain, 'CPU')
_LIB.impl('wn_block', _launch, 'CUDA')


@torch.library.register_fake('tts_torch::wn_block', lib = _LIB)
def _(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last):
    return torch.empty_like(x)


def wn_block_work(B, T, C, S, L, itemsize):
    """(operations, bytes) of one WN block call: every product, each input
    read once and the output written once."""
    flops = 2 * B * T * ((3 * C + S) * 2 * C * L + C * 2 * C * (L - 1) + C * C)
    weights = (L * (3 * C + S) * 2 * C + (L - 1) * C * 2 * C + C * C) * itemsize
    biases = (L * 2 * C + (L - 1) * 2 * C + C) * 4
    activations = B * T * (C + S + C) * itemsize
    return flops, weights + biases + activations


@register_flop_formula(torch.ops.tts_torch.wn_block)
def _wn_block_flops(x_shape, spect_shape, w_in_cond_shape, * _, ** __):
    (B, T, C), S, L = x_shape, spect_shape[-1], w_in_cond_shape[0]
    return wn_block_work(B, T, C, S, L, 1)[0]


def fused_wn_block(x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last,
                   b_rs_last):
    """Whole WN coupling block: x (B, T, C) start-conv output and spect
    (B, T, S) upsampled mel, both in the buffer dtype → skip sum (B, T, C)
    in the buffer dtype.  The `end` conv runs outside."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('fused_wn_block runs on cuda (or cpu via its plain '
                         'version), got {}'.format(x.device))
    return torch.ops.tts_torch.wn_block(x, spect, w_in_cond, b_in_cond, w_rs, b_rs,
                                        w_rs_last, b_rs_last)


fused_wn_block.launches = 0
