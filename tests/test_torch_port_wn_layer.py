"""One WN layer: the port's plain version against the JAX package's
reference, and the CUDA kernel against the plain version.

The TPU kernel (`fused_wn_layer`) moves its halo by TPU DMA and cannot run
on a CPU, so `wn_layer_plain` is held against its XLA reference
`wn_layer_reference` at C=32 and 128, T=100 and 512, dilations 1, 4 and 64
(one beyond T=100's rows on both sides of most rows), residual and last
layer, float32.  Tolerance 1e-5 of the output's largest magnitude: float32
on both sides, sums over 3C terms in another order.

The `cuda` cases hold the kernel (`fused_wn_layer` on CUDA tensors) against
`wn_layer_plain` on the same inputs: float32 within 1e-5 of the largest
output, bfloat16 within 2^-7 of it (one flipped bf16 rounding of the gate
moves an output by far less; one of an output by 2^-8 of a value).  They
skip without a card.  JAX is imported inside the CPU tests only, so that on
a machine with a card and without JAX the `cuda` cases run alone:

    python -m pytest tests/test_torch_port_wn_layer.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.ops.wn_layer import (
    fused_wn_layer, grid_tiles, l2_bytes, wn_layer_plain)

REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _inputs(C, T, B, residual, seed = 0):
    rng = np.random.default_rng(seed)
    f = lambda * shape, scale = 1.: (scale * rng.standard_normal(shape)).astype(np.float32)
    N = 2 * C if residual else C
    return (f(B, T, C), f(B, T, 2 * C, scale = 0.5), f(3, C, 2 * C, scale = (3 * C) ** -0.5),
            f(2 * C, scale = 0.1), f(1, C, N, scale = C ** -0.5), f(N, scale = 0.1))


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize('residual', [True, False])
@pytest.mark.parametrize('dilation', [1, 4, 64])
@pytest.mark.parametrize('C,T', [(32, 100), (32, 512), (128, 100), (128, 512)])
def test_plain_matches_reference(C, T, dilation, residual):
    from text_to_speech_tpu.ops.pallas_kernels import wn_layer_reference
    args = _inputs(C, T, 2, residual, seed = C + T + dilation)
    ref_x, ref_skip = wn_layer_reference(* args, dilation = dilation, residual = residual)
    out_x, out_skip = fused_wn_layer(* map(torch.from_numpy, args), dilation = dilation,
                                     residual = residual)     # CPU: the plain version
    assert out_skip.shape == (2, T, C) and out_x.shape == (2, T, C)
    assert _rel_err(out_x, ref_x) <= 1e-5
    assert _rel_err(out_skip, ref_skip) <= 1e-5
    if not residual:
        assert np.array_equal(out_x.numpy(), args[0])
    assert fused_wn_layer.launches == 0


def test_refuses_autograd():
    """No backward, as the TPU kernel has none: under autograd the wrapper
    raises, naming the kernel route for training; under no_grad it runs."""
    args = [torch.from_numpy(a) for a in _inputs(128, 16, 1, True)]
    args[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match = 'wn_train_fused'):
        fused_wn_layer(* args, dilation = 2)
    with torch.no_grad():
        x, skip = fused_wn_layer(* args, dilation = 2)
    assert not x.requires_grad and skip.shape == (1, 16, 128)


def test_plain_keeps_the_dtype_contract():
    """bf16 in, bf16 out, near the float32 layer (bf16 operands and gate)."""
    args = [torch.from_numpy(a) for a in _inputs(128, 64, 1, True, seed = 5)]
    out32 = wn_layer_plain(* args, dilation = 4)
    out16 = wn_layer_plain(* (a.to(torch.bfloat16) for a in args), dilation = 4)
    for a, b in zip(out16, out32):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a.float(), b) < 3e-2


def test_tiling_counts():
    """The bf16 kernels' tiles and L2 bytes against a hand count.  B=2,
    T=200: 128-row tiles cut per batch row, two a row, 4 row tiles; at
    C=128 one 256-column in-tile and two (residual) or one (last) 128-column
    rs-tiles a row tile.  The chip run divides the tiles by the SM count for
    the waves."""
    assert grid_tiles(2, 200, 128) == {'in': 4, 'rs': 8}
    assert grid_tiles(2, 200, 128, residual = False) == {'in': 4, 'rs': 4}
    assert grid_tiles(8, 8192, 512) == {'in': 2048, 'rs': 4096}
    # in: 4 tiles x 3C of k x (128 rows of x + 256 weight columns) x 2 bytes,
    # cond read and the gate written once; rs: its tiles x C x (128 + 128) x
    # 2, then x read, x_out and skip written (the last layer: skip)
    M = 400
    in_bytes = 4 * 384 * (128 + 256) * 2 + M * 256 * 2 + M * 128 * 2
    assert l2_bytes(2, 200, 128) == in_bytes + 8 * 128 * 256 * 2 + 3 * M * 128 * 2
    assert l2_bytes(2, 200, 128, residual = False) == (in_bytes + 4 * 128 * 256 * 2
                                                       + M * 128 * 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('residual', [True, False])
@pytest.mark.parametrize('C,T,B,dilation', [(512, 1000, 2, 1), (512, 1000, 2, 128),
                                             (256, 300, 3, 16), (128, 50, 2, 64),
                                             (128, 37, 1, 128), (512, 333, 8, 200),
                                             (256, 1000, 1, 200), (128, 130, 2, 200)])
def test_kernel_matches_plain(cuda_device, dtype, residual, C, T, B, dilation):
    """Ragged lengths (no multiple of the 128-row tile), B of 1, 2, 3 and 8,
    rows of one sequence that must not tap the next, and dilations beyond
    the tile (200: no power of two) and beyond T.  Each call launches the
    kernel once (bf16: the wgmma pair; no fallback)."""
    args = [torch.from_numpy(a).to(cuda_device, dtype)
            for a in _inputs(C, T, B, residual, seed = T + dilation)]
    before = fused_wn_layer.launches
    out = fused_wn_layer(* args, dilation = dilation, residual = residual)
    torch.cuda.synchronize()
    assert fused_wn_layer.launches == before + 1
    ref = wn_layer_plain(* args, dilation = dilation, residual = residual)
    for o, r in zip(out, ref):
        assert o.dtype == dtype and o.shape == (B, T, C)
        assert bool(torch.isfinite(o.float()).all())
        assert _rel_err(o.float().cpu(), r.float().cpu()) <= REL_TOL[dtype]
    if not residual:
        assert out[0] is args[0]


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(64, 16, 1, True)]
    with pytest.raises(ValueError):
        fused_wn_layer(* args, dilation = 1)
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(128, 16, 1, True)]
    with pytest.raises(ValueError):
        fused_wn_layer(* args[:-1], args[-1].double(), dilation = 1)
