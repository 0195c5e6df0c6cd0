"""The WN coupling block: the port's plain version against the JAX
package's TPU kernel, and the CUDA kernel against the plain version.

On the CPU, `wn_block_plain` (float32) is held against `fused_wn_block`
run in Pallas interpret mode (C=128, L=3, S=64, T=512, B=2; the JAX kernel
needs T == seq_len, so the edges are the utterance's own ends) and against
`wn_block_reference` at a length that is not a multiple of 512.  Tolerance
2e-4 absolute on outputs of order 1: float32 on both sides, sums in another
order over K = 3C + S = 448 terms and three layers.

The `cuda` cases hold the kernel (`fused_wn_block` on CUDA tensors) against
`wn_block_plain` on the same inputs; they skip without a card.  JAX is
imported inside the CPU tests only, so that on a machine with a card and
without JAX the `cuda` cases run alone:

    python -m pytest tests/test_torch_port_wn_block.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.ops.wn_block import (
    fused_wn_block, pack_wn_weights, wn_block_plain)

ATOL = 2e-4


def _inputs(C, L, S, T, B, seed = 0):
    rng = np.random.default_rng(seed)
    f = lambda * shape, scale = 1.: (scale * rng.standard_normal(shape)).astype(np.float32)
    w = dict(
        w_cond = f(L, S, 2 * C, scale = S ** -0.5), b_cond = f(L, 2 * C, scale = 0.1),
        w_in = f(L, 3, C, 2 * C, scale = (3 * C) ** -0.5), b_in = f(L, 2 * C, scale = 0.1),
        w_rs = f(L - 1, C, 2 * C, scale = C ** -0.5), b_rs = f(L - 1, 2 * C, scale = 0.1),
        w_rs_last = f(C, C, scale = C ** -0.5), b_rs_last = f(C, scale = 0.1))
    return f(B, T, C), f(B, T, S), w


def _port(x, spect, w, dtype = torch.float32, device = 'cpu'):
    packed = pack_wn_weights(* (torch.from_numpy(w[k]) for k in (
        'w_cond', 'b_cond', 'w_in', 'b_in', 'w_rs', 'b_rs', 'w_rs_last', 'b_rs_last')),
        dtype = dtype)
    packed = {k: v.to(device) for k, v in packed.items()}
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(spect).to(device, dtype),
            packed['w_in_cond'], packed['b_in_cond'], packed['w_rs'], packed['b_rs'],
            packed['w_rs_last'], packed['b_rs_last'])


_ORDER = ('w_cond', 'b_cond', 'w_in', 'b_in', 'w_rs', 'b_rs', 'w_rs_last', 'b_rs_last')


def test_plain_matches_tpu_kernel_interpret():
    import jax.numpy as jnp
    from text_to_speech_tpu.ops.pallas_kernels import fused_wn_block as jax_fused_wn_block
    from text_to_speech_tpu.ops.pallas_kernels import wn_block_pad
    C, L, S, T, B = 128, 3, 64, 512, 2
    x, spect, w = _inputs(C, L, S, T, B)
    pad = wn_block_pad(L)
    padded = lambda a: jnp.pad(a, ((0, 0), (pad, pad), (0, 0)))
    ref = jax_fused_wn_block(padded(x), padded(spect), * (w[k] for k in _ORDER),
                             tile = 512, seq_len = T, interpret = True)
    out = wn_block_plain(* _port(x, spect, w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)


def test_plain_matches_reference_ragged():
    from text_to_speech_tpu.ops.pallas_kernels import wn_block_reference
    C, L, S, T, B = 128, 4, 96, 300, 2
    x, spect, w = _inputs(C, L, S, T, B, seed = 1)
    ref = wn_block_reference(x, spect, * (w[k] for k in _ORDER))
    out = fused_wn_block(* _port(x, spect, w))       # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)
    assert fused_wn_block.launches == 0


def test_plain_rounds_like_the_buffer_dtype():
    """In bf16 the plain version keeps the kernel's contract: a bf16 result,
    close to the float32 block (bf16 buffers keep ~3 significant digits)."""
    C, L, S, T, B = 128, 3, 64, 200, 1
    x, spect, w = _inputs(C, L, S, T, B, seed = 2)
    out16 = wn_block_plain(* _port(x, spect, w, dtype = torch.bfloat16))
    out32 = wn_block_plain(* _port(x, spect, w))
    assert out16.dtype == torch.bfloat16
    scale = float(out32.abs().max())
    assert float((out16.float() - out32).abs().max()) < 3e-2 * scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# (dtype, tolerance relative to the output's largest magnitude): f32 FMA
# tiles against f32 cuBLAS differ in summation order only; bf16 rounds the
# gated activations and the residual stream after every layer, where a
# different float32 sum can flip one bf16 rounding.
# Shapes: whole 128-row tiles; a tile that crosses the end of each batch row
# (T = 1000, and B = 3); T = 37 at L = 8, shorter than the dilations 64 and
# 128, so that whole taps read the zero fill of the bf16 kernels' TMA loads;
# S = 608 (S % 64 == 32), whose last 64-wide mel stage reads zeros past S.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rel_tol', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('B,T,L,S', [(2, 512, 4, 640), (2, 1000, 4, 640), (1, 37, 8, 640),
                                     (3, 1000, 4, 608)])
def test_kernel_matches_plain(cuda_device, dtype, rel_tol, B, T, L, S):
    C = 256
    x, spect, w = _inputs(C, L, S, T, B, seed = 3)
    args = _port(x, spect, w, dtype = dtype, device = cuda_device)
    before = fused_wn_block.launches
    out = fused_wn_block(* args)
    torch.cuda.synchronize()
    assert fused_wn_block.launches == before + 1
    ref = wn_block_plain(* args)
    assert out.dtype == dtype and out.shape == (B, T, C)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= rel_tol * float(ref.float().abs().max()), err


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes(cuda_device):
    """Outside the envelope (C % 128), and a spect whose base address is not
    16-byte aligned, which a TMA tensor map cannot describe."""
    x, spect, w = _inputs(64, 2, 64, 64, 1)
    with pytest.raises(ValueError):
        fused_wn_block(* _port(x, spect, w, device = cuda_device))
    x, spect, w = _inputs(128, 2, 64, 64, 1)
    args = list(_port(x, spect, w, dtype = torch.bfloat16, device = cuda_device))
    shifted = torch.empty(args[1].numel() + 1, dtype = torch.bfloat16, device = cuda_device)
    args[1] = shifted[1:].view(args[1].shape).copy_(args[1])
    with pytest.raises(ValueError, match = 'aligned'):
        fused_wn_block(* args)


def _waveglow(device, ** change):
    """A tiny task WaveGlow on `device` (no JAX needed), C=128, S=160."""
    from text_to_speech_tpu_torch.init import init_waveglow
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
    config = dict(n_mel_channels = 20, n_flows = 4, n_group = 8, n_early_every = 2,
                  n_early_size = 2, wn_layers = 3, wn_channels = 128,
                  upsample_width = 64, upsample_stride = 16)
    config.update(change)
    arch = WaveGlow(** config)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 4)
    return WaveGlowTask.from_jax(params, device = device, ** config)


@pytest.mark.cuda
def test_waveglow_launches_the_kernel_at_a_ragged_length(cuda_device):
    """A 100-frame mel with no padding: 200 grouped rows, no multiple of any
    tile.  Every flow launches the kernel; the waveform stays within the
    bf16 buffers' error of the float32 chain (the tolerance of the e2e
    check in chip_smoke.py)."""
    task = _waveglow(cuda_device)
    mel = np.random.default_rng(5).standard_normal((1, 100, 20)).astype(np.float32)
    before = fused_wn_block.launches
    with torch.no_grad():
        audio = task.compiled_infer(mel, padding_multiple = None, deterministic = True)
        torch.cuda.synchronize()
        assert fused_wn_block.launches == before + 4
        plain = task.arch.infer(task.params, torch.from_numpy(mel).to(cuda_device),
                                deterministic = True, use_kernel = False)
    assert fused_wn_block.launches == before + 4
    assert audio.shape == plain.shape == (1, 100 * 16)
    err = float((audio - plain).abs().max())
    assert err <= 1e-2 * float(plain.abs().max()), err


@pytest.mark.cuda
def test_waveglow_kernel_rejects_unsupported_shapes(cuda_device):
    """C=64 is outside the kernel's envelope: a CUDA model raises rather
    than running the per-layer chain."""
    task = _waveglow(cuda_device, wn_channels = 64)
    before = fused_wn_block.launches
    with pytest.raises(ValueError):
        task.compiled_infer(np.zeros((1, 16, 20), np.float32), deterministic = True)
    assert fused_wn_block.launches == before
