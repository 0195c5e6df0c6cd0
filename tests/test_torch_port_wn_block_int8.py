"""int8 serving: the WN block with int8 products, the int8 route of
`WaveGlow.infer`, and the quality gate of `quantize_for_serving`, against
the JAX package.

Inputs and weights are drawn with numpy from seeds and handed to both
packages.  Tolerances:

  - `quantize_wn_weights` and `quantize_kernel_params`: bit-identical.
  - `wn_block_int8_plain` (float32 buffers) against `wn_block_int8_reference`
    (C=128, S=128, L=3, T=512): equal to the bit when both take XLA's tanh
    and sigmoid.  With PyTorch's own, which differ from XLA's in the last
    place for over half of all inputs, a gate value can cross a rounding
    tie of its row's int8 grid: measured max 2.5e-3 and mean 4.0e-6 on
    outputs of scale 0.81 (1.1e-3 / 3.4e-7 with the static gate scale),
    held to the JAX package's own bound for its kernel against that
    reference, max 1e-2 and mean 1e-5 (``tests/test_pallas.py``).
  - The TPU kernel's bf16-buffer contract (the stored stream rounded to
    bf16, the next layer quantized from the float32 sum): the plain version
    in bf16 against the JAX kernel in Pallas interpret mode at C=128, L=2,
    T=64, one tile, with XLA's tanh and sigmoid and the kernel's ``* (1 /
    127.)`` in place of the division by 127: all but 5 of 8192 outputs equal
    to the bit, those within one bf16 unit (XLA's fused program).
  - The port's int8 route (`use_kernel` on `quantize_kernel_params`, CPU
    tensors through the plain version) against the JAX float32 chain: SNR
    at least 25 dB, the JAX package's serving gate.

The `cuda` cases hold the kernel against its plain version and drive the
task model's int8 route; they skip without a card.  JAX is imported inside
the CPU tests only:

    python -m pytest tests/test_torch_port_wn_block_int8.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.ops.wn_block_int8 import (
    fused_wn_block_int8, pack_wn_int8, quantize_wn_weights, wn_block_int8_plain)
from text_to_speech_tpu_torch.weights import waveglow_from_jax

# S = n_mel * n_group = 128: inside the kernel's envelope (S % 64 == 0)
CONFIG = dict(n_mel_channels = 16, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 3, wn_channels = 128,
              upsample_width = 64, upsample_stride = 16)
TIE_MAX, TIE_MEAN = 1e-2, 1e-5


def _packed(C, S, L, seed = 0):
    """One block's float32 weights in the JAX stacked layout."""
    rng = np.random.default_rng(seed)
    f = lambda * shape: (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return dict(w_cond = f(L, S, 2 * C), b_cond = f(L, 2 * C), w_in = f(L, 3, C, 2 * C),
                b_in = f(L, 2 * C), w_rs = f(L - 1, C, 2 * C), b_rs = f(L - 1, 2 * C),
                w_rs_last = f(C, C), b_rs_last = f(C))


def _activations(B, T, C, S, seed = 1):
    rng = np.random.default_rng(seed)
    return ((0.3 * rng.standard_normal((B, T, C))).astype(np.float32),
            (0.3 * rng.standard_normal((B, T, S))).astype(np.float32))


def _kernel_weights(packed, device = 'cpu'):
    q = pack_wn_int8(quantize_wn_weights({k: torch.from_numpy(v) for k, v in packed.items()}))
    return {k: v.to(device) for k, v in q.items()}


def _jax(tree):
    import jax.numpy as jnp
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _snr_db(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - out) ** 2), 1e-20))


@pytest.fixture(scope = 'module')
def models():
    port = WaveGlow(** CONFIG)
    params = init_waveglow(port.hp, port.flow_channels, seed = 0)
    return port, params


def _mel(frames, batch = 1, seed = 2):
    return (np.random.default_rng(seed).standard_normal(
        (batch, frames, CONFIG['n_mel_channels'])) - 5.).astype(np.float32)


# -- weights ----------------------------------------------------------------------

def test_quantize_wn_weights_is_bit_identical():
    from text_to_speech_tpu.ops.pallas_kernels import quantize_wn_weights as jax_quantize
    packed = _packed(128, 64, 3)
    ref = jax_quantize(packed)
    out = quantize_wn_weights({k: torch.from_numpy(v) for k, v in packed.items()})
    assert set(out) == set(ref)
    for key, value in ref.items():
        assert out[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(out[key].numpy(), value, err_msg = key)


def test_quantize_kernel_params_matches_jax(models):
    from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
    port, params = models
    jax_arch = JaxWaveGlow(** CONFIG)
    ref = jax_arch.quantize_pallas_params(jax_arch.pack_pallas_params(_jax(params)))
    out = port.quantize_kernel_params(waveglow_from_jax(params))
    for k in range(CONFIG['n_flows']):
        block = out['flow_{}'.format(k)]['block']
        expected = pack_wn_int8({key: torch.from_numpy(np.array(v)) for key, v in
                                 ref['flow_{}'.format(k)]['block']['packed_q'].items()})
        for key, value in expected.items():
            assert block['packed_q'][key].dtype == value.dtype, key
            assert torch.equal(block['packed_q'][key], value), key


# -- the plain version against the JAX package ----------------------------------------

@pytest.mark.parametrize('static_gate_scale', [False, True])
@pytest.mark.parametrize('transcendentals', ['xla', 'torch'])
def test_plain_matches_reference(static_gate_scale, transcendentals, monkeypatch):
    import jax
    import jax.numpy as jnp
    from text_to_speech_tpu.ops.pallas_kernels import (
        quantize_wn_weights as jax_quantize, wn_block_int8_reference)
    C, S, L, T, B = 128, 128, 3, 512, 2
    packed = _packed(C, S, L)
    x, spect = _activations(B, T, C, S)
    ref = np.asarray(wn_block_int8_reference(
        jnp.asarray(x), jnp.asarray(spect), _jax(jax_quantize(packed)),
        static_gate_scale = static_gate_scale))
    if transcendentals == 'xla':
        # the only operations whose bits differ between the two libraries
        as_xla = lambda fn: lambda t: torch.from_numpy(np.array(fn(t.numpy())))
        monkeypatch.setattr(torch, 'tanh', as_xla(jnp.tanh))
        monkeypatch.setattr(torch, 'sigmoid', as_xla(jax.nn.sigmoid))
    out = fused_wn_block_int8(torch.from_numpy(x), torch.from_numpy(spect),
                              _kernel_weights(packed), static_gate_scale).numpy()
    assert out.dtype == np.float32 and out.shape == (B, T, C)
    err = np.abs(out - ref)
    if transcendentals == 'xla':
        np.testing.assert_array_equal(out, ref)
    else:
        assert float(err.max()) < TIE_MAX and float(err.mean()) < TIE_MEAN, \
            (err.max(), err.mean())
    assert fused_wn_block_int8.launches == 0


def test_plain_keeps_the_bf16_buffer_contract_of_the_tpu_kernel(monkeypatch):
    """The stored stream rounds to bf16 while the next layer quantizes the
    float32 sum: the plain version in bf16 against the JAX kernel run in
    interpret mode with bf16 buffers (one tile, no halo), once both take
    XLA's tanh and sigmoid and the kernel's row scale ``max(amax, 1e-8) *
    (1 / 127.)`` (its reference, and the port, divide).  XLA compiles the
    interpret-mode kernel as one fused program whose float32 results can
    differ in the last place, which now and then moves a bf16 rounding:
    measured 5 of 8192 outputs, each by one bf16 unit (2^-8 relative); all
    others equal to the bit."""
    import jax
    import jax.numpy as jnp
    from text_to_speech_tpu.ops.pallas_kernels import (
        fused_wn_block_int8 as jax_kernel, quantize_wn_weights as jax_quantize,
        wn_block_pad_int8)
    from text_to_speech_tpu_torch.ops import wn_block_int8
    C, S, L, T, B = 128, 128, 2, 64, 1
    packed = _packed(C, S, L, seed = 3)
    x, spect = _activations(B, T, C, S, seed = 4)
    pad = wn_block_pad_int8(L)
    padded = lambda a: jnp.pad(jnp.asarray(a, jnp.bfloat16), ((0, 0), (pad, pad), (0, 0)))
    ref = np.asarray(jax_kernel(padded(x), padded(spect), _jax(jax_quantize(packed)),
                                tile = T, seq_len = T, interpret = True).astype(jnp.float32))
    q = _kernel_weights(packed)
    as_xla = lambda fn: lambda t: torch.from_numpy(np.array(fn(t.numpy())))
    monkeypatch.setattr(torch, 'tanh', as_xla(jnp.tanh))
    monkeypatch.setattr(torch, 'sigmoid', as_xla(jax.nn.sigmoid))
    monkeypatch.setattr(wn_block_int8, '_over_127', lambda t: t * (1. / 127.))
    out = wn_block_int8_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(spect).bfloat16(), q)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert float(np.mean(out != ref)) < 1e-2
    np.testing.assert_allclose(out, ref, rtol = 2 ** -7, atol = 0)


# -- the int8 route of WaveGlow.infer -----------------------------------------------------

def test_int8_route_is_within_the_serving_gate_of_the_f32_chain(models):
    import jax.numpy as jnp
    from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
    port, params = models
    mel = _mel(32, batch = 2)
    lg = 32 * CONFIG['upsample_stride'] // CONFIG['n_group']
    z = np.random.default_rng(3).standard_normal((2, lg, CONFIG['n_group'])).astype(np.float32)
    ref = np.asarray(JaxWaveGlow(** CONFIG).infer(
        _jax(params), jnp.asarray(mel), z = jnp.asarray(z), use_pallas = False))
    quantized = port.quantize_kernel_params(waveglow_from_jax(params))
    with torch.no_grad():
        out = port.infer(quantized, torch.from_numpy(mel), z = torch.from_numpy(z),
                         use_kernel = True)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _snr_db(ref, out.numpy()) >= 25.


def test_int8_route_keeps_the_mixed_precision_contract(models, monkeypatch):
    """A float32 caller's blocks get bf16 kernel operands and f32 results;
    under ``dtype=torch.bfloat16`` the int8 weights, their scales and the
    1×1 convs are not cast, and the audio stream stays float32.  The bf16
    kernel route keeps its own contract: everything cast, bf16 out."""
    from text_to_speech_tpu_torch.models import waveglow_arch
    port, params = models
    quantized = port.quantize_kernel_params(waveglow_from_jax(params))
    block = quantized['flow_0']['block']
    n_half = block['start']['weight'].shape[1]
    calls = []
    kernel = waveglow_arch.fused_wn_block_int8
    monkeypatch.setattr(waveglow_arch, 'fused_wn_block_int8',
                        lambda x, spect, q: calls.append((x.dtype, spect.dtype)) or
                        kernel(x, spect, q))
    audio_half = torch.zeros((1, 64, n_half))
    spect = torch.zeros((1, 64, 128))
    out = port.wn_block(block, audio_half, spect, fused = True)
    assert calls == [(torch.bfloat16, torch.bfloat16)] and out.dtype == torch.float32

    casts = []
    cast_tree = waveglow_arch.cast_tree
    monkeypatch.setattr(waveglow_arch, 'cast_tree',
                        lambda * a, ** kw: casts.append(cast_tree(* a, ** kw)) or casts[-1])
    mel = torch.from_numpy(_mel(8))
    with torch.no_grad():
        audio = port.infer(quantized, mel, deterministic = True, dtype = torch.bfloat16,
                           use_kernel = True)
        mixed = port.infer(port.pack_kernel_params(waveglow_from_jax(params)), mel,
                           deterministic = True, dtype = torch.bfloat16, use_kernel = True)
    cast = casts[0]['flow_0']
    assert audio.dtype == torch.float32
    assert cast['convinv']['weight'].dtype == torch.float32
    assert cast['block']['start']['weight'].dtype == torch.bfloat16
    for key, value in block['packed_q'].items():
        assert cast['block']['packed_q'][key].dtype == value.dtype, key
    assert mixed.dtype == torch.bfloat16
    assert casts[1]['flow_0']['convinv']['weight'].dtype == torch.bfloat16


# -- the quality gate -----------------------------------------------------------------------

@pytest.fixture
def task(models):
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    _, params = models
    return WaveGlowTask.from_jax(params, device = 'cpu', ** CONFIG)


def _on_a_card(task, monkeypatch, snr):
    """The model as if on a card, with the gate's measurement replaced."""
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    monkeypatch.setattr(task, 'device', torch.device('cuda'))
    if callable(snr):
        monkeypatch.setattr(WaveGlowTask, 'serving_snr', snr)
    else:
        monkeypatch.setattr(WaveGlowTask, 'serving_snr', lambda self, mel: snr)


def test_gate_policy(task, monkeypatch):
    """A passing gate keeps int8; a failing one serves on the float32 chain,
    never on the bf16 kernel; ``enable=False`` restores the default; the
    JAX package's policy (``tests/test_models.py``)."""
    mel = _mel(8)[0]
    _on_a_card(task, monkeypatch, 40.)
    task.quantize_for_serving(validate = mel)
    assert task.serving_mode == 'int8' and task._last_serving_snr_db == 40.
    assert task._serving_mode_flags() == (True, True)
    assert task.device_vocoder_fn()[2][-2:] == (True, True)

    _on_a_card(task, monkeypatch, 5.)
    task.quantize_for_serving(validate = mel)
    assert task.serving_mode == 'float32_xla' and task._last_serving_snr_db == 5.
    assert task._serving_mode_flags() == (False, False)
    fn, params, tag = task.device_vocoder_fn(deterministic = True)
    assert params is task.params and tag[-2:] == (False, False)

    # the float32 chain serves (vocoded here on the CPU): the waveform of a
    # model that never asked for int8
    monkeypatch.setattr(task, 'device', torch.device('cpu'))
    served = task.infer(_mel(12, seed = 5), deterministic = True)
    task.quantize_for_serving(False)
    assert task.serving_mode == 'default'
    np.testing.assert_array_equal(served, task.infer(_mel(12, seed = 5), deterministic = True))
    monkeypatch.setattr(task, 'device', torch.device('cuda'))
    assert task._serving_mode_flags() == (True, False)


def test_gate_off_the_card_and_errors_inside_it(task, monkeypatch):
    """On the CPU `serving_snr` raises, and `quantize_for_serving` records
    the mode without measuring, the vocoder staying on the float32 chain
    (the JAX package off its TPU).  On a card an error raised inside the
    gate's run propagates: a kernel failure is never taken for a failed
    gate."""
    mel = _mel(8)[0]
    with pytest.raises(RuntimeError, match = 'CUDA'):
        task.serving_snr(mel)
    before = task.infer(mel, deterministic = True)
    task.quantize_for_serving(validate = mel)
    assert task.serving_mode == 'int8' and not hasattr(task, '_last_serving_snr_db')
    assert task._serving_mode_flags() == (False, False)
    np.testing.assert_array_equal(task.infer(mel, deterministic = True), before)

    def fails(self, mel):
        raise RuntimeError('wn_block_int8 kernel launch failed: CUDA error 700')
    _on_a_card(task, monkeypatch, fails)
    with pytest.raises(RuntimeError, match = 'launch failed'):
        task.quantize_for_serving(validate = mel)


# -- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# The integer sums are exact, the scales apply in the same order, the gate
# takes PyTorch's device functions and the row maxima are maxima, so the
# kernel equals its plain version to the bit.  Shapes: whole tiles; a tile
# that crosses the end of each batch row (T = 1000, and B = 3); T = 37 at
# L = 8, shorter than the dilations 64 and 128, so that whole taps read the
# TMA zero fill; and rows whose scales differ by orders of magnitude, so
# that each row's gate maximum, gathered by atomics from the column tiles of
# the first GEMM, decides its quantization in the second.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype,static_gate_scale', [
    (torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)])
@pytest.mark.parametrize('B,T,L,spread', [(2, 512, 4, False), (2, 1000, 4, False),
                                          (1, 37, 8, False), (3, 1000, 4, True)])
def test_kernel_matches_plain(cuda_device, dtype, static_gate_scale, B, T, L, spread):
    C, S = 256, 640
    x, spect = _activations(B, T, C, S, seed = 6)
    if spread:
        rows = 10. ** np.random.default_rng(9).uniform(-3., .5, (B, T, 1))
        x, spect = (x * rows).astype(np.float32), (spect * rows).astype(np.float32)
    q = _kernel_weights(_packed(C, S, L, seed = 7), cuda_device)
    x = torch.from_numpy(x).to(cuda_device, dtype)
    spect = torch.from_numpy(spect).to(cuda_device, dtype)
    before = fused_wn_block_int8.launches
    out = fused_wn_block_int8(x, spect, q, static_gate_scale)
    torch.cuda.synchronize()
    assert fused_wn_block_int8.launches == before + 1
    ref = wn_block_int8_plain(x, spect, q, static_gate_scale)
    assert out.dtype == dtype and out.shape == (B, T, C)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes(cuda_device):
    """Outside the envelope (S % 64, C > 512), and a spect whose base
    address is not 16-byte aligned, which a TMA tensor map cannot describe."""
    q = _kernel_weights(_packed(128, 96, 2), cuda_device)        # S % 64 != 0
    x = torch.zeros((1, 64, 128), device = cuda_device)
    with pytest.raises(ValueError):
        fused_wn_block_int8(x, torch.zeros((1, 64, 96), device = cuda_device), q)
    q = _kernel_weights(_packed(640, 64, 2), cuda_device)        # C > 512
    with pytest.raises(ValueError, match = 'C <= 512'):
        fused_wn_block_int8(torch.zeros((1, 64, 640), device = cuda_device),
                            torch.zeros((1, 64, 64), device = cuda_device), q)
    q = _kernel_weights(_packed(128, 64, 2), cuda_device)
    spect = torch.empty(64 * 64 + 1, device = cuda_device)[1:].view(1, 64, 64).zero_()
    with pytest.raises(ValueError, match = 'aligned'):
        fused_wn_block_int8(x, spect, q)


@pytest.mark.cuda
def test_task_serves_int8_on_the_card(cuda_device, models):
    """`quantize_for_serving` gates on the card, then every flow of a vocoder
    call launches the int8 kernel and none the bf16 one, at a ragged length."""
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    _, params = models
    task = WaveGlowTask.from_jax(params, device = cuda_device, ** CONFIG)
    task.quantize_for_serving(validate = _mel(16)[0])
    assert task.serving_mode == 'int8' and task._last_serving_snr_db >= 25.
    before, before_bf16 = fused_wn_block_int8.launches, fused_wn_block.launches
    audio = task.infer(_mel(100, seed = 8), padding_multiple = None, deterministic = True)
    assert fused_wn_block_int8.launches == before + CONFIG['n_flows']
    assert fused_wn_block.launches == before_bf16
    assert audio.shape == (1, 100 * CONFIG['upsample_stride']) and np.isfinite(audio).all()
