"""Port `WaveGlow` (architecture) against the JAX package's.

A tiny WaveGlow (4 flows, early outputs every 2, 3 WN layers, C=128) with
random weights from `init.init_waveglow`, whose `end` convs are non-zero so
that every WN block reaches the waveform.  Both packages get the same
parameters, mel and noise `z`.  Tolerance for the float32 paths: 1e-4
absolute on a waveform of order 1 (float32 on both sides; 4 flows of
summation-order differences and 8x8 inverses).  The fused branch runs
bf16 buffers by contract, so it is held to 5e-2 of the waveform's scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.weights import waveglow_from_jax

CONFIG = dict(n_mel_channels = 20, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 3, wn_channels = 128,
              upsample_width = 64, upsample_stride = 16)
ATOL = 1e-4


@pytest.fixture(scope = 'module')
def models():
    port = WaveGlow(** CONFIG)
    params = init_waveglow(port.hp, port.flow_channels, seed = 0)
    return JaxWaveGlow(** CONFIG), port, params


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _mel(frames, batch = 2, seed = 1):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, CONFIG['n_mel_channels'])).astype(np.float32)


@pytest.mark.parametrize('fuse_cond', [False, True])
def test_infer_matches_jax(models, fuse_cond):
    jax_arch, port, params = models
    if fuse_cond:    # one wide `cond_layer` per block (the JAX `fuse_params`)
        params = _numpy(jax_arch.fuse_params(_jax(params)))
    mel = _mel(12)
    lg = 12 * CONFIG['upsample_stride'] // CONFIG['n_group']
    z = np.random.default_rng(2).standard_normal((2, lg, CONFIG['n_group'])).astype(np.float32)
    ref = jax_arch.infer(_jax(params), jnp.asarray(mel), z = jnp.asarray(z), use_pallas = False)
    with torch.no_grad():
        out = port.infer(waveglow_from_jax(params), torch.from_numpy(mel),
                         z = torch.from_numpy(z))
    assert out.shape == (2, 12 * CONFIG['upsample_stride'])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)
    # every block reaches the waveform: the output is not the flows of z alone
    assert float(np.abs(np.asarray(ref)).max()) > 0.


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_deterministic_infer_matches_jax(models):
    jax_arch, port, params = models
    mel = _mel(7, batch = 1, seed = 3)
    ref = jax_arch.infer(_jax(params), jnp.asarray(mel), deterministic = True,
                         use_pallas = False)
    with torch.no_grad():
        out = port.infer(waveglow_from_jax(params), torch.from_numpy(mel), deterministic = True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)
    assert float(np.abs(np.asarray(ref)).max()) > 1e-3


def test_pack_block_matches_jax(models):
    jax_arch, port, params = models
    ref = jax_arch._pack_block(_jax(params['flow_1']['block']))
    packed = port._pack_block(waveglow_from_jax(params)['flow_1']['block'])
    C, L = CONFIG['wn_channels'], CONFIG['wn_layers']
    w_in_cond = np.concatenate([np.asarray(ref['w_in']).reshape(L, 3 * C, 2 * C),
                                np.asarray(ref['w_cond'])], axis = 1)
    np.testing.assert_array_equal(packed['w_in_cond'].numpy(), w_in_cond)
    np.testing.assert_allclose(packed['b_in_cond'].numpy(),
                               np.asarray(ref['b_in']) + np.asarray(ref['b_cond']), atol = 1e-7)
    for k in ('w_rs', 'b_rs', 'w_rs_last', 'b_rs_last'):
        np.testing.assert_array_equal(packed[k].numpy(), np.asarray(ref[k]))


def test_fused_branch_keeps_the_dtype_contract(models):
    """With `use_kernel`, CPU tensors take the fused branch through the
    kernel's plain version, on the weights packed as the task model packs
    them (bf16 buffers, f32 biases): an f32 waveform back, close to the JAX
    float32 chain."""
    jax_arch, port, params = models
    mel = _mel(256, batch = 1, seed = 4)
    lg = 256 * CONFIG['upsample_stride'] // CONFIG['n_group']
    z = np.random.default_rng(5).standard_normal((1, lg, CONFIG['n_group'])).astype(np.float32)
    ref = np.asarray(jax_arch.infer(_jax(params), jnp.asarray(mel), z = jnp.asarray(z),
                                    use_pallas = False))
    packed = port.pack_kernel_params(waveglow_from_jax(params))
    assert packed['flow_0']['block']['packed']['w_in_cond'].dtype == torch.bfloat16
    with torch.no_grad():
        out = port.infer(packed, torch.from_numpy(mel), z = torch.from_numpy(z),
                         use_kernel = True)
    assert out.dtype == torch.float32
    assert float(np.abs(out.numpy() - ref).max()) < 5e-2 * float(np.abs(ref).max())


def test_use_kernel_takes_the_fused_branch_at_any_length(models, monkeypatch):
    """`use_kernel` sends every flow to the kernel's wrapper whatever the
    length (here 14 grouped rows, no multiple of any tile): on CUDA tensors
    that launches the kernel, which handles ragged lengths itself."""
    from text_to_speech_tpu_torch.models import waveglow_arch
    jax_arch, port, params = models
    calls = []
    wrapped = waveglow_arch.fused_wn_block
    monkeypatch.setattr(waveglow_arch, 'fused_wn_block',
                        lambda * a: calls.append(a[0].shape) or wrapped(* a))
    mel = _mel(7, batch = 1, seed = 10)
    ref = np.asarray(jax_arch.infer(_jax(params), jnp.asarray(mel), deterministic = True,
                                    use_pallas = False))
    with torch.no_grad():
        out = port.infer(waveglow_from_jax(params), torch.from_numpy(mel),
                         deterministic = True, use_kernel = True)
    assert calls == [(1, 14, CONFIG['wn_channels'])] * CONFIG['n_flows']
    assert float(np.abs(out.numpy() - ref).max()) < 5e-2 * float(np.abs(ref).max())


@pytest.mark.parametrize('change', [dict(wn_layers = 1), dict(wn_kernel_size = 5)])
def test_kernel_packing_rejects_blocks_outside_its_envelope(change):
    """A block the whole-block kernel cannot run raises at packing time,
    rather than falling back to the per-layer chain.  `infer(use_kernel)`
    raises with it for 5 taps; a block of one layer runs the layer kernel
    instead, as the JAX package does (`test_one_layer_blocks_run_the_layer_kernel`)."""
    config = dict(CONFIG, ** change)
    port = WaveGlow(** config)
    params = waveglow_from_jax(init_waveglow(port.hp, port.flow_channels, seed = 11))
    with pytest.raises(ValueError):
        port.pack_kernel_params(params)
    mel = torch.from_numpy(_mel(4, batch = 1))
    if config['wn_layers'] == 1:
        with torch.no_grad():
            out = port.infer(params, mel, deterministic = True, use_kernel = True)
        assert bool(torch.isfinite(out).all())
    else:
        with pytest.raises(ValueError):
            port.infer(params, mel, deterministic = True, use_kernel = True)


def test_one_layer_blocks_run_the_layer_kernel(monkeypatch):
    """With one WN layer a block, `infer(use_kernel=True)` runs each block
    as the per-layer chain on `ops.wn_layer` (its plain version on the CPU),
    as the JAX package's `infer(use_pallas=True)` does, and matches the JAX
    float32 chain (`use_pallas=False`) within the float32 tolerance."""
    from text_to_speech_tpu_torch.models import waveglow_arch
    config = dict(CONFIG, wn_layers = 1)
    port, jax_arch = WaveGlow(** config), JaxWaveGlow(** config)
    params = init_waveglow(port.hp, port.flow_channels, seed = 12)
    calls = []
    layer = waveglow_arch.fused_wn_layer
    monkeypatch.setattr(waveglow_arch, 'fused_wn_layer',
                        lambda * a, ** kw: calls.append(kw) or layer(* a, ** kw))
    mel = _mel(9, batch = 2, seed = 13)
    ref = np.asarray(jax_arch.infer(_jax(params), jnp.asarray(mel), deterministic = True,
                                    use_pallas = False))
    with torch.no_grad():
        out = port.infer(waveglow_from_jax(params), torch.from_numpy(mel),
                         deterministic = True, use_kernel = True)
    assert calls == [{'dilation': 1, 'residual': False}] * CONFIG['n_flows']
    np.testing.assert_allclose(out.numpy(), ref, atol = ATOL, rtol = 0)
    assert float(np.abs(ref).max()) > 1e-3


def test_waveglow_to_jax_round_trip(models):
    """`weights.waveglow_to_jax` inverts `waveglow_from_jax` exactly, and
    gives back the JAX tree it came from."""
    from text_to_speech_tpu_torch.weights import flatten_tree, waveglow_to_jax
    _, _, params = models
    port_params = waveglow_from_jax(params)
    back = waveglow_to_jax(port_params)
    flat, ref = flatten_tree(back), flatten_tree(params)
    assert sorted(flat) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(flat[name], value, err_msg = name)
    again = flatten_tree(waveglow_from_jax(back))
    for name, value in flatten_tree(port_params).items():
        assert torch.equal(again[name], value), name


@pytest.mark.parametrize('width,stride', [(64, 16), (24, 16)])
def test_upsample_mel_matches_jax(width, stride):
    """(64, 16) takes the im2col fast path; (24, 16), with the width not a
    multiple of the stride, the conv-transpose fallback."""
    config = dict(CONFIG, upsample_width = width, upsample_stride = stride, n_flows = 1)
    port, jax_arch = WaveGlow(** config), JaxWaveGlow(** config)
    params = init_waveglow(port.hp, port.flow_channels, seed = 6)
    params['upsample']['bias'] = np.random.default_rng(7).standard_normal(
        CONFIG['n_mel_channels']).astype(np.float32)
    mel = _mel(9, seed = 8)
    ref = jax_arch.upsample_mel(_jax(params), jnp.asarray(mel))
    out = port.upsample_mel(waveglow_from_jax(params), torch.from_numpy(mel))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)


def test_task_pads_to_the_bucket_and_trims(models):
    """The task model pads the mel with `pad_mel_value` to a multiple of 256
    frames (the JAX `compiled_infer` bucket), vocodes, and trims."""
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    jax_arch, port, params = models
    task = WaveGlowTask.from_jax(params, device = 'cpu', ** CONFIG)
    assert task.upsample_rate == CONFIG['upsample_stride']
    mel = _mel(20, batch = 1, seed = 9)[0]
    audio = task.infer(mel, deterministic = True)
    padded = np.concatenate([mel, np.full((236, CONFIG['n_mel_channels']), -11., np.float32)])
    ref = jax_arch.infer(_jax(params), jnp.asarray(padded[None]), deterministic = True,
                         use_pallas = False)
    assert audio.shape == (1, 20 * CONFIG['upsample_stride'])
    np.testing.assert_allclose(audio, np.asarray(ref)[:, :audio.shape[1]], atol = ATOL, rtol = 0)
    # int8 serving is recorded, and off a card the float32 chain still serves
    task.quantize_for_serving()
    assert task.serving_mode == 'int8' and task._serving_mode_flags() == (False, False)
    np.testing.assert_array_equal(task.infer(mel, deterministic = True), audio)
