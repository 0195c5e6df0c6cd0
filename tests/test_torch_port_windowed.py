"""Windowed vocoding: the port's `WaveGlow.infer(win_len=...)`,
`vocode_windowed_batch` and `vocode_windowed_from_device`, and the
Tacotron-2 task layer with a `win_len`, against the JAX package.

One tiny random WaveGlow (4 flows, 2 layers, 64 channels) on both sides,
deterministic (no noise), on the float32 chain; Tacotron-2 ``overfit_demo``
read from a copy in ``tmp_path``.  Window starts and stitching are exact;
waveforms agree within 1e-4 absolute in float32, and within one step of
the int16 grid where the windows cross to the host as 16-bit PCM."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from text_to_speech_tpu.models import get_pretrained, saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow
from text_to_speech_tpu.models.tts import waveglow as jax_waveglow
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
from text_to_speech_tpu_torch.models.tts import waveglow as port_waveglow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch

VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
ATOL = 1e-4
WINDOW = dict(win_len = 16, hop_len = -4, deterministic = True)


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    """(JAX vocoder, port vocoder, JAX Tacotron-2, port Tacotron-2)."""
    root = str(tmp_path_factory.mktemp('models'))
    shutil.copytree('pretrained_models/overfit_demo', root + '/overfit_demo')
    arch = WaveGlowArch(** VOCODER)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    to_jax = lambda t: {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                        for k, v in t.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        jax_vocoder = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        jax_vocoder.set_weights(to_jax(params))
        yield (jax_vocoder, WaveGlow.from_jax(params, device = 'cpu', ** VOCODER),
               get_pretrained('overfit_demo'),
               Tacotron2.from_pretrained('overfit_demo', root = root, device = 'cpu'))
        reset_instances()


def _mel(frames, seed = 0):
    return np.random.default_rng(seed).standard_normal((frames, 80)).astype(np.float32) - 5.


def _on_grid(out, ref):
    """Both on the int16 grid, at most one step apart."""
    grid, ref_grid = out * 32767., ref * 32767.
    np.testing.assert_allclose(grid, np.round(grid), atol = 2e-3, rtol = 0)
    assert np.abs(np.round(grid) - np.round(ref_grid)).max() <= 1


# -- the windowing math --------------------------------------------------------------

def _hop(win_len, hop_len):
    """`hop_len` resolved as every windowed entry point resolves it."""
    if isinstance(hop_len, float): hop_len = int(win_len * hop_len)
    return win_len + hop_len if hop_len < 0 else hop_len


@pytest.mark.parametrize('length, win_len, hop_len', [
    (40, 16, -4), (40, 16, 0.75), (16, 16, -4), (17, 16, -4), (2048, 256, -64),
    (257, 64, 0.5), (1000, 128, -32), (256, 128, 128)])
def test_steps_and_stitching_match_jax(length, win_len, hop_len):
    hop = _hop(win_len, hop_len)
    starts = port_waveglow._get_steps(length, win_len, hop)
    ref = jax_waveglow._get_steps(length, win_len, hop)
    np.testing.assert_array_equal(starts, ref)
    assert starts.dtype == ref.dtype and starts[-1] + win_len <= max(length, win_len)
    # two inputs: this one and one shorter than a window; rate 4 keeps it small
    rate, rng = 4, np.random.default_rng(length)
    jobs = [(0, int(s), min(win_len, length - int(s))) for s in starts] + [(1, 0, 5)]
    parts = [rng.standard_normal(win_len * rate).astype(np.float32) for _ in jobs]
    out = port_waveglow._stitch_windows(jobs, parts, [length, 5], win_len, rate)
    expected = jax_waveglow._stitch_windows(jobs, parts, [length, 5], win_len, rate)
    assert len(out) == 2
    for o, r in zip(out, expected):
        np.testing.assert_array_equal(o, r)
    assert out[0].shape == (length * rate,) and out[1].shape == (5 * rate,)


@pytest.mark.parametrize('win_len, n_windows', [(16, 3), (16, 200), (128, 24), (256, 9),
                                                (1024, 100)])
def test_auto_vocoder_batch_matches_jax(models, win_len, n_windows):
    jax_vocoder, vocoder = models[:2]
    assert vocoder._auto_vocoder_batch(win_len, n_windows, None) \
        == jax_vocoder._auto_vocoder_batch(win_len, n_windows, None)
    assert vocoder._auto_vocoder_batch(win_len, n_windows, 5) == 5


# -- the vocoder ----------------------------------------------------------------------

@pytest.mark.parametrize('batch', [False, True])
def test_infer_windowed_matches_jax(models, batch):
    jax_vocoder, vocoder = models[:2]
    mel = _mel(40)
    out = vocoder.infer(mel, batch = batch, ** WINDOW)
    ref = np.asarray(jax_vocoder.infer(mel, batch = batch, ** WINDOW))
    assert out.shape == ref.shape == (1, 40 * 256)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol = ATOL, rtol = 0)


def test_windows_without_overlap_keep_every_sample(models):
    """``hop_len == win_len``: a mel of 256 frames in windows of 128 at
    starts 0 and 128, an overlap of 0.  The reference's `WaveGlow.infer`
    ends every piece but the last at ``-(overlap // 2)``
    (``text_to_speech_tpu/models/tts/waveglow.py:319-323``), which is
    ``-0`` here: it drops the first window's 32,768 samples and returns
    32,768 of 65,536.  A defect of the reference that the port does not
    reproduce: it returns all 65,536, each window's audio in its place."""
    jax_vocoder, vocoder = models[:2]
    mel = _mel(256, 3)
    kw = dict(win_len = 128, hop_len = 128, deterministic = True)
    out = vocoder.infer(mel, ** kw)
    assert out.shape == (1, 65536)
    windows = [vocoder.infer(mel[s: s + 128], ** kw) for s in (0, 128)]
    np.testing.assert_array_equal(out, np.concatenate(windows, axis = -1))
    ref = np.asarray(jax_vocoder.infer(mel, ** kw))
    assert ref.shape == (1, 32768)                     # the first window dropped
    np.testing.assert_allclose(ref, windows[1], atol = ATOL, rtol = 0)


@pytest.mark.parametrize('transfer_dtype', ['float32', 'int16'])
def test_vocode_windowed_batch_matches_jax(models, transfer_dtype):
    jax_vocoder, vocoder = models[:2]
    mels = [_mel(40), _mel(23, 1), _mel(12, 2)]
    out = vocoder.vocode_windowed_batch(mels, transfer_dtype = transfer_dtype, ** WINDOW)
    ref = jax_vocoder.vocode_windowed_batch(mels, transfer_dtype = transfer_dtype, ** WINDOW)
    assert [o.shape for o in out] == [np.asarray(r).shape for r in ref] \
        == [(len(m) * 256,) for m in mels]
    for o, r in zip(out, ref):
        if transfer_dtype == 'int16':
            _on_grid(o, np.asarray(r))
        else:
            np.testing.assert_allclose(o, np.asarray(r), atol = ATOL, rtol = 0)


def test_vocode_windowed_from_device_matches_jax(models):
    """Ragged rows cut from one padded buffer: against the JAX package's
    device slicer, and against the port's host slicer on the trimmed mels
    (the same windows in the same batches: equal)."""
    jax_vocoder, vocoder = models[:2]
    lengths = [40, 23, 12]
    mel = np.full((3, 40, 80), 3., np.float32)       # the padding must not leak
    for i, n in enumerate(lengths):
        mel[i, :n] = _mel(n, i)
    out = vocoder.vocode_windowed_from_device(torch.from_numpy(mel), np.asarray(lengths),
                                              ** WINDOW)
    ref = jax_vocoder.vocode_windowed_from_device(jnp.asarray(mel), np.asarray(lengths),
                                                  ** WINDOW)
    host = vocoder.vocode_windowed_batch([mel[i, :n] for i, n in enumerate(lengths)], ** WINDOW)
    assert [o.shape for o in out] == [(n * 256,) for n in lengths]
    for o, r, h in zip(out, ref, host):
        np.testing.assert_allclose(o, np.asarray(r), atol = ATOL, rtol = 0)
        np.testing.assert_array_equal(o, h)
    # a start that the slice would have to clamp raises
    with pytest.raises(ValueError, match = 'run past'):
        vocoder.vocode_windowed_from_device(torch.from_numpy(mel), [60], ** WINDOW)


# -- the task layer -------------------------------------------------------------------

TEXT = 'Dr. Smith has 2 cats. They sleep all day.'
ROUTES = {
    # the chunks decode as one batch; the windows are cut from the device mel
    'pipelined': dict(min_fpt_ratio = -1.),
    # the gate fails: the chunks decode again, every chunk's windows in shared
    # batches (one chunk alone would go through `vocoder(mel, win_len=...)`,
    # which `test_infer_windowed_matches_jax` holds)
    'sequential': dict(min_fpt_ratio = 1e9),
}


@pytest.mark.parametrize('route', list(ROUTES))
def test_tacotron2_windowed_matches_jax(models, route, monkeypatch):
    jax_vocoder, vocoder, jax_model, model = models
    calls = []
    for name in ('vocode_windowed_from_device', 'vocode_windowed_batch'):
        original = getattr(vocoder, name)
        monkeypatch.setattr(vocoder, name, lambda * a, _f = original, _n = name, ** kw:
                            calls.append(_n) or _f(* a, ** kw))
    kw = dict(max_text_length = -2, max_trial = 1, max_length = 2., deterministic = True,
              max_fpt_ratio = float('inf'),
              vocoder_config = {'win_len': 8, 'hop_len': -2, 'deterministic': True},
              ** ROUTES[route])
    out = model.infer(TEXT, vocoder = vocoder, ** kw)
    ref = jax_model.infer(TEXT, vocoder = jax_vocoder, ** kw)
    assert out['splitted'] == ref['splitted'] and len(out['mel']) == len(ref['mel']) == 3
    assert calls == {'pipelined': ['vocode_windowed_from_device'],
                     'sequential': ['vocode_windowed_batch']}[route]
    for m, r in zip(out['mel'], ref['mel']):
        np.testing.assert_allclose(m, np.asarray(r), atol = ATOL, rtol = 0)
    assert out['audio'].shape == np.asarray(ref['audio']).shape \
        == (sum(m.shape[0] for m in out['mel']) * 256,)
    np.testing.assert_allclose(out['audio'], np.asarray(ref['audio']), atol = ATOL, rtol = 0)
