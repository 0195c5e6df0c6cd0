"""The training losses and the dataset's row filter: the port against the
JAX package.

Seeded numpy inputs through both packages' losses: every component of
`TacotronLoss` (mse and mae, weighted and not, masked and not, label
smoothing, finish weights, from logits), `FastSpeech2Loss` (phoneme- and
frame-level variances, missing ones), `GE2ELoss` (with and without the
learned scale and offset, a clamped scale), ``mse`` and ``mae``: within
1e-5 of each one's scale.  The edge cases of the JAX package's
``tests/test_training.py``: components that sum to the loss, a perfect
prediction, the final (gated) frame out of the mel mask, several mel
losses, the registry; well-separated speakers give GE2E a lower loss.
`prepare_dataset`'s `filter_fn` keeps the rows the JAX package keeps.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax.numpy as jnp

from text_to_speech_tpu.train import datasets as jdatasets
from text_to_speech_tpu.train import losses as jlosses

from text_to_speech_tpu_torch.train import datasets, losses


def _close(out, ref, tol = 1e-5, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= tol * scale, what


def _both(name, y_true, y_pred, ** config):
    """The loss `name` with `config` on the same inputs in both packages."""
    to_jax = lambda t: tuple(to_jax(v) for v in t) if isinstance(t, tuple) \
        else None if t is None else jnp.asarray(t)
    to_port = lambda t: tuple(to_port(v) for v in t) if isinstance(t, tuple) \
        else None if t is None else torch.as_tensor(t)
    ref = jlosses.get_loss(name, ** config)(to_jax(y_true), to_jax(y_pred))
    out = losses.get_loss(name, ** config)(to_port(y_true), to_port(y_pred))
    assert sorted(out) == sorted(ref)
    for key in ref:
        _close(out[key], ref[key], what = key)
    return out


def _tacotron_data(B = 2, T = 6, C = 4, logits = False):
    rng = np.random.default_rng(0)
    mel_t = rng.standard_normal((B, T, C)).astype(np.float32)
    gate_t = np.zeros((B, T), np.float32)
    gate_t[:, -1] = 1.
    gate_t[1, 3:] = 1.
    mel_p = rng.standard_normal((B, T, C)).astype(np.float32)
    gate_p = rng.standard_normal((B, T)).astype(np.float32)
    if not logits:
        gate_p = 1. / (1. + np.exp(-gate_p))
    return (mel_t, gate_t), (mel_p, (0.9 * mel_p).astype(np.float32), gate_p)


@pytest.mark.parametrize('config', [
    {}, {'mel_loss': 'mae'}, {'mel_loss': ['mse', 'mae']},
    {'mel_loss': ['weighted_mse', 'weighted_mae']}, {'mask_mel_padding': False},
    {'label_smoothing': 0.1, 'finish_weight': 5., 'not_finish_weight': 0.5},
    {'from_logits': True}], ids = lambda c: '-'.join(
        '{}={}'.format(k, v) for k, v in c.items()) or 'default')
def test_tacotron_loss_matches_jax(config):
    y_true, y_pred = _tacotron_data(logits = config.get('from_logits', False))
    out = _both('TacotronLoss', y_true, y_pred, ** config)
    parts = sum(v for k, v in out.items() if k != 'loss')
    _close(out['loss'], parts, what = 'sum of the components')


def test_tacotron_loss_edge_cases():
    loss = losses.TacotronLoss()
    (mel_t, gate_t), (mel_p, post_p, gate_p) = (tuple(map(torch.from_numpy, t))
                                                for t in _tacotron_data())
    perfect = loss((mel_t, gate_t), (mel_t, mel_t, gate_t))
    assert float(perfect['mse_mel_loss'].max()) < 1e-10
    assert float(perfect['gate_loss'].max()) < 1e-5
    corrupted = mel_p.clone()
    corrupted[:, -1] = 999.
    np.testing.assert_array_equal(loss((mel_t, gate_t), (mel_p, post_p, gate_p))['mse_mel_loss'],
                                  loss((mel_t, gate_t), (corrupted, post_p, gate_p))['mse_mel_loss'])
    assert losses.get_loss('TacotronLoss', mel_loss = ['mse', 'mae']).output_names == [
        'loss', 'mse_mel_loss', 'mae_mel_loss', 'mse_mel_postnet_loss',
        'mae_mel_postnet_loss', 'gate_loss']
    assert isinstance(losses.get_loss({'class_name': 'FastSpeech2Loss'}), losses.FastSpeech2Loss)
    with pytest.raises(ValueError):
        losses.get_loss('NopeLoss')
    assert set(losses.list_losses()) >= {'tacotronloss', 'fastspeech2loss', 'ge2eloss',
                                         'waveglowloss', 'mse', 'mae'}
    assert losses.TacotronLoss(mel_loss = 'mae').get_config() \
        == jlosses.TacotronLoss(mel_loss = 'mae').get_config()


@pytest.mark.parametrize('level', ['phoneme', 'frame', 'none'])
def test_fastspeech2_loss_matches_jax(level):
    rng = np.random.default_rng(1)
    B, L, T, C = 2, 5, 12, 4
    durations = rng.integers(0, 4, (B, L)).astype(np.int32)
    token_mask = np.ones((B, L), bool)
    token_mask[1, 3:] = False
    frame_mask = np.ones((B, T), bool)
    frame_mask[1, 7:] = False
    n = L if level == 'phoneme' else T
    pitch, energy = (rng.standard_normal((B, n)).astype(np.float32) for _ in range(2))
    preds = tuple(rng.standard_normal(s).astype(np.float32)
                  for s in ((B, T, C), (B, T, C), (B, L), (B, n), (B, n)))
    targets = (rng.standard_normal((B, T + 2, C)).astype(np.float32), durations) \
        + ((pitch, energy) if level != 'none' else ())
    if level == 'none':
        preds = preds[:3] + (None, None)
    for config in ({}, {'mel_loss': 'mse', 'duration_weight': 2., 'pitch_weight': .5}):
        out = _both('FastSpeech2Loss', targets, preds + (frame_mask, token_mask), ** config)
    if level == 'none':
        assert float(out['pitch_loss'].abs().max()) == 0.


def test_ge2e_loss_matches_jax():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((4, 3, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis = -1, keepdims = True)
    _both('GE2ELoss', None, emb)
    _both('GE2ELoss', None, (emb, np.float32(7.5), np.float32(-3.)))
    _both('GE2ELoss', None, (emb, np.float32(-2.), np.float32(1.)))    # w clamped at 1e-3
    separated = np.repeat(np.eye(4, 8, dtype = np.float32)[:, None], 3, axis = 1) \
        + 0.01 * rng.standard_normal((4, 3, 8)).astype(np.float32)
    loss = losses.GE2ELoss()
    assert float(loss(None, torch.from_numpy(separated))['loss'].mean()) \
        < float(loss(None, torch.from_numpy(emb))['loss'].mean())


@pytest.mark.parametrize('name', ['mse', 'mae'])
def test_plain_losses_match_jax(name):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(2))
    _both(name, a, b)


def test_filter_fn_keeps_the_rows_jax_keeps():
    rows = list(range(10))
    kw = dict(prepare_fn = lambda r: ([0] * r, r), filter_fn = lambda x, r: 2 < r < 8,
              batch_size = 3, shuffle = False)
    out = [b for b in datasets.prepare_dataset(rows, ** kw)]
    ref = [b for b in jdatasets.prepare_dataset(rows, ** kw)]
    assert out == ref and sum(len(b) for b in out) == 5
