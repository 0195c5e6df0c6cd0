"""FastSpeech-2 inference: the port against the JAX package, on the CPU.

The same tokens go through both packages, float32 unless stated:

  - `length_regulator` on the JAX package's own cases
    (``tests/test_fastspeech2.py``): every output equal;
  - the trained in-repo models ``fs2_smoke``, ``fs2_train`` and
    ``distill_student``, loaded by name in both packages (a copy of each in a
    ``tmp_path`` root), on a batch of two texts through `compiled_infer`:
    durations and the pitch and energy bins equal, mel, pitch and energy
    within 1e-4 absolute;
  - the controls (`d_control`, `p_control`, `e_control`) and `min_duration`
    on ``fs2_train``;
  - a random model at small widths with frame-level variances and a speaker
    projection, through the architectures' `infer`;
  - ``fs2_train`` under ``dtype=bfloat16`` (below);
  - `tts(model='fs2_train', vocoder=<tiny WaveGlow>)`: one sentence on the
    one-launch path (16-bit audio from the device) and two texts through
    `predict_batched`: mel and audio within 1e-4 absolute.

Rounding ties: a duration is ``round(exp(log_d) - 1)`` and a bin the
truncation of the scaled pitch or energy, both discontinuous, so an ulp of
difference between XLA and PyTorch in a predictor's output can move a token
by one frame or one bin.  Where the two packages disagree, the test
requires the value before rounding to lie within 1e-5 of the tie (x.5 for
a duration, an integer for a bin) and compares the rest of the output only
on the rows where every duration agrees.  No case here meets a tie.

bfloat16: both packages cast every float32 leaf, the layer norms' included,
and round at other places (PyTorch's CPU softmax and reductions accumulate
in float32 and round once).  The duration predictor's output then differs
by a few bfloat16 steps, so a duration within 0.1 of its tie may round the
other way (``fs2_train`` with these texts: two tokens of the second text,
at 1.494 and 3.447 before rounding in the port); the mel is held to 5e-2 of
its largest magnitude (a few bfloat16 roundings, 2^-8 each, carried
through the decoder stack) on the rows where the durations agree.

The `cuda` case holds the forward on the card at the JAX package's default
widths against the port on the CPU; it skips without a card and runs where
JAX is not installed:

    python -m pytest tests/test_torch_port_fastspeech2.py -m cuda --noconftest
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

try:
    import jax
    import jax.numpy as jnp
    from text_to_speech_tpu.models import get_pretrained as jax_get_pretrained, saving
    from text_to_speech_tpu.models.fastspeech2_arch import (
        FastSpeech2 as JaxFastSpeech2, length_regulator as jax_length_regulator)
    from text_to_speech_tpu.models.interfaces import reset_instances
    from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow, tts as jax_tts
except ModuleNotFoundError:
    # a machine with a card and without JAX runs the `cuda` case alone
    jnp = None
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import init_fastspeech2, init_waveglow
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.fastspeech2_arch import (
    FastSpeech2, HParamsFastSpeech2, length_regulator)
from text_to_speech_tpu_torch.models.tts import FastSpeech2 as FastSpeech2Task
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols
from text_to_speech_tpu_torch.weights import convert_tree

TRAINED = ('fs2_smoke', 'fs2_train', 'distill_student')
TEXTS = ['Hello world!', 'Dr. Smith has 2 cats.']
VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
ATOL = 1e-4
TIE = 1e-5


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


# -- the length regulator ------------------------------------------------------------

@pytest.mark.parametrize('x, durations, max_frames', [
    (np.arange(12, dtype = np.float32).reshape(1, 4, 3), [[2, 0, 1, 3]], 8),
    (np.ones((1, 3, 2), np.float32), [[4, 4, 4]], 8),           # the total clamped
    (np.ones((1, 3, 2), np.float32), [[0, 0, 0]], 4),           # no frame at all
], ids = ['expansion', 'clamped', 'zero'])
def test_length_regulator_matches_jax(x, durations, max_frames):
    durations = np.asarray(durations, np.int32)
    ref = jax_length_regulator(jnp.asarray(x), jnp.asarray(durations), max_frames)
    out = length_regulator(torch.from_numpy(x), torch.from_numpy(durations), max_frames)
    for name, o, r in zip(('expanded', 'mask', 'lengths', 'idx'), out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg = name)
    total = int(durations.sum())
    assert int(out[2][0]) == min(total, max_frames) and int(out[1].sum()) == min(total, max_frames)


# -- the trained models ----------------------------------------------------------------

@pytest.fixture(scope = 'module')
def root(tmp_path_factory):
    """A models root holding copies of the trained FastSpeech-2 models and the
    JAX package's tiny WaveGlow 'tiny_wg'; yields (root, JAX vocoder)."""
    root = str(tmp_path_factory.mktemp('models'))
    for name in TRAINED:
        shutil.copytree(os.path.join('pretrained_models', name), os.path.join(root, name))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        arch = WaveGlowArch(** VOCODER)
        vocoder = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        vocoder.set_weights(_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0)))
        vocoder.save()
        yield root, vocoder
        reset_instances()


@pytest.fixture(scope = 'module')
def models(root):
    """{name: (JAX model, port model)}, each loaded by name."""
    return {name: (jax_get_pretrained(name), get_pretrained(name, root = root[0], device = 'cpu'))
            for name in TRAINED}


def _tokens(model, texts = TEXTS):
    encoded = [model.encode_text(t) for t in texts]
    tokens = np.full((len(encoded), max(map(len, encoded))), model.blank_token_idx, np.int32)
    for i, e in enumerate(encoded):
        tokens[i, :len(e)] = e
    return tokens


def _pre_rounding(arch, params, tokens, d_control = 1., width = 64):
    """The port's durations before rounding, ``(exp(log_d) - 1) * d_control``,
    on the tokens padded to `width` as `compiled_infer` pads them."""
    tokens = np.pad(tokens, ((0, 0), (0, width - tokens.shape[1])))
    with torch.no_grad():
        enc, _, pad = arch.encode(params, torch.as_tensor(tokens, dtype = torch.long))
        log_d = arch._variance_predictor(params['duration_predictor'], enc, pad_mask = pad)
    return ((torch.exp(log_d) - 1.) * d_control).numpy()


def _bins(values, lo, hi, n_bins):
    scaled = (np.asarray(values, np.float32) - np.float32(lo)) \
        / np.float32(max(hi - lo, 1e-9)) * np.float32(n_bins)
    return np.clip(scaled.astype(np.int32), 0, n_bins - 1), scaled


def _check(out, ref, hp, pre, controls = (1., 1., 1.), atol = ATOL):
    """Durations and bins equal up to named ties; the rest within `atol` on
    the rows where every duration agrees.  Returns those rows."""
    durations, ref_durations = out.durations.numpy(), np.asarray(ref.durations)
    moved = durations != ref_durations
    if moved.any():
        # a duration that moved must sit on a rounding tie (x.5)
        tie = np.abs(pre[moved] - (np.floor(pre[moved]) + 0.5))
        assert (tie <= TIE).all(), 'durations differ off a tie: {}'.format(pre[moved])
        assert (np.abs(durations - ref_durations) <= 1).all()
    rows = ~moved.any(axis = 1)
    for name, lo, hi, control in (('pitch', hp.pitch_min, hp.pitch_max, controls[1]),
                                  ('energy', hp.energy_min, hp.energy_max, controls[2])):
        got, want = getattr(out, name), getattr(ref, name)
        if want is None:
            assert got is None
            continue
        got, want = _np(got)[rows], np.asarray(want, np.float32)[rows]
        np.testing.assert_allclose(got, want, atol = atol, rtol = 0, err_msg = name)
        bins, scaled = _bins(got * np.float32(control), lo, hi, hp.n_bins)
        ref_bins, _ = _bins(want * np.float32(control), lo, hi, hp.n_bins)
        edge = bins != ref_bins
        assert (np.abs(scaled[edge] - np.round(scaled[edge])) <= TIE).all(), \
            '{} bins differ off an edge'.format(name)
    np.testing.assert_array_equal(out.lengths.numpy()[rows], np.asarray(ref.lengths)[rows])
    for name in ('mel', 'decoder_output'):
        np.testing.assert_allclose(_np(getattr(out, name))[rows],
                                   np.asarray(getattr(ref, name))[rows],
                                   atol = atol, rtol = 0, err_msg = name)
    np.testing.assert_array_equal(out.attention_weights.numpy()[rows],
                                  np.asarray(ref.attention_weights)[rows])
    return rows


@pytest.mark.parametrize('name', TRAINED)
def test_trained_model_matches_jax(models, name):
    jax_model, model = models[name]
    assert type(model) is FastSpeech2Task and model.name == name
    assert model.arch.get_config() == jax_model.arch.get_config()
    tokens = _tokens(model)
    np.testing.assert_array_equal(tokens, _tokens(jax_model))
    ref = jax_model.compiled_infer(tokens, max_length = 10.)
    out = model.compiled_infer(tokens, max_length = 10.)
    assert out.mel.shape == np.asarray(ref.mel).shape
    rows = _check(out, ref, model.arch.hp, _pre_rounding(model.arch, model.params, tokens))
    assert rows.all() and int(out.lengths.min()) > 0


def test_controls_match_jax(models):
    """`d_control`, `p_control`, `e_control` and `min_duration` on ``fs2_train``."""
    jax_model, model = models['fs2_train']
    tokens = _tokens(model)
    controls = dict(d_control = 1.7, p_control = 0.6, e_control = 1.4)
    ref = jax_model.compiled_infer(tokens, max_length = 10., ** controls)
    out = model.compiled_infer(tokens, max_length = 10., ** controls)
    _check(out, ref, model.arch.hp, _pre_rounding(model.arch, model.params, tokens, 1.7),
           controls = (1.7, 0.6, 1.4))
    plain = model.compiled_infer(tokens, max_length = 10.)
    assert int(out.lengths.sum()) > int(plain.lengths.sum())
    # every real token at least 4 frames
    ref = jax_model.compiled_infer(tokens, max_length = 10., min_duration = 4)
    out = model.compiled_infer(tokens, max_length = 10., min_duration = 4)
    _check(out, ref, model.arch.hp, _pre_rounding(model.arch, model.params, tokens))
    real = np.zeros(out.durations.shape, bool)          # the tokens before the x64 padding
    real[:, :tokens.shape[1]] = tokens != model.blank_token_idx
    assert (out.durations.numpy()[real] >= 4).all() and (out.durations.numpy()[~real] == 0).all()


def test_padded_row_equals_its_own_run(models):
    """A row of the padded batch equals the text decoded alone (the pad
    masks after each block, the keys-only attention mask, the postnet's
    frame mask)."""
    _, model = models['fs2_train']
    both = model.compiled_infer(_tokens(model), max_length = 10.)
    for i, text in enumerate(TEXTS):
        alone = model.compiled_infer(_tokens(model, [text]), max_length = 10.)
        n = int(alone.lengths[0])
        assert int(both.lengths[i]) == n
        np.testing.assert_array_equal(both.durations[i, :alone.durations.shape[1]].numpy(),
                                      alone.durations[0].numpy())
        np.testing.assert_allclose(both.mel[i, :n].numpy(), alone.mel[0, :n].numpy(),
                                   atol = 1e-5, rtol = 0)
        assert float(both.mel[i, n:].abs().max()) == 0.


def test_bfloat16_matches_jax(models):
    """``dtype=bfloat16`` on ``fs2_train``: a duration may round the other
    way where the value before rounding lies within bfloat16's reach of the
    tie (0.1 frames); the mel is compared on the rows where every duration
    agrees, and the port's bfloat16 mel against its float32 one."""
    jax_model, model = models['fs2_train']
    tokens = _tokens(model)
    ref = jax_model.compiled_infer(tokens, max_length = 10., dtype = jnp.bfloat16)
    out = model.compiled_infer(tokens, max_length = 10., dtype = torch.bfloat16)
    f32 = model.compiled_infer(tokens, max_length = 10.)
    assert out.mel.dtype == torch.float32 and out.mel.shape == np.asarray(ref.mel).shape
    pre = _pre_rounding(model.arch, model._weights(torch.bfloat16)[0], tokens)
    durations, ref_durations = out.durations.numpy(), np.asarray(ref.durations)
    moved = durations != ref_durations
    assert (np.abs(durations - ref_durations)[moved] == 1).all()
    assert (np.abs(pre[moved] - (np.floor(pre[moved]) + 0.5)) <= 0.1).all(), pre[moved]
    rows = ~moved.any(axis = 1)
    assert rows.any()
    want = np.asarray(ref.mel)[rows]
    assert float(np.abs(out.mel.numpy()[rows] - want).max()) <= 5e-2 * float(np.abs(want).max())
    same = (out.durations == f32.durations).all(dim = 1)
    assert bool(same.any())
    assert float((out.mel[same] - f32.mel[same]).abs().max()) \
        <= 5e-2 * float(f32.mel[same].abs().max())
    # the cast is kept: a second call reuses the bfloat16 params
    assert model._weights(torch.bfloat16)[0] is model._weights(torch.bfloat16)[0]


def test_frame_level_and_speaker_projection_match_jax():
    """A random model at small widths with frame-level pitch and energy and
    an 8-wide speaker projection, through the architectures' `infer`."""
    config = dict(vocab_size = 24, n_mel_channels = 20, dim = 16, n_heads = 2,
                  encoder_layers = 1, decoder_layers = 1, ffn_dim = 32, variance_filters = 16,
                  n_bins = 8, variance_level = 'frame', speaker_embedding_dim = 8,
                  postnet_n_conv = 2, postnet_filters = 16, max_position = 128)
    jparams, jstate = init_fastspeech2(HParamsFastSpeech2(** config), seed = 4)
    # running statistics away from the identity, so the postnet's batch norm counts
    rng = np.random.default_rng(5)
    for node in jstate['postnet'].values():
        node['bn']['moving_mean'] = (0.1 * rng.standard_normal(node['bn']['moving_mean'].shape)
                                     ).astype(np.float32)
        node['bn']['moving_var'] = rng.uniform(0.5, 2., node['bn']['moving_var'].shape
                                               ).astype(np.float32)
    tokens = np.random.default_rng(6).integers(1, 24, (2, 16)).astype(np.int32)
    tokens[1, 11:] = 0
    spk = np.random.default_rng(7).standard_normal((2, 8)).astype(np.float32)
    kw = dict(max_frames = 64, min_duration = 2, d_control = 1.2)
    jarch = JaxFastSpeech2(** config)
    ref = jax.jit(lambda p, s, t, e: jarch.infer(p, s, t, speaker_embedding = e, ** kw))(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), jnp.asarray(spk))
    arch = FastSpeech2(** config)
    params, state = convert_tree(jparams), convert_tree(jstate)
    with torch.no_grad():
        out = arch.infer(params, state, torch.from_numpy(tokens).long(),
                         speaker_embedding = torch.from_numpy(spk), ** kw)
        without = arch.infer(params, state, torch.from_numpy(tokens).long(), ** kw)
    assert out.pitch.shape == (2, 64)                         # frame level
    pre = _pre_rounding(arch, params, tokens, 1.2)
    _check(out, ref, arch.hp, pre)
    assert float((out.mel - without.mel).abs().max()) > 1e-3  # the speaker counts


def test_tts_matches_jax(models, root):
    """`tts(model='fs2_train')`: one sentence on the one-launch path and two
    texts through `predict_batched`."""
    root, jax_vocoder = root
    kw = dict(save = False, display = False)
    single = dict(kw, vocoder_config = {'deterministic': True})
    ref = jax_tts(TEXTS[0], model = 'fs2_train', vocoder = jax_vocoder, ** single)
    out = tts(TEXTS[0], model = 'fs2_train', vocoder = 'tiny_wg', root = root, device = 'cpu',
              ** single)
    batched = dict(kw, batch_size = 2, deterministic = True, min_fpt_ratio = 0.,
                   max_fpt_ratio = float('inf'))
    ref += jax_tts(TEXTS, model = 'fs2_train', vocoder = jax_vocoder, ** batched)
    out += tts(TEXTS, model = 'fs2_train', vocoder = 'tiny_wg', root = root, device = 'cpu',
               ** batched)
    for o, r in zip(out, ref):
        assert o['cleaned'] == r['cleaned'] and o['splitted'] == r['splitted']
        assert [m.shape for m in o['mel']] == [np.asarray(m).shape for m in r['mel']]
        for m, m_ref in zip(o['mel'], r['mel']):
            np.testing.assert_allclose(m, np.asarray(m_ref), atol = ATOL, rtol = 0)
        assert o['audio'].shape == np.asarray(r['audio']).shape == (o['mel'][0].shape[0] * 256,)
        np.testing.assert_allclose(o['audio'], np.asarray(r['audio']), atol = ATOL, rtol = 0)
    grid = out[0]['audio'] * 32767.                     # the one-launch path's int16
    np.testing.assert_allclose(grid, np.round(grid), atol = 2e-3, rtol = 0)


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_forward_on_the_card_matches_the_cpu(cuda_device):
    """The JAX package's default widths, random seeded weights: the float32
    forward on the card against the port on the CPU.  Durations equal (or on
    a tie), the rest within 1e-4 of the mel's largest magnitude (float32 on
    both sides, another summation order)."""
    params, state = init_fastspeech2(HParamsFastSpeech2(vocab_size = len(en_symbols)), seed = 2)
    tokens = default_english_tokenizer().encode('The quick brown fox jumps over the lazy dog.')
    out = {}
    for device in ('cpu', cuda_device):
        model = FastSpeech2Task.from_jax(params, state, tokenizer = default_english_tokenizer(),
                                         device = device, vocab_size = len(en_symbols))
        result = model.compiled_infer(tokens, max_length = 10., min_duration = 6)
        out[device] = result._replace(** {k: v.cpu() for k, v in result._asdict().items()
                                         if torch.is_tensor(v)})
        if device == 'cpu':
            pre = _pre_rounding(model.arch, model.params, tokens[None])
    cpu, card = out['cpu'], out[cuda_device]
    rows = _check(card, cpu, model.arch.hp, pre, atol = 1e-4 * float(cpu.mel.abs().max()))
    assert rows.all() and int(card.lengths[0]) >= 6 * len(tokens)
