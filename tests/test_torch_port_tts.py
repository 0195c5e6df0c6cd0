"""The whole slice: the same texts through `text_to_speech_tpu.tts` and the
port's `tts`, text → Tacotron-2 (``overfit_demo``) → a tiny random WaveGlow.

Both packages read the models from a copy of the pretrained-models root in
``tmp_path`` (the JAX side saves the tiny vocoder there first; the port only
reads), so ``pretrained_models/`` is never written.  Two texts, split into
sentences, decode as one batch of chunks, deterministically (no prenet dropout, zero vocoder noise), on the
JAX package's plain decoder and float32 vocoder chain.  Cleaned text,
splitting and tokens must match exactly; mel and waveform agree within
1e-4 absolute (float32 on both sides; mel differences from the
autoregressive decoder feed the vocoder).

A single sentence takes the one-launch path in both packages
(`_tts_one_launch` → `compiled_tts`): the waveform is clipped and quantised
to 16 bits on the device.  ``overfit_demo`` has a location kernel of 15, which
is outside the fused decoder's envelope, and the JAX task layer cannot pass
``interpret`` to its kernel, so both sides decode on the plain route; the
fused route is held against the JAX kernel in
``test_torch_port_decoder_kernel.py``.  Mel within 1e-4; audio on the same
int16 grid within 1 LSB (a float32 difference can move a sample across a
rounding boundary).  The port's own routing — the frames-per-token retry, the
attention-fetch contract, `predict` — is pinned on the port alone."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models import get_pretrained
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow, tts as jax_tts
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.utils.callbacks import FunctionCallback

VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
TEXTS = ['Dr. Smith has 2 cats. They sleep all day.', 'Hello world!']
ATOL = 1e-4


@pytest.fixture
def outputs(tmp_model_dir):
    shutil.copytree('pretrained_models/overfit_demo', '{}/overfit_demo'.format(tmp_model_dir))
    reset_instances()
    try:
        arch = WaveGlowArch(** VOCODER)
        params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
        jwg = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        jwg.set_weights({k: _jax(v) if isinstance(v, dict) else v
                         for k, v in params.items()})
        jwg.save()
        # max_text_length=-2 splits into sentences: 4 chunks decode as one batch
        kwargs = dict(batch_size = 2, deterministic = True, max_length = 3.,
                      max_text_length = -2, max_trial = 1, min_fpt_ratio = -1.,
                      max_fpt_ratio = float('inf'), fetch_attention = False)
        ref = jax_tts(TEXTS, model = 'overfit_demo', vocoder = jwg, save = False,
                      display = False, ** kwargs)
        model = Tacotron2.from_pretrained('overfit_demo', root = tmp_model_dir,
                                          device = 'cpu')
        out = tts(TEXTS, model = model, vocoder = 'tiny_wg', device = 'cpu',
                  root = tmp_model_dir, save = False, display = False, ** kwargs)
        # one sentence, no batch_size: the one-launch int16 path on both sides
        # (the JAX package hands its vocoder only `vocoder_config` there)
        single = dict(deterministic = True, max_length = 3., min_fpt_ratio = -1.,
                      max_fpt_ratio = float('inf'),
                      vocoder_config = {'deterministic': True})
        ref_one = jax_tts(TEXTS[1], model = 'overfit_demo', vocoder = jwg, save = False,
                          display = False, ** single)
        out_one = tts(TEXTS[1], model = model, vocoder = 'tiny_wg', device = 'cpu',
                      root = tmp_model_dir, save = False, display = False, ** single)
        yield ref, out, model, get_pretrained('overfit_demo'), ref_one, out_one
    finally:
        reset_instances()


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_tts_matches_jax(outputs):
    ref, out, model, jax_model = outputs[:4]
    assert len(out) == len(ref) == len(TEXTS)
    for r, o in zip(ref, out):
        assert o['text'] == r['text']
        assert o['cleaned'] == r['cleaned']
        assert o['splitted'] == r['splitted']
        assert model.clean_text(o['text']) == jax_model.clean_text(r['text'])
        for s in o['splitted']:
            np.testing.assert_array_equal(model.encode_text(s, cleaned = True),
                                          jax_model.encode_text(s, cleaned = True))
        assert [m.shape for m in o['mel']] == [np.asarray(m).shape for m in r['mel']]
        for m_o, m_r in zip(o['mel'], r['mel']):
            np.testing.assert_allclose(m_o, np.asarray(m_r), atol = ATOL, rtol = 0)
        assert o['rate'] == r['rate']
        assert o['audio'].shape == r['audio'].shape
        assert o['audio'].shape[0] == sum(m.shape[0] for m in o['mel']) * 256
        assert np.isfinite(o['audio']).all()
        np.testing.assert_allclose(o['audio'], np.asarray(r['audio']), atol = ATOL, rtol = 0)
        assert o['attention'] == [None] * len(o['mel'])       # fetch_attention=False
    _single_sentence_matches_jax(* outputs[4:])


def _single_sentence_matches_jax(ref, out):
    """The single-sentence result is the JAX package's: 16-bit audio,
    dequantised on the host by / 32767."""
    assert len(ref) == len(out) == 1
    r, o = ref[0], out[0]
    assert o['cleaned'] == r['cleaned'] and o['splitted'] == r['splitted']
    assert len(o['mel']) == len(r['mel']) == 1
    assert o['mel'][0].shape == np.asarray(r['mel'][0]).shape
    np.testing.assert_allclose(o['mel'][0], np.asarray(r['mel'][0]), atol = ATOL, rtol = 0)
    audio, ref_audio = o['audio'], np.asarray(r['audio'])
    assert audio.dtype == np.float32 and audio.shape == ref_audio.shape
    assert audio.shape[0] == o['mel'][0].shape[0] * 256
    grid, ref_grid = audio * 32767., ref_audio * 32767.
    np.testing.assert_allclose(grid, np.round(grid), atol = 2e-3, rtol = 0)   # the int16 grid
    assert np.abs(audio).max() <= 1.
    assert np.abs(np.round(grid) - np.round(ref_grid)).max() <= 1             # 1 LSB
    assert o['rate'] == r['rate'] and o['time'] == pytest.approx(r['time'])


# -- the port's own routing (no JAX) -------------------------------------------------

@pytest.fixture(scope = 'module')
def port_models(tmp_path_factory):
    # read from a copy: `predict` without a vocoder saves mels under the
    # model's own directory
    root = str(tmp_path_factory.mktemp('models'))
    shutil.copytree('pretrained_models/overfit_demo', root + '/overfit_demo')
    model = Tacotron2.from_pretrained('overfit_demo', root = root, device = 'cpu')
    arch = WaveGlowArch(** VOCODER)
    vocoder = WaveGlow.from_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0),
                                device = 'cpu', ** VOCODER)
    return model, vocoder


def _count_calls(monkeypatch, obj, name):
    calls = []
    original = getattr(obj, name)

    def spy(* args, ** kwargs):
        calls.append(kwargs)
        return original(* args, ** kwargs)
    monkeypatch.setattr(obj, name, spy)
    return calls


def test_single_sentence_quantises_on_the_device(port_models, monkeypatch):
    """`infer` on one chunk goes through `compiled_tts` once: int16 on the
    device, `round(clip(audio, -1, 1) * 32767)`, no retry."""
    model, vocoder = port_models
    tts_calls = _count_calls(monkeypatch, model, 'compiled_tts')
    chunk_calls = _count_calls(monkeypatch, model, '_synthesize_chunks')
    kw = dict(deterministic = True, max_length = 2., min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'), vocoder_config = {'deterministic': True})
    out = model.infer('Hello world!', vocoder = vocoder, ** kw)
    assert len(tts_calls) == 1 and not chunk_calls
    assert set(model.last_timings) == {'decode_s', 'vocode_s'}

    tokens = model.encode_text(model.clean_text('Hello world!'), cleaned = True)
    a16, lengths, mel, attention = model.compiled_tts(
        tokens, vocoder, deterministic = True, max_length = 2.,
        vocoder_config = {'deterministic': True})
    # 128 decoded frames, padded to the vocoder's multiple of 256 on the device
    assert mel.shape == (1, 128, 80)
    assert a16.dtype == torch.int16 and a16.shape == (1, 256 * 256)
    frames = int(lengths[0])
    plain = vocoder.compiled_infer(mel, deterministic = True)
    expected = torch.round(torch.clamp(plain, -1., 1.) * 32767.).to(torch.int16)
    assert torch.equal(a16, expected)
    np.testing.assert_array_equal(
        out['audio'], a16[0, : frames * 256].numpy().astype(np.float32) / 32767.)
    assert attention.shape == (1, mel.shape[1], 64)


def test_one_launch_hands_the_vocoder_its_config_alone(port_models, monkeypatch):
    """On the one-launch path the vocoder gets `vocoder_config` and none of
    the decode's options, as in the JAX package (``deterministic`` decodes
    without dropout and still vocodes with noise)."""
    model, vocoder = port_models
    calls = _count_calls(monkeypatch, vocoder, 'device_vocoder_fn')
    kw = dict(model = model, vocoder = vocoder, max_length = 2., min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'), save = False, display = False)
    tts('Hello world!', deterministic = True, ** kw)
    tts('Hello world!', deterministic = True, vocoder_config = {'sigma': 0.5}, ** kw)
    assert calls == [{}, {'sigma': 0.5}]


def test_gate_failure_retries_and_keeps_the_last_output(port_models, monkeypatch):
    """A frames-per-token ratio outside the gates falls from the one-launch
    path to `_synthesize_chunks`, which decodes again at most `max_trial`
    times and keeps the last output."""
    model, vocoder = port_models
    infer_calls = _count_calls(monkeypatch, model, 'compiled_infer')
    chunk_calls = _count_calls(monkeypatch, model, '_synthesize_chunks')
    out = model.infer('Hello world!', vocoder = vocoder, deterministic = True,
                      max_length = 2., max_trial = 3, min_fpt_ratio = 1e9)
    assert len(chunk_calls) == 1
    assert len(infer_calls) == 1 + 3                 # the one-launch decode, then 3 trials
    assert len(out['mel']) == 1 and out['mel'][0].shape[0] >= 1
    assert out['attention'][0].shape == (out['mel'][0].shape[0], 64)   # sequential: fetched
    # the retry path vocodes the kept mel unquantised
    audio = vocoder(out['mel'][0], deterministic = True)[0]
    np.testing.assert_allclose(out['audio'], audio, atol = 1e-6, rtol = 0)
    # every trial saw the caller's generator (fresh dropout per retry)
    generator = torch.Generator().manual_seed(0)
    infer_calls.clear()
    model.infer('Hello world!', max_length = 2., max_trial = 2, min_fpt_ratio = 1e9,
                generator = generator)
    assert len(infer_calls) == 2 and all(c['generator'] is generator for c in infer_calls)


def test_attention_follows_the_fetch_contract(port_models):
    model, vocoder = port_models
    kw = dict(deterministic = True, max_length = 2., min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'))
    frames = lambda out: out['mel'][0].shape[0]
    out = model.infer('Hello world!', vocoder = vocoder, ** kw)        # vocoder queued
    assert out['attention'] == [None]
    out = model.infer('Hello world!', vocoder = vocoder, fetch_attention = True, ** kw)
    assert out['attention'][0].shape == (frames(out), 64)
    np.testing.assert_allclose(out['attention'][0].sum(axis = 1), 1., atol = 1e-5)
    out = model.infer('Hello world!', ** kw)                           # sequential
    assert out['attention'][0].shape == (frames(out), 64) and 'audio' not in out
    out = model.infer('Hello world!', fetch_attention = False, ** kw)
    assert out['attention'] == [None]
    batched = model.predict(['Hello world!', 'Hi.'], batch_size = 2, vocoder = vocoder,
                            save = False, display = False, ** kw)
    assert [o['attention'] for o in batched] == [[None], [None]]
    # with callbacks the queued path fetches attention, as in the JAX package
    seen = []
    out = model.infer('Hello world!', vocoder = vocoder,
                      callbacks = [FunctionCallback(seen.append)], ** kw)
    assert out['attention'][0].shape == (frames(out), 64) and seen == [out]
    # a win_len vocodes in windows, off the one-launch path, to the full length
    out = model.infer('Hello world!', vocoder = vocoder, win_len = 48, hop_len = -16, ** kw)
    assert out['audio'].shape == (frames(out) * 256,) and out['attention'] == [None]
    # a model without speaker conditioning leaves `embeddings` unused, as the
    # JAX architecture does
    np.testing.assert_array_equal(
        model.infer('Hello world!', embeddings = np.zeros(4, np.float32), ** kw)['mel'][0],
        model.infer('Hello world!', ** kw)['mel'][0])


def test_predict_routing(port_models, monkeypatch):
    """Without `batch_size` each text runs through `infer`; a list with
    ``batch_size > 1`` is batched across texts."""
    model, _ = port_models
    seen = []
    monkeypatch.setattr(model, 'infer', lambda text, ** kw: seen.append(('infer', text)))
    monkeypatch.setattr(model, 'predict_batched',
                        lambda texts, ** kw: seen.append(('batched', texts, kw['batch_size'])))
    model.predict('a')
    model.predict(['a', 'b'])
    model.predict(['a', 'b'], batch_size = 1)
    model.predict(['a', 'b'], batch_size = 2)
    assert seen == [('infer', 'a'), ('infer', 'a'), ('infer', 'b'), ('infer', 'a'),
                    ('infer', 'b'), ('batched', ['a', 'b'], 2)]
