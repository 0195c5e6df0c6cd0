"""SV2TTS voice cloning: speaker-conditioned Tacotron-2 and `SV2TTSTacotron2`,
the port against the JAX package.

One tiny Tacotron-2 at widths the fused decoder takes (``attention_rnn_dim
== decoder_rnn_dim``, a location kernel of 31, two prenet layers, tokens a
multiple of 8) with an 8-wide speaker embedding and weights drawn from a
numpy seed, handed to both packages.  Deterministic decodes (the two
packages' dropout bits differ by design), float32 unless stated:

  - `encode` for each concat position, 'start', 'end', 'prenet' and all
    three: 1e-5 absolute;
  - the plain decode (`infer`): mel, gates and alignments within 1e-4
    absolute (as ``test_torch_port_tacotron2.py``);
  - `infer_fused` on K3's plain version with the 'end' and 'prenet'
    concats, so a memory of 24 (the encoder's width is 16) and a non-zero
    prenet addend, against the JAX `infer_fused(interpret=True)`: float32
    5e-4 absolute (the tolerance of ``test_torch_port_decoder_kernel.py``),
    the int8 LSTM mode 1e-4 of each tensor's largest value (as there);
    bfloat16 2e-2 of it (h and ctx round to 8 bits every step, so another
    summation order can flip a rounding the next steps carry on: 2.5
    roundings, the bfloat16 limit `chip_smoke.py` holds K3 to);
  - the task model loaded by name (`models.get_pretrained` → the port's
    `SV2TTSTacotron2`) with the speaker as a vector, a table by mean and
    label, the stored default and reference audio through `encoder_name`;
    `predict_batched` and the windowed route; `tts(model=name)`: mels and
    audio within 1e-4 absolute;
  - trained weights: ``pretrained_models/overfit_demo`` transferred into an
    SV2TTS model by the JAX package in a ``tmp_path`` root, loaded by the
    port: the same mel within 1e-4.

Nothing is written under ``pretrained_models/``.  The `cuda` case holds K3
at NVIDIA width with D = 768 and a non-zero addend against its plain
version; it skips without a card, and runs where JAX is not installed:

    python -m pytest tests/test_torch_port_sv2tts.py -m cuda --noconftest
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

try:
    import jax.numpy as jnp
    from text_to_speech_tpu.models import saving
    from text_to_speech_tpu.models.encoder import SpeakerEncoder as JaxSpeakerEncoder
    from text_to_speech_tpu.models.interfaces import reset_instances
    from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
    from text_to_speech_tpu.models.tts import (
        SV2TTSTacotron2 as JaxSV2TTS, WaveGlow as JaxWaveGlow, tts as jax_tts)
except ModuleNotFoundError:
    # a machine with a card and without JAX runs the `cuda` case alone
    # (``-m cuda --noconftest``)
    jnp = None
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import init_audio_encoder, init_tacotron2, init_waveglow
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.encoder_arch import AudioEncoder
from text_to_speech_tpu_torch.models.tacotron2_arch import HParamsTacotron2, Tacotron2
from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2, Tacotron2 as Tacotron2Task
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.ops import decoder_kernel as dk
from text_to_speech_tpu_torch.utils.file_utils import load_json
from text_to_speech_tpu_torch.weights import tacotron2_from_jax

SPK = 8
TINY = dict(
    n_mel_channels = 80, encoder_embedding_dim = 16, encoder_n_conv = 1,
    encoder_kernel_size = 3, prenet_sizes = (8, 8), lsa_attention_dim = 8,
    lsa_attention_filters = 4, lsa_attention_kernel_size = 31, attention_rnn_dim = 16,
    decoder_rnn_dim = 16, postnet_n_conv = 2, postnet_filters = 8, postnet_kernel_size = 3,
    speaker_embedding_dim = SPK)
ENCODER = dict(embedding_dim = SPK, filters = (8, 8), strides = (2, 2), kernel_size = 3)
VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
ATOL = 1e-4
DECODE = dict(deterministic = True, max_length = 1., max_trial = 1, min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'))


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _weights(config, vocab_size = 24, seed = 0):
    params, state = init_tacotron2(HParamsTacotron2(vocab_size = vocab_size, ** config),
                                   seed = seed)
    # a random stop gate fires at once: bias it off, so that lengths grow
    params['decoder']['gate_layer']['bias'][:] = -4.
    return params, state


def _tokens(B = 2, S = 32):
    tokens = np.random.default_rng(1).integers(1, 24, (B, S)).astype(np.int32)
    tokens[1, S - S // 4:] = 0                 # unequal encoder lengths
    return tokens


def _speakers(B = 2):
    return np.random.default_rng(2).standard_normal((B, SPK)).astype(np.float32)


def _clip(seconds, f0, seed):
    t = np.arange(int(seconds * 16000)) / 16000
    noise = np.random.default_rng(seed).standard_normal(len(t))
    return {'audio': (0.5 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise).astype(np.float32),
            'rate': 16000}


# -- the architecture ------------------------------------------------------------------

@pytest.mark.parametrize('pos', ['start', 'end', 'prenet', ('start', 'end', 'prenet')])
def test_encode_matches_jax(pos):
    config = dict(TINY, speaker_concat_pos = pos)
    jparams, jstate = _weights(config)
    params, state = tacotron2_from_jax(jparams, jstate)
    arch = Tacotron2(vocab_size = 24, ** config)
    tokens, spk = _tokens(), _speakers()
    ref, ref_mask, _ = JaxTacotron2(vocab_size = 24, ** config).encode(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), speaker_embedding = jnp.asarray(spk))
    out, mask = arch.encode(params, state, torch.from_numpy(tokens).long(),
                            speaker_embedding = torch.from_numpy(spk))
    assert out.shape == (2, 32, arch.encoder_output_dim)
    assert arch.encoder_output_dim == (24 if 'end' in pos else 16)
    assert arch.prenet_in_dim == (88 if 'prenet' in pos else 80)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = 1e-5, rtol = 0)
    if 'start' in pos:                         # the JAX eye init: the identity on the embedding
        kernel = jparams['encoder']['speaker_projection']['kernel']
        np.testing.assert_array_equal(kernel, np.eye(16 + SPK, 16, dtype = np.float32))
    if pos == 'end':
        np.testing.assert_array_equal(out[1, 24:, 16:].numpy(), 0.)   # re-masked
        with pytest.raises(ValueError, match = 'speaker_embedding'):
            arch.encode(params, state, torch.from_numpy(tokens).long())


@pytest.fixture(scope = 'module')
def conditioned():
    """The ('end', 'prenet') architecture: D = 24 and a prenet addend."""
    config = dict(TINY, speaker_concat_pos = ('end', 'prenet'))
    jparams, jstate = _weights(config)
    return config, (jparams, jstate), tacotron2_from_jax(jparams, jstate)


def test_plain_decode_matches_jax(conditioned):
    config, (jparams, jstate), (params, state) = conditioned
    tokens, spk = _tokens(), _speakers()
    kw = dict(deterministic = True, early_stopping = False, max_length = 16)
    ref = JaxTacotron2(vocab_size = 24, ** config).infer(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), speaker_embedding = jnp.asarray(spk),
        ** kw)
    with torch.no_grad():
        out = Tacotron2(vocab_size = 24, ** config).infer(
            params, state, torch.from_numpy(tokens).long(),
            speaker_embedding = torch.from_numpy(spk), ** kw)
    for name in ('mel', 'stop_tokens', 'attention_weights'):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol = ATOL, rtol = 0, err_msg = name)


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8_lstm'])
def test_infer_fused_with_addend_matches_jax(conditioned, mode):
    """K3's plain version at D = 24 (not the encoder's 16) with a non-zero
    ``extra``, against the JAX kernel in interpret mode."""
    config, (jparams, jstate), (params, state) = conditioned
    arch = Tacotron2(vocab_size = 24, ** config)
    tokens, spk = _tokens(), _speakers()
    kw = dict(deterministic = True, early_stopping = False, max_length = 16, chunk = 8,
              int8_lstm = mode == 'int8_lstm',
              dtype = {'bfloat16': torch.bfloat16}.get(mode))
    jkw = dict(kw, dtype = jnp.bfloat16 if mode == 'bfloat16' else None)
    ref = JaxTacotron2(vocab_size = 24, ** config).infer_fused(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), speaker_embedding = jnp.asarray(spk),
        interpret = True, ** jkw)
    spk_t = torch.from_numpy(spk)
    with torch.no_grad():
        out = arch.infer_fused(params, state, torch.from_numpy(tokens).long(),
                               speaker_embedding = spk_t, ** kw)
        extra = arch.prenet_addend(params, spk_t, 2, 'cpu')
        # the addend is the folded concat: layer_0([mel | spk]) - layer_0([mel | 0])
        w0 = params['decoder']['prenet']['layer_0']['weight']
        np.testing.assert_allclose(extra.numpy(), (spk_t @ w0[:, 80:].T).numpy(), atol = 1e-6)
        assert float(extra.abs().max()) > 0.1
        without = arch.infer_fused(params, state, torch.from_numpy(tokens).long(),
                                   speaker_embedding = spk_t, ** dict(kw, int8_lstm = False))
    for name in ('mel', 'stop_tokens', 'attention_weights'):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        if mode == 'float32':
            np.testing.assert_allclose(got, want, atol = 5e-4, rtol = 0, err_msg = name)
        else:
            limit = {'bfloat16': 2e-2, 'int8_lstm': 1e-4}[mode]
            assert float(np.abs(got - want).max()) <= limit * float(np.abs(want).max()), name
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    if mode == 'int8_lstm':                    # the int8 products are in use
        assert float((out.mel - without.mel).abs().max()) > 1e-3 * float(without.mel.abs().max())


# -- the task model ------------------------------------------------------------------------

@pytest.fixture(scope = 'module')
def saved(tmp_path_factory):
    """A models root with the JAX package's tiny SV2TTS Tacotron-2 'sv_tiny'
    ('end' concat, seeded weights, `encoder_name` 'enc_tiny'), its speaker
    encoder and a tiny WaveGlow 'tiny_wg'; yields (root, JAX SV2TTS model,
    JAX vocoder)."""
    root = str(tmp_path_factory.mktemp('models'))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        encoder = JaxSpeakerEncoder(name = 'enc_tiny', ** ENCODER)
        encoder.set_weights(* (_jax(t) for t in init_audio_encoder(
            AudioEncoder(** ENCODER).hp, seed = 1, statistics = True)))
        encoder.save()
        config = {k: v for k, v in TINY.items() if k != 'speaker_embedding_dim'}
        model = JaxSV2TTS(lang = 'en', name = 'sv_tiny', embedding_dim = SPK,
                          encoder_name = 'enc_tiny', max_decoder_steps = 64, ** config)
        params, state = _weights(dict(TINY, speaker_concat_pos = 'end'),
                                 vocab_size = model.arch.hp.vocab_size, seed = 3)
        model.set_weights(_jax(params), _jax(state))
        model.save()
        arch = WaveGlowArch(** VOCODER)
        vocoder = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        vocoder.set_weights(_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0)))
        vocoder.save()
        yield root, model, vocoder
        reset_instances()


def _close(out, ref):
    assert len(out['mel']) == len(ref['mel'])
    for m, r in zip(out['mel'], ref['mel']):
        np.testing.assert_allclose(m, np.asarray(r), atol = ATOL, rtol = 0)
    if 'audio' in ref:
        np.testing.assert_allclose(out['audio'], np.asarray(ref['audio']), atol = ATOL, rtol = 0)


def test_infer_with_every_speaker_source_matches_jax(saved, tmp_path):
    root, jax_model, _ = saved
    model = get_pretrained('sv_tiny', root = root, device = 'cpu')
    assert type(model) is SV2TTSTacotron2 and model.encoder_name == 'enc_tiny'
    assert model.embedding_dim == SPK and model.arch.concat_pos == ('end',)
    text, spk = 'Hello world!', _speakers()
    _close(model.infer(text, embeddings = spk[0], ** DECODE),
           jax_model.infer(text, embeddings = spk[0], ** DECODE))
    table = {'embedding': np.concatenate([spk, 0.5 - spk]), 'speaker': np.array(['a', 'b'] * 2)}
    # mode 'label' is the JAX package's 'mean' with a label (which it refuses as a mode)
    for kw, jax_kw in ((dict(mode = 'mean'), dict(mode = 'mean')),
                       (dict(mode = 'label', label = 'b'), dict(mode = 'mean', label = 'b'))):
        np.testing.assert_allclose(model.get_speaker_embedding(table, ** kw),
                                   jax_model.get_speaker_embedding(table, ** jax_kw), atol = 1e-7)
        _close(model.infer(text, embeddings = table, ** kw, ** DECODE),
               jax_model.infer(text, embeddings = table, ** jax_kw, ** DECODE))
    # a table file in the model's embeddings directory
    table_file = model.save_embeddings('speakers.npz', table['embedding'],
                                       speaker = table['speaker'])
    assert os.path.dirname(table_file) == os.path.join(root, 'sv_tiny', 'embeddings')
    _close(model.infer(text, embeddings = table_file, mode = 'label', label = 'a', ** DECODE),
           jax_model.infer(text, embeddings = np.full(SPK, 0.25, np.float32), ** DECODE))
    # the stored default: written by the port where the JAX package reads it
    with pytest.raises(ValueError, match = 'default'):
        model.infer(text, ** DECODE)
    model.set_default_embedding(spk[1])
    assert model.default_embedding_file == os.path.join(
        root, 'sv_tiny', 'embeddings', 'default_embedding.npy')
    _close(model.infer(text, ** DECODE), jax_model.infer(text, ** DECODE))
    # reference audio through the `encoder_name` speaker encoder
    clip = _clip(0.6, 180., 4)
    assert model.speaker_encoder.device == torch.device('cpu')
    _close(model.infer(text, audio = clip, ** DECODE),
           jax_model.infer(text, audio = clip, ** DECODE))
    assert model.get_speaker_config() == {'embedding_dim': SPK, 'encoder_name': 'enc_tiny'}


def test_predict_batched_and_windowed_match_jax(saved):
    root, jax_model, jax_vocoder = saved
    model = get_pretrained('sv_tiny', root = root, device = 'cpu')
    vocoder = get_pretrained('tiny_wg', root = root, device = 'cpu')
    texts, spk = ['Dr. Smith has 2 cats. They sleep all day.', 'Hello world!'], _speakers()
    kw = dict(DECODE, embeddings = spk[0], vocoder_config = {'deterministic': True},
              max_text_length = -2, save = False, display = False)
    out = model.predict_batched(texts, vocoder = vocoder, ** kw)
    ref = jax_model.predict_batched(texts, vocoder = jax_vocoder, ** kw)
    assert [len(o['mel']) for o in out] == [len(r['mel']) for r in ref] == [3, 1]
    for o, r in zip(out, ref):
        _close(o, r)
    # the windowed route: the windows cut from the decoded mels
    kw['vocoder_config'] = {'win_len': 8, 'hop_len': -2, 'deterministic': True}
    _close(model.infer(texts[0], vocoder = vocoder, ** kw),
           jax_model.infer(texts[0], vocoder = jax_vocoder, ** kw))
    # per-text speakers: each chunk keeps its text's row, through the retries
    rows = dict(DECODE, max_text_length = -2, min_fpt_ratio = 1e9, max_trial = 2)
    # (the `Tacotron2` flows: `SV2TTSTacotron2` resolves one speaker for all)
    both = Tacotron2Task.predict_batched(model, texts, embeddings = spk, ** rows)
    for i, text in enumerate(texts):
        alone = Tacotron2Task.infer(model, text, embeddings = spk[i],
                                    ** dict(DECODE, max_text_length = -2))
        for m, a in zip(both[i]['mel'], alone['mel']):
            np.testing.assert_allclose(m, a, atol = ATOL, rtol = 0)


def test_tts_by_name_and_the_cache(saved, tmp_path):
    """`tts(model=<name>)` builds the port's `SV2TTSTacotron2`; ``map.json``
    is keyed by text, so a second speaker decodes again (``overwrite``
    defaults to True), and an explicit ``overwrite=False`` answers from it."""
    root, jax_model, jax_vocoder = saved
    text, spk = 'Hello world!', _speakers()
    kw = dict(DECODE, vocoder_config = {'deterministic': True}, display = False)
    out = tts(text, model = 'sv_tiny', vocoder = 'tiny_wg', root = root, device = 'cpu',
              embeddings = spk[0], save = False, ** kw)
    ref = jax_tts(text, model = jax_model, vocoder = jax_vocoder, embeddings = spk[0],
                  save = False, ** kw)
    _close(out[0], ref[0])
    model = get_pretrained('sv_tiny', root = root, device = 'cpu')
    calls = []
    original = model.compiled_tts
    model.compiled_tts = lambda * a, ** k: calls.append(1) or original(* a, ** k)
    directory = str(tmp_path / 'preds')
    first = tts(text, model = model, vocoder = 'tiny_wg', root = root, device = 'cpu',
                embeddings = spk[0], directory = directory, ** kw)
    second = tts(text, model = model, vocoder = 'tiny_wg', root = root, device = 'cpu',
                 embeddings = spk[1], directory = directory, ** kw)
    assert len(calls) == 2 and list(load_json(os.path.join(directory, 'map.json'))) == [text]
    assert float(np.abs(first[0]['audio'] - second[0]['audio']).max()) > 1e-3
    cached = tts(text, model = model, vocoder = 'tiny_wg', root = root, device = 'cpu',
                 embeddings = spk[0], directory = directory, overwrite = False, ** kw)
    assert len(calls) == 2 and 'mel' not in cached[0]


def test_trained_weights_transferred_by_jax(tmp_path, monkeypatch):
    """``overfit_demo`` transferred into an SV2TTS model by the JAX package
    (`from_pretrained(name, pretrained_name)`), saved, loaded by the port."""
    root = str(tmp_path)
    os.symlink(os.path.abspath('pretrained_models/overfit_demo'),
               os.path.join(root, 'overfit_demo'))
    monkeypatch.setattr(saving, '_PRETRAINED_ROOT', root)
    reset_instances()
    try:
        jax_model = JaxSV2TTS.from_pretrained('sv_demo', 'overfit_demo', lang = 'en',
                                              embedding_dim = 16)
        jax_model.save()
        model = get_pretrained('sv_demo', root = root, device = 'cpu')
        assert type(model) is SV2TTSTacotron2 and model.arch.encoder_output_dim == 512 + 16
        spk = np.random.default_rng(5).standard_normal(16).astype(np.float32)
        kw = dict(DECODE)
        _close(model.infer('Hello world!', embeddings = spk, ** kw),
               jax_model.infer('Hello world!', embeddings = spk, ** kw))
    finally:
        reset_instances()
        shutil.rmtree(os.path.join(root, 'sv_demo'), ignore_errors = True)


# -- on the card -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 4])
def test_kernel_with_addend_at_nvidia_width(cuda_device, B):
    """K3 at NVIDIA width with the 'end' and 'prenet' concats of a 256-wide
    speaker: D = 768 and a non-zero addend, 64 steps, float32: 1e-4 of each
    tensor's largest value (the limit `chip_smoke.py` holds K3 to)."""
    config = dict(speaker_embedding_dim = 256, speaker_concat_pos = ('end', 'prenet'))
    arch = Tacotron2(vocab_size = 148, ** config)
    params, state = (_to(t, cuda_device) for t in tacotron2_from_jax(
        * _weights(config, vocab_size = 148, seed = 7)))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(1, 148, (B, 64))).to(cuda_device)
    spk = torch.from_numpy(np.random.default_rng(9).standard_normal((B, 256))
                           .astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        enc, mask = arch.encode(params, state, tokens, speaker_embedding = spk)
        mem, pm = arch.process_memory(params['decoder'], enc, mask)
        extra = arch.prenet_addend(params, spk, B, cuda_device)
    assert mem.shape[-1] == 768 and float(extra.abs().max()) > 0.
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = 80)
    args = (weights, mem.contiguous(), pm.contiguous(), mask.float(),
            mask.sum(dim = 1).to(torch.int32), extra)
    fresh = lambda: dk.init_decoder_state(B, 64, 768, 1024, 80, torch.float32, cuda_device)
    seed = torch.tensor([3], dtype = torch.int64, device = cuda_device)
    st, ref_st = fresh(), fresh()
    steps, attn, _ = dk.decoder_steps(* args, st, seed, n_steps = 64, deterministic = True)
    torch.cuda.synchronize()
    ref_steps, ref_attn, _ = dk.decoder_steps_plain(* args, ref_st, seed, n_steps = 64,
                                                    deterministic = True)
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    assert rel(steps, ref_steps) <= 1e-4 and rel(attn, ref_attn) <= 1e-4
    for key in ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'cum'):
        assert rel(st[key], ref_st[key]) <= 1e-4, key


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
