"""Importing NVIDIA's Tacotron-2 and WaveGlow checkpoints: the port against
the JAX package, on the CPU.  Nothing is downloaded: the state dicts are
synthetic, in NVIDIA's layout and names.

  - the converters: `synthetic_nvidia_tacotron2_sd` at NVIDIA's full width
    (numpy, no decode), with and without the ``module.`` prefix, and a
    weight-normed WaveGlow with early outputs every 2 flows, saved with
    `torch.save` (under ``state_dict``, keys prefixed ``module.``) and as a
    hand-written ``.safetensors`` file with BF16 and F16 tensors: both
    packages' trees and configs equal to the bit;
  - `from_nvidia_pretrained` in both packages on narrow dicts (a location
    kernel of 31, two WN layers), each into its own root: the JSON files
    are equal, each package loads the directory the other wrote (equal
    trees), and decode (plain decoder, deterministic) and vocode
    (deterministic) agree within 1e-4 absolute;
  - `tts(text, lang='en', root=...)` answers from the imported
    ``pretrained_tacotron2`` and ``waveglow``.

The `cuda` case imports the full-width Tacotron-2 on the card and holds its
decode on K3 (4 launches for 256 frames) against the port's plain decoder,
1e-4 of each tensor's largest magnitude, as ``chip_smoke.py`` does; it skips
without a card and runs where JAX is not installed:

    python -m pytest tests/test_torch_port_nvidia_import.py -m cuda --noconftest
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

try:
    import ml_dtypes
    from text_to_speech_tpu.models import get_pretrained as jax_get_pretrained, saving
    from text_to_speech_tpu.models import tts_checkpoints as jax_checkpoints
    from text_to_speech_tpu.models.interfaces import reset_instances
    from text_to_speech_tpu.models.tts import (
        Tacotron2 as JaxTacotron2, WaveGlow as JaxWaveGlow)
    from text_to_speech_tpu.train.checkpoint import flatten_tree
    from test_torch_parity import synthetic_nvidia_tacotron2_sd
except ModuleNotFoundError:
    # a machine with a card and without JAX runs the `cuda` case alone
    jax_checkpoints = None
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import nvidia_tacotron2_state_dict, nvidia_waveglow_state_dict
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models import tts_checkpoints
from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
from text_to_speech_tpu_torch.weights import flatten_tree as port_flatten_tree

NARROW_TACOTRON2 = dict(vocab_size = 148, embedding_dim = 32, prenet_dim = 16,
                        attention_rnn_dim = 32, decoder_rnn_dim = 32, attention_dim = 16,
                        location_filters = 4, location_kernel = 31, postnet_filters = 16,
                        gate_bias = -4.)
NARROW_WAVEGLOW = dict(n_flows = 6, n_early_every = 2, wn_layers = 2, wn_channels = 32)
TEXT = 'Hello world!'
JSON_FILES = ('config.json', 'saving/config_models.json', 'saving/tokenizer.json',
              'saving/mel_fn.json', 'saving/history.json', 'saving/checkpoint/checkpoint.json')


def _assert_trees_equal(got, want):
    got, want = port_flatten_tree(got), port_flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg = key)


# -- the converters ----------------------------------------------------------------------

@pytest.mark.parametrize('prefix', ['', 'module.'])
def test_tacotron2_converter_matches_jax(prefix):
    sd = {prefix + k: v for k, v in synthetic_nvidia_tacotron2_sd().items()}
    got, want = tts_checkpoints.convert_nvidia_tacotron2(sd), \
        jax_checkpoints.convert_nvidia_tacotron2(sd)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    config = tts_checkpoints.tacotron2_config_from_state_dict(sd)
    assert config == jax_checkpoints.tacotron2_config_from_state_dict(sd)
    assert config['lsa_attention_kernel_size'] == 31 and config['attention_rnn_dim'] == 1024
    assert tts_checkpoints.load_nvidia_tacotron2(sd)[0].keys() == got[0].keys()


def _safetensors(path, sd):
    """`sd` written as a ``.safetensors`` file: the weight-norm directions
    (``weight_v``) in BF16, the biases in F16, the rest in F32."""
    header, chunks, offset = {}, [], 0
    for name, value in sd.items():
        value = np.ascontiguousarray(value)
        if name.endswith('weight_v'):
            tag, raw = 'BF16', value.astype(ml_dtypes.bfloat16).tobytes()
        elif name.endswith('bias'):
            tag, raw = 'F16', value.astype(np.float16).tobytes()
        else:
            tag, raw = 'F32', value.astype(np.float32).tobytes()
        header[name] = {'dtype': tag, 'shape': list(value.shape),
                        'data_offsets': [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    header['__metadata__'] = {'format': 'pt'}
    blob = json.dumps(header).encode('utf-8')
    with open(path, 'wb') as f:
        f.write(len(blob).to_bytes(8, 'little'))
        f.write(blob)
        f.write(b''.join(chunks))
    return path


@pytest.mark.parametrize('fmt', ['pt', 'safetensors'])
def test_waveglow_converter_matches_jax(fmt, tmp_path):
    sd = nvidia_waveglow_state_dict(0, ** NARROW_WAVEGLOW)
    assert any(k.endswith('weight_g') for k in sd)
    if fmt == 'pt':
        path = str(tmp_path / 'waveglow.pt')
        torch.save({'state_dict': {'module.' + k: v for k, v in sd.items()}}, path)
    else:
        path = _safetensors(str(tmp_path / 'waveglow.safetensors'),
                            {k: v.numpy() for k, v in sd.items()})
    got_sd, want_sd = tts_checkpoints._load_state_dict(path), jax_checkpoints._load_state_dict(path)
    _assert_trees_equal(got_sd, want_sd)
    got_sd, want_sd = tts_checkpoints.remove_torch_weight_norm(got_sd), \
        jax_checkpoints.remove_torch_weight_norm(want_sd)
    _assert_trees_equal(got_sd, want_sd)
    assert tts_checkpoints.remove_torch_weight_norm(got_sd) is got_sd    # unnormed: unchanged
    _assert_trees_equal(tts_checkpoints.convert_nvidia_waveglow(got_sd),
                        jax_checkpoints.convert_nvidia_waveglow(want_sd))
    config = tts_checkpoints.waveglow_config_from_state_dict(got_sd)
    assert config == jax_checkpoints.waveglow_config_from_state_dict(want_sd)
    # the early-output schedule, from the 1x1 convs' channel counts
    assert (config['n_early_every'], config['n_early_size'], config['n_group']) == (2, 2, 8)
    assert config['wn_fused'] and config['wn_layers'] == 2
    _assert_trees_equal(tts_checkpoints.load_nvidia_waveglow(path),
                        jax_checkpoints.load_nvidia_waveglow(path))


# -- the imported task models ------------------------------------------------------------

@pytest.fixture(scope = 'module')
def imported(tmp_path_factory):
    """Narrow NVIDIA dicts, saved as ``.pt`` files, imported by each package
    into its own root: yields (port root, JAX root, port models, JAX models,
    the monkeypatch that holds the JAX package's root)."""
    ckpt = tmp_path_factory.mktemp('checkpoints')
    tacotron2_pt, waveglow_pt = str(ckpt / 'tacotron2.pt'), str(ckpt / 'waveglow.pt')
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               nvidia_tacotron2_state_dict(1, ** NARROW_TACOTRON2).items()}},
               tacotron2_pt)
    torch.save(nvidia_waveglow_state_dict(2, ** NARROW_WAVEGLOW), waveglow_pt)
    port_root = str(tmp_path_factory.mktemp('port_models'))
    jax_root = str(tmp_path_factory.mktemp('jax_models'))
    port = (Tacotron2.from_nvidia_pretrained(tacotron2_pt, root = port_root, device = 'cpu'),
            WaveGlow.from_nvidia_pretrained(waveglow_pt, root = port_root, device = 'cpu'))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', jax_root)
        reset_instances()
        jax_models = (JaxTacotron2.from_nvidia_pretrained(tacotron2_pt),
                      JaxWaveGlow.from_nvidia_pretrained(waveglow_pt))
        yield port_root, jax_root, port, jax_models, mp
        reset_instances()


def test_directories_are_the_jax_packages(imported):
    port_root, jax_root, (model, vocoder), _, mp = imported
    assert model.arch.hp.lsa_attention_kernel_size == 31 and model.arch.hp.vocab_size == 148
    for name in ('pretrained_tacotron2', 'waveglow'):
        for filename in JSON_FILES:
            path = os.path.join(jax_root, name, filename)
            assert os.path.exists(path) == os.path.exists(os.path.join(port_root, name, filename))
            if not os.path.exists(path):        # a vocoder has no tokenizer
                continue
            with open(os.path.join(port_root, name, filename)) as f:
                got = json.load(f)
            with open(path) as f:
                assert got == json.load(f), (name, filename)
    # each package loads the directory the other wrote
    for name in ('pretrained_tacotron2', 'waveglow'):
        loaded = get_pretrained(name, root = jax_root, device = 'cpu')
        own = model if name == 'pretrained_tacotron2' else vocoder
        assert type(loaded) is type(own)
        _assert_trees_equal({k: v.numpy() for k, v in port_flatten_tree(loaded.params).items()},
                            {k: v.numpy() for k, v in port_flatten_tree(own.params).items()})
        if name == 'pretrained_tacotron2':
            _assert_trees_equal({k: v.numpy() for k, v in port_flatten_tree(loaded.state).items()},
                                {k: v.numpy() for k, v in port_flatten_tree(own.state).items()})
    mp.setattr(saving, '_PRETRAINED_ROOT', port_root)
    reset_instances()
    try:
        for name, (_, jax_model) in zip(('pretrained_tacotron2', 'waveglow'),
                                        zip(imported[2], imported[3])):
            loaded = jax_get_pretrained(name)
            assert type(loaded).__name__ == type(jax_model).__name__
            _assert_trees_equal(flatten_tree(loaded.params), flatten_tree(jax_model.params))
            if loaded.state:
                _assert_trees_equal(flatten_tree(loaded.state), flatten_tree(jax_model.state))
    finally:
        mp.setattr(saving, '_PRETRAINED_ROOT', jax_root)
        reset_instances()


def test_decode_and_vocode_match_jax(imported):
    _, _, (model, vocoder), (jax_model, jax_vocoder), _ = imported
    tokens = model.encode_text(TEXT)
    np.testing.assert_array_equal(tokens, jax_model.encode_text(TEXT))
    kw = dict(max_length = 32, deterministic = True, early_stopping = False)
    ref = jax_model.compiled_infer(tokens, ** kw)
    out = model.compiled_infer(tokens, ** kw)
    for name in ('mel', 'decoder_output', 'stop_tokens', 'attention_weights'):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol = 1e-4, rtol = 0, err_msg = name)
    mel = out.mel.numpy()[:, :16]
    audio = vocoder.infer(mel, deterministic = True)
    ref_audio = np.asarray(jax_vocoder.infer(mel, deterministic = True))
    assert audio.shape == ref_audio.shape == (1, 16 * 256) and np.isfinite(ref_audio).all()
    np.testing.assert_allclose(audio, ref_audio, atol = 1e-4, rtol = 0)


def test_tts_answers_from_the_imported_models(imported):
    port_root, _, (model, vocoder), _, _ = imported
    kw = dict(deterministic = True, max_length = 2., save = False, display = False,
              vocoder_config = {'deterministic': True}, min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'))
    out = tts(TEXT, lang = 'en', root = port_root, device = 'cpu', ** kw)
    direct = model.infer(TEXT, vocoder = vocoder, ** kw)
    assert len(out) == 1 and out[0]['mel'][0].shape == direct['mel'][0].shape
    np.testing.assert_allclose(out[0]['mel'][0], direct['mel'][0], atol = 1e-6, rtol = 0)
    np.testing.assert_allclose(out[0]['audio'], direct['audio'], atol = 1e-6, rtol = 0)
    assert out[0]['audio'].shape == (out[0]['mel'][0].shape[0] * 256,)


# -- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_imported_tacotron2_decodes_on_k3(cuda_device, tmp_path):
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps
    model = Tacotron2.from_nvidia_pretrained(nvidia_tacotron2_state_dict(3, gate_bias = -4.),
                                             root = str(tmp_path), device = cuda_device)
    assert model.arch.supports_fused_decoder(1, 64)
    tokens = model.encode_text('The quick brown fox jumps over the lazy dog.')
    kw = dict(max_length = 256, deterministic = True, early_stopping = False)
    decoder_steps.launches = 0
    fused = model.compiled_infer(tokens, ** kw)                  # the default route on a card
    assert decoder_steps.launches == 4
    plain = model.compiled_infer(tokens, use_fused_decoder = False, ** kw)
    for name in ('mel', 'decoder_output', 'stop_tokens', 'attention_weights'):
        a, b = getattr(fused, name), getattr(plain, name)
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
    assert torch.equal(fused.lengths, plain.lengths)
