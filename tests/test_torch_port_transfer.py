"""Cloning a voice from a single-speaker checkpoint: the port's
``from_pretrained(name, pretrained_name)`` against the JAX package's.

A tiny Tacotron-2 made by the JAX package in a temporary root (drop rates
0) is the source.  The JAX package's ``SV2TTSTacotron2(name = ...,
pretrained_name = source)`` and the port's
``SV2TTSTacotron2.from_pretrained(name, source)`` build an 8-wide speaker
at 'end' on it:

  - `params` and `state` equal to the bit (every leaf matches by name, so
    neither package's fresh init survives: the widened rows are zeros);
  - every source leaf arrives, exact in its block, and the widened rows are
    zero;
  - the clone's plain decode equals the source's within 1e-5 absolute, for
    any speaker: the zero rows hide it;
  - a saved name is loaded and its ``pretrained_name`` ignored; the
    two-argument form refuses a family without `create`.
"""

import numpy as np
import pytest

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import SV2TTSTacotron2 as JaxSV2TTS, Tacotron2 as JaxTacotron2

from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2, Tacotron2, WaveGlow
from text_to_speech_tpu_torch.weights import flatten_tree

TINY = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
            prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
            lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
            postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
            max_decoder_steps = 16, encoder_drop_rate = 0., prenet_drop_rate = 0.,
            postnet_drop_rate = 0.)
SPK = 8


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('transfer'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        JaxTacotron2(lang = 'en', name = 'single', ** TINY)
        jclone = JaxSV2TTS(lang = 'en', name = 'clone_jax', pretrained_name = 'single',
                           embedding_dim = SPK, ** TINY)
        clone = SV2TTSTacotron2.from_pretrained('clone', 'single', lang = 'en', root = root,
                                                device = 'cpu', embedding_dim = SPK, ** TINY)
        source = Tacotron2.from_pretrained('single', root = root, device = 'cpu')
        yield root, jclone, clone, source
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def test_transferred_trees_equal_jax(models):
    _, jclone, clone, _ = models
    trees = clone.jax_trees()
    for name, ref in (('params', jclone.params), ('state', jclone.state)):
        out, ref = _flat(trees[name]), _flat(ref)
        assert sorted(out) == sorted(ref), name
        for key in ref:
            np.testing.assert_array_equal(out[key], ref[key], err_msg = key)


def test_every_source_leaf_arrives_and_the_widened_rows_are_zero(models):
    _, _, clone, source = models
    assert clone.arch.encoder_output_dim == 8 + SPK
    out, src = _flat(clone.jax_trees()['params']), _flat(source.jax_trees()['params'])
    widened = []
    for key, value in src.items():
        block = tuple(slice(0, n) for n in value.shape)
        np.testing.assert_array_equal(out[key][block], value, err_msg = key)
        if out[key].shape != value.shape:
            widened.append(key)
            rest = out[key].copy()
            rest[block] = 0.
            assert not rest.any(), key
    assert sorted(widened) == sorted([
        'decoder/attention/memory/kernel', 'decoder/attention_rnn/kernel',
        'decoder/decoder_rnn/cell_0/kernel', 'decoder/gate_layer/kernel',
        'decoder/linear_projection/kernel'])
    out_state, src_state = _flat(clone.jax_trees()['state']), _flat(source.jax_trees()['state'])
    assert sorted(out_state) == sorted(src_state)
    for key in src_state:
        np.testing.assert_array_equal(out_state[key], src_state[key], err_msg = key)


def test_the_clone_decodes_as_its_source(models):
    _, _, clone, source = models
    tokens = source.encode_text('hello there')
    kw = dict(max_length = 16, deterministic = True, early_stopping = False,
              use_fused_decoder = False)
    ref = source.compiled_infer(tokens, ** kw)
    for seed in (0, 1):
        spk = np.random.default_rng(seed).standard_normal(SPK).astype(np.float32)
        out = clone.compiled_infer(tokens, embeddings = spk, ** kw)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), r.numpy(), rtol = 0, atol = 1e-5)


def test_a_saved_name_is_loaded_and_other_families_refuse(models):
    root, _, clone, _ = models
    again = SV2TTSTacotron2.from_pretrained('clone', 'no_such_model', root = root,
                                            device = 'cpu')
    assert again.embedding_dim == SPK
    for a, b in zip(flatten_tree(again.params).values(), flatten_tree(clone.params).values()):
        assert np.array_equal(a.numpy(), b.numpy())
    with pytest.raises(NotImplementedError, match = 'create'):
        WaveGlow.from_pretrained('new_vocoder', 'single', root = root, device = 'cpu')
