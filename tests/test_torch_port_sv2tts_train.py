"""SV2TTS Tacotron-2 training: the speaker embedding as the second input,
the port against the JAX package.

A tiny `SV2TTSTacotron2` (``TINY_TACO`` widths, an 8-wide speaker at
'end', drop rates 0) made by the JAX package in a temporary root and loaded
by name in the port; rows carry their speaker's ``embedding``:

  - `prepare_data`, `collate` and the trainer's `bucket_pad`: tokens,
    embeddings, lengths and gates equal, mels within 5e-4 absolute (the
    tolerance of ``test_torch_port_stft.py``);
  - two train steps through `make_train_step` (the 4-input branch of
    `model_forward`): losses and parameters within 1e-4 of their scale,
    the zero-gradient conv biases and the running means they shift by the
    bound of Adam's steps (``test_torch_port_tacotron2_train.py``).
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import SV2TTSTacotron2 as JaxTask
from text_to_speech_tpu.train import losses as jlosses
from text_to_speech_tpu.train import trainer as jtrainer
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer

from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2 as Task
from text_to_speech_tpu_torch.train import trainer
from text_to_speech_tpu_torch.train.losses import TacotronLoss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import flatten_tree, tree_to_jax

TASK = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
            prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
            lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
            postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
            max_decoder_steps = 16, encoder_drop_rate = 0., prenet_drop_rate = 0.,
            postnet_drop_rate = 0.)


def _rows():
    rng = np.random.RandomState(0)
    return [{'text': ['hello there', 'this is a test', 'synthetic data'][i % 3],
             'audio': (rng.randn(2000 + 700 * (i % 3)) * 0.1).astype(np.float32),
             'rate': 22050, 'embedding': rng.randn(8).astype(np.float32)} for i in range(4)]


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('sv2tts_train'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        jmodel = JaxTask(lang = 'en', name = 'sv2tts_train_tiny', embedding_dim = 8, ** TASK)
        model = Task.from_pretrained('sv2tts_train_tiny', root = root, device = 'cpu')
        yield jmodel, model
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def test_data_methods_match_jax(models):
    jmodel, model = models
    items = [model.prepare_data(row) for row in _rows()]
    ref_items = [jmodel.prepare_data(row) for row in _rows()]
    batch = trainer.bucket_pad(model.collate(items), model, token_multiple = 8,
                               frame_multiple = 16)
    ref = jtrainer.bucket_pad(jmodel.collate(ref_items), jmodel, token_multiple = 8,
                              frame_multiple = 16)
    (tok, emb, mel_in, lengths), (mel_out, gate) = batch
    (rtok, remb, rmel_in, rlengths), (rmel_out, rgate) = ref
    for o, r in ((tok, rtok), (emb, remb), (lengths, rlengths), (gate, rgate)):
        np.testing.assert_array_equal(o, r)
    assert emb.shape == (4, 8) and mel_out.shape == rmel_out.shape
    np.testing.assert_allclose(mel_in, rmel_in, rtol = 0, atol = 5e-4)
    np.testing.assert_allclose(mel_out, rmel_out, rtol = 0, atol = 5e-4)


def test_two_train_steps_match_jax(models):
    jmodel, model = models
    inputs, targets = jtrainer.bucket_pad(
        jmodel.collate([jmodel.prepare_data(row) for row in _rows()]), jmodel,
        token_multiple = 8, frame_multiple = 16)
    params = trainer._trainable(jax.tree_util.tree_map(torch.clone, model.params))
    state = model.state
    tx = get_optimizer('adam', lr = 1e-3)
    opt_state = tx.init(params)
    step = trainer.make_train_step(model, TacotronLoss(), tx)
    jtx = jax_get_optimizer('adam', lr = 1e-3)
    jparams, jstate = (jax.tree_util.tree_map(jnp.array, t) for t in (jmodel.params, jmodel.state))
    jopt = jtx.init(jparams)
    jstep = jtrainer.make_train_step(jmodel, jlosses.TacotronLoss(), jtx)
    for _ in range(2):
        params, state, opt_state, m = step(params, state, opt_state, None,
                                           trainer._to_device(inputs, 'cpu'),
                                           trainer._to_device(targets, 'cpu'))
        jparams, jstate, jopt, jm = jstep(jparams, jstate, jopt, jax.random.PRNGKey(0),
                                          inputs, targets)
        assert abs(float(m['loss']) - float(jm['loss'])) <= 1e-4 * abs(float(jm['loss']))
    flat = flatten_tree(tree_to_jax(params))
    flat.update({'state/' + k: v for k, v in flatten_tree(tree_to_jax(state)).items()})
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
    flat_ref.update({'state/' + k: np.asarray(v) for k, v in flatten_tree(jstate).items()})
    start = flatten_tree(jax.tree_util.tree_map(np.asarray, jmodel.params))
    assert sorted(flat) == sorted(flat_ref)
    for key in flat_ref:
        diff = np.abs(flat[key] - flat_ref[key]).max()
        scale = float(np.abs(flat_ref[key]).max())
        if key.endswith('/conv/bias'):
            for moved in (flat[key], flat_ref[key]):
                assert np.abs(moved - start[key]).max() <= 2e-3 * (1 + 1e-4), key
        elif key.endswith('/moving_mean'):
            assert diff <= 1e-4 * scale + 0.1 * 2e-3, key
        else:
            assert diff <= 1e-4 * scale, key
