"""GE2E training of the speaker encoder: the port against the JAX package.

A tiny encoder (two strided convs of 8 filters, a 16-wide embedding) with
weights from a numpy seed handed to both packages, drop rate 0 with
``train=True`` (batch norms on the batch's statistics over the valid
frames).  Tolerances:

  - the train-mode forward on a padded batch with lengths: embeddings and
    the new batch-norm state within 1e-5 of their scale;
  - the gradients of the mean `GE2ELoss` (4 speakers × 3 utterances,
    the scale ``w`` and offset ``b`` learned leaves) against
    `jax.value_and_grad`: within 1e-4 of each leaf's largest gradient.  The
    conv biases before a training batch norm (the norm takes the batch mean
    out) and the offset ``b`` (it shifts every similarity of a row alike,
    which the softmax takes out) have a zero gradient, float noise on both
    sides: within 1e-4 of the largest gradient of all leaves;
  - three Adam steps (lr 1e-3) through `make_train_step` on one GE2E batch
    (4 speakers × 4 utterances): losses, parameters and batch-norm state
    within 1e-4 of their scale.  The zero-gradient leaves (the conv biases,
    ``b``) are held by the most Adam can move them, 3 × lr, on both sides,
    and the moving means, which carry those biases, by momentum × 6e-3
    beyond 1e-4 of their scale;
  - `collate_ge2e` and `GE2EDataset`'s batches (two epochs, the same seed):
    equal, row for row;
  - an encoder made by the port (`SpeakerEncoder.create`) and fitted for
    two epochs (4 speakers × 4 utterances of seeded audio), its directory
    reloaded by name in the JAX package: the same weights, the scale ``w``
    moved, and the JAX eval loss within 1e-5 relative of the port's.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.encoder import SpeakerEncoder as JaxTask
from text_to_speech_tpu.models.encoder_arch import AudioEncoder as JaxArch
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.train import datasets as jdatasets
from text_to_speech_tpu.train import losses as jlosses
from text_to_speech_tpu.train import trainer as jtrainer
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer

from text_to_speech_tpu_torch.init import init_audio_encoder
from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder as Task
from text_to_speech_tpu_torch.models.encoder_arch import AudioEncoder as Arch
from text_to_speech_tpu_torch.train import datasets, trainer
from text_to_speech_tpu_torch.train.losses import GE2ELoss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import (
    audio_encoder_from_jax, audio_encoder_to_jax, flatten_tree)

TINY = dict(embedding_dim = 16, filters = (8, 8), strides = (2, 2), kernel_size = 3,
            drop_rate = 0.)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, '{}: {} > {} x {}'.format(what, err, tol, scale)


def _flat_port(params, state):
    p, s = audio_encoder_to_jax(params, state)
    return {** flatten_tree(p), ** {'state/' + k: v for k, v in flatten_tree(s).items()}}


def _flat_jax(params, state):
    return {** flatten_tree(jax.tree_util.tree_map(np.asarray, params)),
            ** {'state/' + k: np.asarray(v) for k, v in flatten_tree(state).items()}}


@pytest.fixture(scope = 'module')
def weights():
    arch = Arch(n_mel_channels = 8, ** TINY)
    params, state = init_audio_encoder(arch.hp, seed = 0, statistics = True)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((12, 24, 8)).astype(np.float32) - 4.
    lengths = np.array([24, 17, 9, 24, 20, 13, 24, 24, 5, 18, 24, 11], np.int32)
    return arch, params, state, mel, lengths


def test_train_forward_matches_jax(weights):
    arch, params, state, mel, lengths = weights
    ref, ref_state = JaxArch(n_mel_channels = 8, ** TINY)(
        _jax(params), _jax(state), jnp.asarray(mel), lengths = jnp.asarray(lengths),
        train = True, rng = jax.random.PRNGKey(0))
    p, s = audio_encoder_from_jax(params, state)
    out, new_state = arch.forward(p, s, torch.from_numpy(mel), lengths = torch.from_numpy(lengths),
                                  train = True, generator = torch.Generator().manual_seed(0))
    _close(out, ref, 1e-5, 'embeddings')
    flat, flat_ref = _flat_port(p, new_state), _flat_jax(params, ref_state)
    for key in flat_ref:
        if key.startswith('state/'):
            _close(flat[key], flat_ref[key], 1e-5, key)


def test_ge2e_gradients_match_jax(weights):
    arch, params, state, mel, lengths = weights
    loss_fn = jlosses.GE2ELoss()

    def jax_loss(p):
        emb, _ = JaxArch(n_mel_channels = 8, ** TINY)(
            p, _jax(state), jnp.asarray(mel), lengths = jnp.asarray(lengths), train = True,
            rng = jax.random.PRNGKey(0))
        out = loss_fn(None, (emb.reshape(4, 3, -1), p['ge2e']['w'], p['ge2e']['b']))
        return jnp.mean(out['loss'])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(_jax(params))
    p, s = audio_encoder_from_jax(params, state)
    p = trainer._trainable(p)
    emb, _ = arch.forward(p, s, torch.from_numpy(mel), lengths = torch.from_numpy(lengths),
                          train = True)
    loss = torch.mean(GE2ELoss()(None, (emb.reshape(4, 3, -1), p['ge2e']['w'],
                                        p['ge2e']['b']))['loss'])
    loss.backward()
    _close(loss.detach(), ref_loss, 1e-5, 'loss')
    grads = flatten_tree(audio_encoder_to_jax(
        jax.tree_util.tree_map(lambda t: t.grad, p, is_leaf = torch.is_tensor), s)[0])
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert sorted(grads) == sorted(flat_ref)
    assert abs(float(flat_ref['ge2e/w'])) > 1e-3
    largest = max(float(np.abs(g).max()) for g in flat_ref.values())
    for key in flat_ref:
        if key.endswith('/conv/bias') or key == 'ge2e/b':
            assert np.abs(grads[key] - flat_ref[key]).max() <= 1e-4 * largest, key
        else:
            _close(grads[key], flat_ref[key], 1e-4, key)


def _clip(seconds, f0, seed, rate = 16000):
    t = np.arange(int(seconds * rate)) / rate
    noise = np.random.default_rng(seed).standard_normal(len(t))
    return (0.5 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise).astype(np.float32)


def _rows():
    return [{'speaker': 'spk{}'.format(s), 'audio': _clip(0.25 + 0.05 * u, 120. + 60. * s,
                                                          seed = 4 * s + u), 'rate': 16000}
            for s in range(4) for u in range(4)]


def test_ge2e_dataset_batches_equal_jax():
    rows = [{'speaker': s % 5, 'id': i} for i, s in enumerate(range(23))]
    kw = dict(n_speakers = 2, n_utterances = 3, seed = 7)
    ds, ref = datasets.GE2EDataset(rows, ** kw), jdatasets.GE2EDataset(rows, ** kw)
    assert len(ds) == len(ref) == 2
    for _ in range(2):
        assert [[[r['id'] for r in g] for g in b] for b in ds] \
            == [[[r['id'] for r in g] for g in b] for b in ref]
    with pytest.raises(ValueError):
        datasets.GE2EDataset(rows, n_speakers = 6, n_utterances = 3)


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('encoder_train'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        jmodel = JaxTask(name = 'encoder_train_tiny', ** TINY)
        model = Task.from_pretrained('encoder_train_tiny', root = root, device = 'cpu')
        yield root, jmodel, model
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def test_collate_ge2e_equals_jax(models):
    _, jmodel, model = models
    assert model.max_mel_frames == jmodel.max_mel_frames
    batch = [[model.prepare_data(r) for r in _rows()[4 * s: 4 * s + 4]] for s in range(4)]
    (mels, lengths), targets = model.collate_ge2e(batch)
    (ref_mels, ref_lengths), ref_targets = jmodel.collate_ge2e(batch)
    assert targets is ref_targets is None
    np.testing.assert_array_equal(lengths, ref_lengths)
    np.testing.assert_array_equal(mels, ref_mels)


def _jax_batch(jmodel):
    batch = [[jmodel.prepare_data(r) for r in _rows()[4 * s: 4 * s + 4]] for s in range(4)]
    return jmodel.collate_ge2e(batch)


def test_three_adam_steps_match_jax(models):
    _, jmodel, model = models
    jmodel.ge2e_shape = model.ge2e_shape = (4, 4)
    inputs, _ = _jax_batch(jmodel)

    # copies: the port's step updates its leaves in place
    params = trainer._trainable(jax.tree_util.tree_map(torch.clone, model.params))
    state = model.state
    tx = get_optimizer('adam', lr = 1e-3)
    opt_state = tx.init(params)
    step = trainer.make_train_step(model, GE2ELoss(), tx)
    port_inputs = trainer._to_device(inputs, 'cpu')
    losses = []
    for _ in range(3):
        params, state, opt_state, metrics = step(params, state, opt_state,
                                                 torch.Generator().manual_seed(0),
                                                 port_inputs, None)
        losses.append(float(metrics['loss']))

    jtx = jax_get_optimizer('adam', lr = 1e-3)
    # copies: the JAX step donates its arguments
    ref_params, ref_state = (jax.tree_util.tree_map(jnp.array, t)
                             for t in (jmodel.params, jmodel.state))
    ref_opt = jtx.init(ref_params)
    jstep = jtrainer.make_train_step(jmodel, jlosses.GE2ELoss(), jtx)
    ref_losses = []
    for _ in range(3):
        ref_params, ref_state, ref_opt, metrics = jstep(
            ref_params, ref_state, ref_opt, jax.random.PRNGKey(0), inputs, None)
        ref_losses.append(float(metrics['loss']))

    _close(losses, ref_losses, 1e-4, 'losses')
    assert losses[-1] < losses[0]
    flat, flat_ref = _flat_port(params, state), _flat_jax(ref_params, ref_state)
    assert sorted(flat) == sorted(flat_ref)
    start = _flat_jax(jmodel.params, jmodel.state)
    momentum = model.arch.hp.momentum
    for key in flat_ref:
        if key.endswith('/conv/bias') or key == 'ge2e/b':
            for moved in (flat[key], flat_ref[key]):
                assert np.abs(moved - start[key]).max() <= 3e-3 * (1 + 1e-4), key
        elif key.endswith('/moving_mean'):
            scale = float(np.abs(flat_ref[key]).max())
            assert np.abs(flat[key] - flat_ref[key]).max() <= 1e-4 * scale + momentum * 6e-3, key
        else:
            _close(flat[key], flat_ref[key], 1e-4, key)


def test_fit_round_trip_loads_in_jax(models):
    root, _, _ = models
    model = Task.create(name = 'encoder_port', root = root, device = 'cpu', seed = 3, ** TINY)
    # copies: the port's steps update the weights in place
    start = {k: np.array(v) for k, v in
             flatten_tree(audio_encoder_to_jax(model.params, model.state)[0]).items()}
    history = model.fit(_rows(), n_speakers = 4, n_utterances = 4, epochs = 2, device = 'cpu')
    assert history.epochs == 2
    reset_instances()
    reloaded = JaxTask(name = 'encoder_port')
    assert reloaded.epochs == 2
    flat = _flat_port(model.params, model.state)
    for key, value in _flat_jax(reloaded.params, reloaded.state).items():
        np.testing.assert_array_equal(flat[key], value, err_msg = key)
    assert flat['ge2e/w'] != start['ge2e/w']
    reloaded.ge2e_shape = model.ge2e_shape = (4, 4)
    inputs, targets = _jax_batch(reloaded)
    ref = jtrainer.make_eval_step(reloaded, jlosses.GE2ELoss())(
        reloaded.params, reloaded.state, jax.random.PRNGKey(0), inputs, targets)
    out = trainer.make_eval_step(model, GE2ELoss())(
        model.params, model.state, None, trainer._to_device(inputs, 'cpu'), None)
    _close(float(out['loss']), float(ref['loss']), 1e-5, 'eval loss')
