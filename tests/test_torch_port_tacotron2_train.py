"""Tacotron-2 and SV2TTS teacher forcing: the port against the JAX package.

Tiny widths (the JAX ``tests/test_fit.py`` ``TINY_TACO`` sizes), weights
from a numpy seed handed to both packages, every drop rate 0 with
``train=True`` (batch norms on the batch's statistics; the two packages'
dropout bits differ by design, so dropout is held by its keep rate and by
its determinism under a seeded generator).  Tolerances, float32:

  - training batch norm (masked and not): the output and the moved running
    statistics within 1e-5 of their scale;
  - the teacher-forced `__call__` on a padded batch with `mel_lengths`, at
    r = 1 and r = 2 and with an SV2TTS speaker at 'end' and 'prenet':
    decoder output, postnet mel, gates and the new batch-norm state within
    1e-5 of each one's scale;
  - the gradients of the mean `TacotronLoss` against `jax.value_and_grad`:
    within 1e-4 of each leaf's largest gradient; the conv biases before a
    training batch norm, whose gradient is 0 (the norm takes the batch's
    mean out) and float noise on both sides, within 1e-4 of the largest
    gradient of all leaves;
  - the task model (made by the JAX package, loaded by name in the port):
    `prepare_data`, `collate`, `filter_data` and the trainer's `bucket_pad`
    at r = 1 and r = 2: tokens, lengths, gates and shapes equal, mels at
    the tolerance of ``test_torch_port_stft.py`` (5e-4 absolute; near-silent
    bins are the largest differences);
  - three Adam steps through `make_train_step`: losses and parameters
    within 1e-4 of their scale.  The conv biases before a batch norm take
    Adam's sign-like steps on their noise gradients: each side moves them
    at most 3 × the learning rate, which is all that is held there, and the
    running means they shift are held within 1e-4 of their scale plus what
    the two sides' bias gap can move them (momentum 0.1 × (2 + 4) × lr: the
    forwards of steps 2 and 3 see biases 1 and 2 steps apart); under ``mixed_bfloat16`` (both sides round
    operands to bfloat16 at other places, through a recurrence of 6 steps)
    the loss within 2e-2 relative;
  - a model made by the port (`Tacotron2.create`) and fitted for two
    epochs, its directory reloaded by name in the JAX package: the same
    weights, and the JAX eval loss within 1e-5 relative of the port's.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxArch
from text_to_speech_tpu.models.tts import Tacotron2 as JaxTask
from text_to_speech_tpu.nn import layers as jnn
from text_to_speech_tpu.train import losses as jlosses
from text_to_speech_tpu.train import trainer as jtrainer
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer

from text_to_speech_tpu_torch.init import init_tacotron2
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2 as Arch
from text_to_speech_tpu_torch.models.tts import Tacotron2 as Task
from text_to_speech_tpu_torch.nn import layers as nn
from text_to_speech_tpu_torch.train import trainer
from text_to_speech_tpu_torch.train.losses import TacotronLoss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import flatten_tree, tacotron2_from_jax, tree_to_jax

TINY_TACO = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
                 prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
                 lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                 postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                 max_decoder_steps = 16)
NO_DROP = dict(encoder_drop_rate = 0., prenet_drop_rate = 0., postnet_drop_rate = 0.)
ARCH = dict(vocab_size = 24, n_mel_channels = 8, ** TINY_TACO, ** NO_DROP)
CASES = {
    'r1': {},
    'r2': {'n_frames_per_step': 2},
    'end': {'speaker_embedding_dim': 4, 'speaker_concat_pos': 'end'},
    'prenet': {'speaker_embedding_dim': 4, 'speaker_concat_pos': 'prenet'},
}
STEPS = 6


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, '{}: {} > {} x {}'.format(what, err, tol, scale)


def _batch(case, seed = 0):
    """Tokens (2, 8) with a padded row, previous frames (2, 6, 8) with
    `mel_lengths` (6, 4), frame-rate targets, and a speaker embedding."""
    rng = np.random.default_rng(seed)
    r = CASES[case].get('n_frames_per_step', 1)
    tokens = rng.integers(1, 24, (2, 8))
    tokens[1, 5:] = 0
    lengths = np.array([STEPS, 4], np.int32)
    mel_in = rng.standard_normal((2, STEPS, 8)).astype(np.float32)
    mel_in[1, 4:] = 0.
    mel_out = rng.standard_normal((2, STEPS * r, 8)).astype(np.float32)
    gate = np.zeros((2, STEPS * r), np.float32)
    gate[0, -1] = 1.
    gate[1, 4 * r - 1:] = 1.
    spk = rng.standard_normal((2, 4)).astype(np.float32)
    return tokens, mel_in, lengths, (mel_out, gate), spk


def _setup(case):
    config = {** ARCH, ** CASES[case]}
    arch = Arch(** config)
    params, state = init_tacotron2(arch.hp, seed = 1)
    return config, arch, params, state


def _port_forward(arch, params, state, tokens, mel_in, lengths, spk, grad_params = None):
    p, s = tacotron2_from_jax(params, state)
    if grad_params is not None:
        p = trainer._trainable(p)
        grad_params.append(p)
    return arch(p, s, torch.from_numpy(tokens).long(), torch.from_numpy(mel_in),
                mel_lengths = torch.from_numpy(lengths),
                speaker_embedding = torch.from_numpy(spk) if arch.spk_dim else None,
                train = True, generator = torch.Generator().manual_seed(0))


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32) * 3. + 1.
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], bool)
    params = {'gamma': rng.uniform(.5, 1.5, 6).astype(np.float32),
              'beta': rng.standard_normal(6).astype(np.float32)}
    state = {'moving_mean': rng.standard_normal(6).astype(np.float32),
             'moving_var': rng.uniform(.5, 2., 6).astype(np.float32)}
    port_p = {'weight': torch.from_numpy(params['gamma']), 'bias': torch.from_numpy(params['beta'])}
    port_s = {'running_mean': torch.from_numpy(state['moving_mean']),
              'running_var': torch.from_numpy(state['moving_var'])}
    for m in (None, mask):
        ref, ref_state = jnn.batch_norm(_jax(params), _jax(state), jnp.asarray(x), train = True,
                                        momentum = 0.1, epsilon = 1e-5,
                                        mask = None if m is None else jnp.asarray(m))
        out, new_state = nn.batch_norm_train(port_p, port_s, torch.from_numpy(x), momentum = 0.1,
                                             epsilon = 1e-5,
                                             mask = None if m is None else torch.from_numpy(m))
        _close(out, ref, 1e-5, 'y')
        _close(new_state['running_mean'], ref_state['moving_mean'], 1e-5, 'mean')
        # the biased variance moves the running one, as in the JAX package
        _close(new_state['running_var'], ref_state['moving_var'], 1e-5, 'var')


def test_dropout_keep_rate_and_determinism():
    x = torch.ones(200, 500)
    a = nn.dropout(x, 0.3, generator = torch.Generator().manual_seed(5))
    b = nn.dropout(x, 0.3, generator = torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))


@pytest.mark.parametrize('case', sorted(CASES))
def test_teacher_forced_forward_matches_jax(case):
    config, arch, params, state = _setup(case)
    tokens, mel_in, lengths, _, spk = _batch(case)
    fn = jax.jit(lambda p, s, t, m, l, e: JaxArch(** config)(
        p, s, t, m, mel_lengths = l, speaker_embedding = e, train = True,
        rng = jax.random.PRNGKey(0)))
    (ref, ref_state) = fn(_jax(params), _jax(state), jnp.asarray(tokens), jnp.asarray(mel_in),
                          jnp.asarray(lengths), jnp.asarray(spk) if arch.spk_dim else None)
    with torch.no_grad():
        out, new_state = _port_forward(arch, params, state, tokens, mel_in, lengths, spk)
    r = config.get('n_frames_per_step', 1)
    assert out[0].shape == (2, STEPS * r, 8) and out[2].shape == (2, STEPS * r)
    for name, o, e in zip(('decoder', 'postnet', 'gates'), out, ref):
        _close(o, e, 1e-5, name)
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state))
    flat_out = flatten_tree(tree_to_jax(new_state))
    assert sorted(flat_out) == sorted(flat_ref)
    for key in flat_ref:
        _close(flat_out[key], flat_ref[key], 1e-5, key)


@pytest.mark.parametrize('case', ['r1', 'r2', 'end'])
def test_gradients_match_jax(case):
    config, arch, params, state = _setup(case)
    tokens, mel_in, lengths, targets, spk = _batch(case)
    loss_fn = jlosses.TacotronLoss()

    def jax_loss(p):
        preds, _ = JaxArch(** config)(p, _jax(state), jnp.asarray(tokens), jnp.asarray(mel_in),
                                      mel_lengths = jnp.asarray(lengths),
                                      speaker_embedding = jnp.asarray(spk) if arch.spk_dim
                                      else None, train = True, rng = jax.random.PRNGKey(0))
        return jnp.mean(loss_fn(_jax(targets), preds)['loss'])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(_jax(params))
    leaves = []
    preds, _ = _port_forward(arch, params, state, tokens, mel_in, lengths, spk, leaves)
    loss = torch.mean(TacotronLoss()(tuple(torch.from_numpy(t) for t in targets), preds)['loss'])
    loss.backward()
    _close(loss.detach(), ref_loss, 1e-5, 'loss')
    grads = flatten_tree(tree_to_jax(jax.tree_util.tree_map(
        lambda t: t.grad, leaves[0], is_leaf = torch.is_tensor)))
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert sorted(grads) == sorted(flat_ref)
    largest = max(float(np.abs(g).max()) for g in flat_ref.values())
    for key in flat_ref:
        if key.endswith('/conv/bias'):
            assert np.abs(grads[key] - flat_ref[key]).max() <= 1e-4 * largest, key
        else:
            _close(grads[key], flat_ref[key], 1e-4, key)


# -- the task model ---------------------------------------------------------------

TASK = dict(TINY_TACO, ** NO_DROP)


def _rows(n = 4, rate = 22050):
    rng = np.random.RandomState(0)
    return [{'text': ['hello there', 'this is a test', 'synthetic data'][i % 3],
             'audio': (rng.randn(2000 + 700 * (i % 3)) * 0.1).astype(np.float32),
             'rate': rate} for i in range(n)]


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    """The JAX package's task model, made and saved in a temporary root, and
    the port's, loaded from it by name."""
    root = str(tmp_path_factory.mktemp('taco_train'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        jmodel = JaxTask(lang = 'en', name = 'taco_train', ** TASK)
        model = Task.from_pretrained('taco_train', root = root, device = 'cpu')
        yield root, jmodel, model
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def _mels_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol = 0, atol = 5e-4)


@pytest.mark.parametrize('r', [1, 2])
def test_data_methods_match_jax(models, monkeypatch, r):
    _, jmodel, model = models
    if r > 1:
        monkeypatch.setattr(jmodel, 'arch', JaxArch(** {** jmodel.arch.hp.get_config(),
                                                       'n_frames_per_step': r}))
        monkeypatch.setattr(model, 'arch', Arch(** {** model.arch.hp.get_config(),
                                                   'n_frames_per_step': r}))
    assert model.get_padding_values() == jmodel.get_padding_values()
    items, ref_items = [], []
    for row in _rows():
        (tok, mel_in, steps), (mel_out, gate) = model.prepare_data(row)
        (rtok, rmel_in, rsteps), (rmel_out, rgate) = jmodel.prepare_data(row)
        np.testing.assert_array_equal(tok, rtok)
        assert steps == rsteps and mel_in.shape == rmel_in.shape
        np.testing.assert_array_equal(gate, rgate)
        _mels_close(mel_in, rmel_in)
        _mels_close(mel_out, rmel_out)
        assert model.filter_data((tok, mel_in, steps), (mel_out, gate)) \
            == jmodel.filter_data((rtok, rmel_in, rsteps), (rmel_out, rgate))
        items.append(((tok, mel_in, steps), (mel_out, gate)))
        ref_items.append(((rtok, rmel_in, rsteps), (rmel_out, rgate)))
    model.max_output_length = jmodel.max_output_length = 20 * r
    assert [model.filter_data(* i) for i in items] == [jmodel.filter_data(* i) for i in ref_items]
    batch = trainer.bucket_pad(model.collate(items), model, token_multiple = 8,
                               frame_multiple = 16)
    ref = jtrainer.bucket_pad(jmodel.collate(ref_items), jmodel, token_multiple = 8,
                              frame_multiple = 16)
    (tok, mel_in, lengths), (mel_out, gate) = batch
    (rtok, rmel_in, rlengths), (rmel_out, rgate) = ref
    np.testing.assert_array_equal(tok, rtok)
    np.testing.assert_array_equal(lengths, rlengths)
    np.testing.assert_array_equal(gate, rgate)
    assert mel_out.shape == rmel_out.shape == (4, mel_in.shape[1] * r, 80)
    _mels_close(mel_in, rmel_in)
    _mels_close(mel_out, rmel_out)


def _jax_batch(jmodel):
    items = [jmodel.prepare_data(row) for row in _rows()]
    return jtrainer.bucket_pad(jmodel.collate(items), jmodel, token_multiple = 8,
                               frame_multiple = 16)


def _port_steps(model, batch, n, precision = None):
    # copies: the port's step updates its leaves in place
    params = trainer._trainable(jax.tree_util.tree_map(torch.clone, model.params))
    state = model.state
    tx = get_optimizer('adam', lr = 1e-3)
    opt_state = tx.init(params)
    step = trainer.make_train_step(model, TacotronLoss(), tx, precision = precision)
    inputs, targets = trainer._to_device(batch[0], 'cpu'), trainer._to_device(batch[1], 'cpu')
    losses = []
    for _ in range(n):
        params, state, opt_state, metrics = step(params, state, opt_state,
                                                 torch.Generator().manual_seed(0),
                                                 inputs, targets)
        losses.append(float(metrics['loss']))
    return losses, params, state


def _jax_steps(jmodel, batch, n, precision = None):
    tx = jax_get_optimizer('adam', lr = 1e-3)
    # copies: the JAX step donates its arguments
    params, state = (jax.tree_util.tree_map(jnp.array, t) for t in (jmodel.params, jmodel.state))
    opt_state = tx.init(params)
    step = jtrainer.make_train_step(jmodel, jlosses.TacotronLoss(), tx, precision = precision)
    losses = []
    for _ in range(n):
        params, state, opt_state, metrics = step(params, state, opt_state,
                                                 jax.random.PRNGKey(0), batch[0], batch[1])
        losses.append(float(metrics['loss']))
    return losses, params, state


def test_three_adam_steps_match_jax(models):
    _, jmodel, model = models
    batch = _jax_batch(jmodel)
    losses, params, state = _port_steps(model, batch, 3)
    ref_losses, ref_params, ref_state = _jax_steps(jmodel, batch, 3)
    _close(losses, ref_losses, 1e-4, 'losses')
    assert losses[-1] < losses[0]
    flat = flatten_tree(tree_to_jax(params))
    flat.update({'state/' + k: v for k, v in flatten_tree(tree_to_jax(state)).items()})
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_params))
    flat_ref.update({'state/' + k: np.asarray(v) for k, v in flatten_tree(ref_state).items()})
    assert sorted(flat) == sorted(flat_ref)
    start = flatten_tree(jax.tree_util.tree_map(np.asarray, jmodel.params))
    for key in flat_ref:
        if key.endswith('/conv/bias'):
            for moved in (flat[key], flat_ref[key]):
                assert np.abs(moved - start[key]).max() <= 3e-3 * (1 + 1e-4), key
        elif key.endswith('/moving_mean'):
            scale = float(np.abs(flat_ref[key]).max())
            assert np.abs(flat[key] - flat_ref[key]).max() <= 1e-4 * scale + 0.1 * 6e-3, key
        else:
            _close(flat[key], flat_ref[key], 1e-4, key)


def test_mixed_bfloat16_step_matches_jax(models):
    _, jmodel, model = models
    batch = _jax_batch(jmodel)
    losses, params, _ = _port_steps(model, batch, 1, precision = 'mixed_bfloat16')
    ref_losses, _, _ = _jax_steps(jmodel, batch, 1, precision = 'mixed_bfloat16')
    np.testing.assert_allclose(losses, ref_losses, rtol = 2e-2)
    # float32 masters
    assert all(t.dtype == torch.float32 for t in flatten_tree(params).values())


def test_serving_after_fit_uses_the_fitted_weights(models):
    """Decoding keeps weights derived from the parameters (the fused
    decoder's packed copy); `fit` updates the parameters in place, so a
    model that decoded before `fit` must decode after it as a model loaded
    from the fitted checkpoint does."""
    root, _, _ = models
    model = Task.create('en', name = 'taco_serve_fit', root = root, device = 'cpu', seed = 5,
                        ** dict(TASK, lsa_attention_kernel_size = 31))
    tokens = model.encode_text('hello there')
    kw = dict(max_length = 32, deterministic = True, early_stopping = False,
              use_fused_decoder = True)
    before = model.compiled_infer(tokens, ** kw).mel.numpy()
    assert model._derived
    model.fit(_rows(), epochs = 1, batch_size = 2, valid_size = 0., device = 'cpu',
              token_multiple = 8, frame_multiple = 16, async_checkpointing = False)
    after = model.compiled_infer(tokens, ** kw).mel.numpy()
    fresh = Task.from_pretrained('taco_serve_fit', root = root, device = 'cpu')
    np.testing.assert_array_equal(after, fresh.compiled_infer(tokens, ** kw).mel.numpy())
    assert np.abs(after - before).max() > 1e-4


def test_fit_round_trip_loads_in_jax(models):
    root, _, _ = models
    model = Task.create('en', name = 'taco_port', root = root, device = 'cpu', seed = 3, ** TASK)
    history = model.fit(_rows(), epochs = 2, batch_size = 2, valid_size = 0., device = 'cpu',
                        token_multiple = 8, frame_multiple = 16, async_checkpointing = False)
    assert history.epochs == 2 and model.ckpt_manager.latest_epoch == 2
    reset_instances()
    reloaded = JaxTask(name = 'taco_port')
    assert reloaded.vocab_size == model.tokenizer.vocab_size
    assert reloaded.epochs == 2
    flat = flatten_tree(tree_to_jax(model.params))
    for key, value in flatten_tree(jax.tree_util.tree_map(np.asarray, reloaded.params)).items():
        np.testing.assert_array_equal(flat[key], value, err_msg = key)
    batch = _jax_batch(reloaded)
    ref = jtrainer.make_eval_step(reloaded, jlosses.TacotronLoss())(
        reloaded.params, reloaded.state, jax.random.PRNGKey(0), batch[0], batch[1])
    out = trainer.make_eval_step(model, TacotronLoss())(
        model.params, model.state, None, trainer._to_device(batch[0], 'cpu'),
        trainer._to_device(batch[1], 'cpu'))
    _close(float(out['loss']), float(ref['loss']), 1e-5, 'eval loss')
