"""FastSpeech-2 teacher forcing and its data pipeline: the port against the
JAX package.

Tiny widths (dim 16, one FFT block each side, a two-conv postnet), weights
from a numpy seed handed to both packages, every drop rate 0 with
``train=True`` (the postnet's batch norms on the batch).  Tolerances:

  - `__call__` with the ground-truth durations, pitch and energy at the
    phoneme and the frame level: the 7 outputs (masks equal) and the new
    postnet state within 1e-5 of each one's scale;
  - the gradients of the mean `FastSpeech2Loss` against
    `jax.value_and_grad`: within 1e-4 of each leaf's largest gradient.  Two
    kinds of leaf have a zero gradient, float noise on both sides, held
    within 1e-4 of the largest gradient of all leaves: the postnet's conv
    biases before a training batch norm (the norm takes the batch mean
    out) and the attention key biases (they add q·b to every key's score,
    which the softmax takes out);
  - `ops.pitch` (`estimate_pitch`, `frame_energy`, `log_normalize`,
    `phoneme_average`, `durations_from_attention`) on one waveform at the
    model's rate: equal;
  - the task model (made by the JAX package, loaded by name in the port):
    `_load_durations` from ``durations``, from an ``alignment`` and the
    uniform fallback, `_load_variances`, `prepare_data`, `filter_data`,
    `collate` and `bucket_pad`: every integer, mask and shape equal, pitch
    and energy equal, mels within 5e-4 absolute (``test_torch_port_stft.py``);
  - three Adam steps through `make_train_step`: losses and parameters
    within 1e-4 of their scale (the zero-gradient leaves, which Adam moves
    by sign-like steps on noise, and the running means the conv biases
    shift, by the bound of those steps, as in
    ``test_torch_port_tacotron2_train.py``);
  - one step under ``mixed_bfloat16``: the loss within 2e-2 relative;
  - a model made by the port (`FastSpeech2.create`) and fitted for two
    epochs on rows with an ``alignment``, its directory reloaded by name in
    the JAX package: the same weights, and the JAX eval loss within 1e-5
    relative of the port's.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.fastspeech2_arch import FastSpeech2 as JaxArch
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import FastSpeech2 as JaxTask
from text_to_speech_tpu.ops import pitch as jpitch
from text_to_speech_tpu.train import losses as jlosses
from text_to_speech_tpu.train import trainer as jtrainer
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer

from text_to_speech_tpu_torch.init import init_fastspeech2
from text_to_speech_tpu_torch.models.fastspeech2_arch import FastSpeech2 as Arch
from text_to_speech_tpu_torch.models.tts import FastSpeech2 as Task
from text_to_speech_tpu_torch.ops import pitch
from text_to_speech_tpu_torch.train import trainer
from text_to_speech_tpu_torch.train.losses import FastSpeech2Loss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import convert_tree, flatten_tree, tree_to_jax

TINY = dict(dim = 16, n_heads = 2, encoder_layers = 1, decoder_layers = 1, ffn_dim = 16,
            variance_filters = 8, postnet_n_conv = 2, postnet_filters = 8, max_position = 256,
            drop_rate = 0., variance_drop_rate = 0., postnet_drop_rate = 0.)
ARCH = dict(vocab_size = 24, n_mel_channels = 8, ** TINY)
FRAMES = 32


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, '{}: {} > {} x {}'.format(what, err, tol, scale)


def _batch(level, seed = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 24, (2, 8))
    tokens[1, 5:] = 0
    durations = rng.integers(1, 4, (2, 8)).astype(np.int32)
    durations[1, 5:] = 0
    n = FRAMES if level == 'frame' else 8
    variances = [rng.uniform(-2.5, 2.5, (2, n)).astype(np.float32) for _ in range(2)]
    mel = rng.standard_normal((2, FRAMES, 8)).astype(np.float32)
    return (tokens, durations, * variances), (mel, durations, * variances)


def _setup(level):
    config = {** ARCH, 'variance_level': level}
    arch = Arch(** config)
    params, state = init_fastspeech2(arch.hp, seed = 1)
    return config, arch, params, state


def _port_forward(arch, params, state, inputs, leaves = None):
    p, s = convert_tree(params), convert_tree(state)
    if leaves is not None:
        p = trainer._trainable(p)
        leaves.append(p)
    tokens, durations, pitch_t, energy_t = (torch.from_numpy(np.asarray(v)) for v in inputs)
    return arch(p, s, tokens.long(), durations = durations, pitch = pitch_t, energy = energy_t,
                max_frames = FRAMES, train = True, generator = torch.Generator().manual_seed(0))


def _jax_forward(config, params, state, inputs):
    tokens, durations, pitch_t, energy_t = (jnp.asarray(v) for v in inputs)
    return JaxArch(** config)(params, state, tokens, durations = durations, pitch = pitch_t,
                              energy = energy_t, max_frames = FRAMES, train = True,
                              rng = jax.random.PRNGKey(0))


@pytest.mark.parametrize('level', ['phoneme', 'frame'])
def test_teacher_forced_forward_matches_jax(level):
    config, arch, params, state = _setup(level)
    inputs, _ = _batch(level)
    ref, ref_state = jax.jit(lambda p, s: _jax_forward(config, p, s, inputs))(
        _jax(params), _jax(state))
    with torch.no_grad():
        out, new_state = _port_forward(arch, params, state, inputs)
    names = ('mel', 'mel_postnet', 'log_duration', 'pitch', 'energy', 'frame_mask',
             'token_mask')
    for name, o, e in zip(names, out, ref):
        if name.endswith('mask'):
            np.testing.assert_array_equal(np.asarray(o, np.float32), np.asarray(e, np.float32))
        else:
            _close(o, e, 1e-5, name)
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state))
    flat_out = flatten_tree(tree_to_jax(new_state))
    assert sorted(flat_out) == sorted(flat_ref)
    for key in flat_ref:
        _close(flat_out[key], flat_ref[key], 1e-5, key)


def _zero_gradient(key):
    """A leaf whose gradient is 0: a conv bias before a training batch
    norm, or an attention key bias."""
    return (key.startswith('postnet/') and key.endswith('/conv/bias')) \
        or key.endswith('attention/key/bias')


def _hold_grads(grads, flat_ref):
    assert sorted(grads) == sorted(flat_ref)
    largest = max(float(np.abs(g).max()) for g in flat_ref.values())
    for key in flat_ref:
        if _zero_gradient(key):
            assert np.abs(grads[key] - flat_ref[key]).max() <= 1e-4 * largest, key
        else:
            _close(grads[key], flat_ref[key], 1e-4, key)


@pytest.mark.parametrize('level', ['phoneme', 'frame'])
def test_gradients_match_jax(level):
    config, arch, params, state = _setup(level)
    inputs, targets = _batch(level)
    loss_fn = jlosses.FastSpeech2Loss()

    def jax_loss(p):
        preds, _ = _jax_forward(config, p, _jax(state), inputs)
        return jnp.mean(loss_fn(_jax(targets), preds)['loss'])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(_jax(params))
    leaves = []
    preds, _ = _port_forward(arch, params, state, inputs, leaves)
    losses = FastSpeech2Loss()(tuple(torch.from_numpy(np.asarray(t)) for t in targets), preds)
    loss = torch.mean(losses['loss'])
    loss.backward()
    _close(loss.detach(), ref_loss, 1e-5, 'loss')
    grads = flatten_tree(tree_to_jax(jax.tree_util.tree_map(
        lambda t: t.grad, leaves[0], is_leaf = torch.is_tensor)))
    _hold_grads(grads, flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads)))


def test_pitch_ops_equal_jax():
    rate, hop, win = 22050, 256, 1024
    t = np.arange(int(0.5 * rate)) / rate
    audio = (0.5 * np.sin(2 * np.pi * 180. * t * (1 + 0.2 * t))
             + 0.01 * np.random.default_rng(3).standard_normal(len(t))).astype(np.float32)
    f0, voiced = pitch.estimate_pitch(audio, rate, hop_length = hop, win_length = win)
    rf0, rvoiced = jpitch.estimate_pitch(audio, rate, hop_length = hop, win_length = win)
    np.testing.assert_array_equal(f0, rf0)
    np.testing.assert_array_equal(voiced, rvoiced)
    energy = pitch.frame_energy(audio, hop_length = hop, win_length = win)
    np.testing.assert_array_equal(energy, jpitch.frame_energy(audio, hop_length = hop,
                                                              win_length = win))
    for values, log_scale in ((f0, True), (energy, False)):
        for o, r in zip(pitch.log_normalize(values, log_scale = log_scale),
                        jpitch.log_normalize(values, log_scale = log_scale)):
            np.testing.assert_array_equal(o, r)
    durations = np.array([3, 0, 5, 2, 8], np.int32)
    np.testing.assert_array_equal(pitch.phoneme_average(f0[:18], durations),
                                  jpitch.phoneme_average(f0[:18], durations))
    attention = np.random.default_rng(4).dirichlet(np.ones(7), size = 40).astype(np.float32)
    np.testing.assert_array_equal(pitch.durations_from_attention(attention, n_tokens = 7),
                                  jpitch.durations_from_attention(attention, n_tokens = 7))


# -- the task model ---------------------------------------------------------------

def _rows(n = 4, rate = 22050, alignment = True):
    rng = np.random.RandomState(0)
    texts = ['hello there', 'this is a test', 'synthetic data']
    rows = []
    for i in range(n):
        samples = 4000 + 700 * (i % 3)
        t = np.arange(samples) / rate
        audio = (0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t)
                 + 0.05 * rng.randn(samples)).astype(np.float32)
        row = {'text': texts[i % 3], 'audio': audio, 'rate': rate}
        if alignment:
            frames = samples // 256 + 1
            row['alignment'] = rng.dirichlet(np.ones(len(texts[i % 3])), size = frames) \
                .astype(np.float32)
        rows.append(row)
    return rows


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('fs2_train'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        jmodel = JaxTask(lang = 'en', name = 'fs2_train_tiny', ** TINY)
        model = Task.from_pretrained('fs2_train_tiny', root = root, device = 'cpu')
        yield root, jmodel, model
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def test_load_durations_and_variances_equal_jax(models):
    _, jmodel, model = models
    rng = np.random.default_rng(5)
    n_tokens, n_frames = 9, 40
    sources = [{'durations': rng.integers(0, 8, 12)},
               {'durations': np.array([1, 1, 1])},
               {'durations': np.array([30, 20, 0, 0, 0, 0, 0, 0, 1])},
               {'alignment': rng.dirichlet(np.ones(n_tokens), size = 37).astype(np.float32)},
               {}]
    for row in sources:
        out = model._load_durations(row, n_tokens, n_frames)
        ref = jmodel._load_durations(row, n_tokens, n_frames)
        np.testing.assert_array_equal(out, ref)
        assert out.dtype == ref.dtype and int(out.sum()) == n_frames
    audio_row = _rows(1, alignment = False)[0]
    durations = model._load_durations({}, n_tokens, n_frames)
    for level in ('phoneme', 'frame'):
        model.arch.hp.variance_level = jmodel.arch.hp.variance_level = level
        try:
            for row in (audio_row, {'pitch': rng.standard_normal(50), 'energy': None},
                        {'pitch': np.ones(n_tokens), 'energy': np.zeros(n_frames)}):
                for o, r in zip(model._load_variances(row, durations, n_frames),
                                jmodel._load_variances(row, durations, n_frames)):
                    np.testing.assert_array_equal(o, r)
        finally:
            model.arch.hp.variance_level = jmodel.arch.hp.variance_level = 'phoneme'


def test_data_pipeline_matches_jax(models):
    _, jmodel, model = models
    assert model.get_padding_values() == jmodel.get_padding_values()
    items, ref_items = [], []
    for row in _rows():
        item, ref = model.prepare_data(row), jmodel.prepare_data(row)
        for o, r in zip(item[0], ref[0]):
            np.testing.assert_array_equal(o, r)
        np.testing.assert_allclose(item[1][0], ref[1][0], rtol = 0, atol = 5e-4)
        assert model.filter_data(* item) == jmodel.filter_data(* ref)
        items.append(item)
        ref_items.append(ref)
    batch = trainer.bucket_pad(model.collate(items), model, token_multiple = 8,
                               frame_multiple = 16)
    ref = jtrainer.bucket_pad(jmodel.collate(ref_items), jmodel, token_multiple = 8,
                              frame_multiple = 16)
    for o, r in zip(batch[0], ref[0]):
        np.testing.assert_array_equal(o, r)
    for o, r in zip(batch[1][1:], ref[1][1:]):
        np.testing.assert_array_equal(o, r)
    assert batch[1][0].shape == ref[1][0].shape
    np.testing.assert_allclose(batch[1][0], ref[1][0], rtol = 0, atol = 5e-4)


def _jax_batch(jmodel):
    items = [jmodel.prepare_data(row) for row in _rows()]
    return jtrainer.bucket_pad(jmodel.collate(items), jmodel, token_multiple = 8,
                               frame_multiple = 16)


def test_three_adam_steps_match_jax(models):
    _, jmodel, model = models
    inputs, targets = _jax_batch(jmodel)
    params = trainer._trainable(jax.tree_util.tree_map(torch.clone, model.params))
    state = model.state
    tx = get_optimizer('adam', lr = 1e-3)
    opt_state = tx.init(params)
    step = trainer.make_train_step(model, FastSpeech2Loss(), tx)
    jtx = jax_get_optimizer('adam', lr = 1e-3)
    jparams, jstate = (jax.tree_util.tree_map(jnp.array, t) for t in (jmodel.params, jmodel.state))
    jopt = jtx.init(jparams)
    jstep = jtrainer.make_train_step(jmodel, jlosses.FastSpeech2Loss(), jtx)
    losses, ref_losses = [], []
    for _ in range(3):
        params, state, opt_state, m = step(params, state, opt_state, None,
                                           trainer._to_device(inputs, 'cpu'),
                                           trainer._to_device(targets, 'cpu'))
        jparams, jstate, jopt, jm = jstep(jparams, jstate, jopt, jax.random.PRNGKey(0),
                                          inputs, targets)
        losses.append(float(m['loss']))
        ref_losses.append(float(jm['loss']))
    _close(losses, ref_losses, 1e-4, 'losses')
    assert losses[-1] < losses[0]
    flat = flatten_tree(tree_to_jax(params))
    flat.update({'state/' + k: v for k, v in flatten_tree(tree_to_jax(state)).items()})
    flat_ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
    flat_ref.update({'state/' + k: np.asarray(v) for k, v in flatten_tree(jstate).items()})
    start = flatten_tree(jax.tree_util.tree_map(np.asarray, jmodel.params))
    assert sorted(flat) == sorted(flat_ref)
    for key in flat_ref:
        if _zero_gradient(key):
            for moved in (flat[key], flat_ref[key]):
                assert np.abs(moved - start[key]).max() <= 3e-3 * (1 + 1e-4), key
        elif key.endswith('/moving_mean'):
            scale = float(np.abs(flat_ref[key]).max())
            assert np.abs(flat[key] - flat_ref[key]).max() <= 1e-4 * scale + 0.1 * 6e-3, key
        else:
            _close(flat[key], flat_ref[key], 1e-4, key)


def test_mixed_bfloat16_step_matches_jax(models):
    """One step under ``mixed_bfloat16``: both sides round the operands of
    another summation order to bfloat16, so the loss is held within 2e-2
    relative; the parameters stay float32 masters."""
    _, jmodel, model = models
    inputs, targets = _jax_batch(jmodel)
    params = trainer._trainable(jax.tree_util.tree_map(torch.clone, model.params))
    tx = get_optimizer('adam', lr = 1e-3)
    step = trainer.make_train_step(model, FastSpeech2Loss(), tx, precision = 'mixed_bfloat16')
    params, _, _, m = step(params, model.state, tx.init(params), None,
                           trainer._to_device(inputs, 'cpu'), trainer._to_device(targets, 'cpu'))
    jtx = jax_get_optimizer('adam', lr = 1e-3)
    jparams = jax.tree_util.tree_map(jnp.array, jmodel.params)
    jstep = jtrainer.make_train_step(jmodel, jlosses.FastSpeech2Loss(), jtx,
                                     precision = 'mixed_bfloat16')
    _, _, _, jm = jstep(jparams, jax.tree_util.tree_map(jnp.array, jmodel.state),
                        jtx.init(jparams), jax.random.PRNGKey(0), inputs, targets)
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol = 2e-2)
    assert all(t.dtype == torch.float32 for t in flatten_tree(params).values())


def test_serving_after_fit_uses_the_fitted_weights(models):
    """Serving in bfloat16 keeps a cast copy of the parameters; `fit`
    updates them in place, so a model served before `fit` must serve after
    it as a model loaded from the fitted checkpoint does."""
    root, _, _ = models
    model = Task.create('en', name = 'fs2_serve_fit', root = root, device = 'cpu', seed = 5,
                        ** TINY)
    tokens = model.encode_text('hello there')
    kw = dict(dtype = torch.bfloat16, min_duration = 2)
    before = model.compiled_infer(tokens, ** kw).mel.float().numpy()
    assert model._derived
    model.fit(_rows(), epochs = 1, batch_size = 2, valid_size = 0., device = 'cpu',
              token_multiple = 8, frame_multiple = 16, async_checkpointing = False)
    after = model.compiled_infer(tokens, ** kw).mel.float().numpy()
    fresh = Task.from_pretrained('fs2_serve_fit', root = root, device = 'cpu')
    np.testing.assert_array_equal(after, fresh.compiled_infer(tokens, ** kw).mel.float().numpy())
    assert np.abs(after - before).max() > 1e-3


def test_fit_round_trip_loads_in_jax(models):
    root, _, _ = models
    model = Task.create('en', name = 'fs2_port', root = root, device = 'cpu', seed = 3, ** TINY)
    history = model.fit(_rows(), epochs = 2, batch_size = 2, valid_size = 0., device = 'cpu',
                        token_multiple = 8, frame_multiple = 16)
    assert history.epochs == 2
    reset_instances()
    reloaded = JaxTask(name = 'fs2_port')
    assert reloaded.epochs == 2
    flat = flatten_tree(tree_to_jax(model.params))
    for key, value in flatten_tree(jax.tree_util.tree_map(np.asarray, reloaded.params)).items():
        np.testing.assert_array_equal(flat[key], value, err_msg = key)
    inputs, targets = _jax_batch(reloaded)
    ref = jtrainer.make_eval_step(reloaded, jlosses.FastSpeech2Loss())(
        reloaded.params, reloaded.state, jax.random.PRNGKey(0), inputs, targets)
    out = trainer.make_eval_step(model, FastSpeech2Loss())(
        model.params, model.state, None, trainer._to_device(inputs, 'cpu'),
        trainer._to_device(targets, 'cpu'))
    _close(float(out['loss']), float(ref['loss']), 1e-5, 'eval loss')
