"""WaveGlow training: the port's forward, loss, gradients and train step
against the JAX package's, on one tiny WaveGlow.

C=128 (the narrowest width both kernel routes take), 2 WN layers, 4 flows
with early outputs every 2, 8 mels, grouped length 512 (16 frames, 4096
samples), batch 1, float32, random weights from `init.init_waveglow` (the
`end` convs too, so that every block reaches the loss).  Both packages get
the same params, mel and audio.  Tolerances, float32: forward outputs and
loss within 1e-5 relative (the log-s and log-det sums relative to ||z||²/2,
beside which they enter the loss: the log-det of the orthogonal 1×1 convs
is float32 noise around 0); gradients per leaf within 1e-4 of the leaf's
largest gradient (another summation order through 4 flows of backward);
3 Adam steps with global-norm clipping and a schedule from WaveGlow's
learning rate (1e-4), params within 1e-5 absolute (measured 1.3e-7; at 1e-3
Adam's first, sign-like step moves elements whose gradient is near its eps
by 1e-6, and the loss follows within 2e-5).  Under ``mixed_bfloat16`` both sides round operands to bf16 at
other places: loss within 2e-2 relative, gradients within 5e-2 relative L2
per leaf.  ``wn_train_fused`` runs the whole-block kernel with bf16 buffers
on both sides (the JAX one in Pallas interpret mode, the port's through its
plain version): value and gradients within 2e-2 of their scale.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models import waveglow_arch
from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.train.losses import WaveGlowLoss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.train.trainer import make_eval_step, make_train_step
from text_to_speech_tpu_torch.weights import flatten_tree, waveglow_from_jax, waveglow_to_jax

CONFIG = dict(n_mel_channels = 8, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 2, wn_channels = 128,
              upsample_width = 1024, upsample_stride = 256)
FRAMES = 16


@pytest.fixture(scope = 'module')
def setup():
    port = WaveGlow(** CONFIG)
    params = init_waveglow(port.hp, port.flow_channels, seed = 0)
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((1, FRAMES, 8)) - 5.).astype(np.float32)
    audio = (0.3 * rng.standard_normal((1, FRAMES * 256))).astype(np.float32)
    return params, mel, audio


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _leaf_params(params):
    return {k: _leaf_params(v) if isinstance(v, dict) else v.requires_grad_(True)
            for k, v in params.items()}


def _grads(params):
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in params.items()}


def _port_loss_and_grads(setup, compute_dtype = None, remat = False, ** change):
    params, mel, audio = setup
    arch = WaveGlow(** CONFIG, ** change)
    p = _leaf_params(waveglow_from_jax(params))
    loss = arch.loss(p, torch.from_numpy(mel), torch.from_numpy(audio), remat = remat,
                     compute_dtype = compute_dtype)
    loss.backward()
    # the gradients in the JAX package's layout, flat, numpy
    return float(loss.detach()), flatten_tree(waveglow_to_jax(_grads(p)))


def _jax_loss_and_grads(setup, compute_dtype = None, ** change):
    params, mel, audio = setup
    arch = JaxWaveGlow(** CONFIG, ** change)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: arch.loss(
        p, jnp.asarray(mel), jnp.asarray(audio), compute_dtype = compute_dtype)))(
            _jax(params))
    return float(loss), {k: np.asarray(v) for k, v in flatten_tree(grads).items()}


def test_forward_and_loss_match_jax(setup):
    params, mel, audio = setup
    port, jax_arch = WaveGlow(** CONFIG), JaxWaveGlow(** CONFIG)
    with torch.no_grad():
        out = port.forward(waveglow_from_jax(params), torch.from_numpy(mel),
                           torch.from_numpy(audio))
        loss = float(port.loss(waveglow_from_jax(params), torch.from_numpy(mel),
                               torch.from_numpy(audio)))
    ref = jax_arch.forward(_jax(params), jnp.asarray(mel), jnp.asarray(audio))
    ref_loss = float(jax_arch.loss(_jax(params), jnp.asarray(mel), jnp.asarray(audio)))
    assert out[0].shape == (1, 512, 8)
    z, ref_z = out[0].numpy(), np.asarray(ref[0])
    assert float(np.abs(z - ref_z).max()) <= 1e-5 * float(np.abs(ref_z).max())
    # the two log terms enter the loss beside ||z||^2 / 2, which sets their
    # scale: the 1x1 convs start orthogonal, so Σ log|det W| is 0 up to
    # float32 rounding times B·lg (read: 4.6e-5 here, 9.2e-5 in JAX)
    scale = float(np.sum(ref_z.astype(np.float64) ** 2)) / 2
    for o, r in zip(out[1:], ref[1:]):
        assert abs(float(o) - float(r)) <= 1e-5 * scale, (float(o), float(r))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


@pytest.mark.parametrize('conv', ['dilated', 'shifted'])
def test_gradients_match_jax(setup, conv):
    """Also under ``wn_train_conv='shifted'``: the JAX package runs its
    chain's convs as shifted matmuls, the port accepts the key and runs the
    same contraction through `nn.conv1d`."""
    loss, grads = _port_loss_and_grads(setup, wn_train_conv = conv)
    ref_loss, ref = _jax_loss_and_grads(setup, wn_train_conv = conv)
    assert sorted(grads) == sorted(ref)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, r in ref.items():
        g = grads[name]
        assert float(np.abs(g - r).max()) <= 1e-4 * float(np.abs(r).max()), name


def test_remat_matches_no_remat(setup):
    loss, grads = _port_loss_and_grads(setup)
    loss_r, grads_r = _port_loss_and_grads(setup, remat = True)
    assert loss_r == loss
    for name, g in grads.items():
        np.testing.assert_array_equal(grads_r[name], g, err_msg = name)


def test_mixed_precision_matches_jax(setup):
    loss, grads = _port_loss_and_grads(setup, compute_dtype = torch.bfloat16)
    ref_loss, ref = _jax_loss_and_grads(setup, compute_dtype = jnp.bfloat16)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
    for name, r in ref.items():
        g = grads[name]
        assert g.dtype == np.float32     # float32 masters get float32 gradients
        assert float(np.linalg.norm(g - r)) <= 5e-2 * float(np.linalg.norm(r)), name


def _port_task(params, ** change):
    return WaveGlowTask.from_jax(params, device = 'cpu', ** CONFIG, ** change)


def _jax_task(** change):
    """The JAX package's train and eval steps dispatch on its WaveGlow task
    class and read only ``model.arch`` from it."""
    from text_to_speech_tpu.models.tts.waveglow import WaveGlow as JaxTask
    task = object.__new__(JaxTask)
    task.arch = JaxWaveGlow(** dict(CONFIG, ** change))
    return task


def test_three_train_steps_match_jax(setup):
    from text_to_speech_tpu.train import optimizers as jax_optimizers
    from text_to_speech_tpu.train.losses import WaveGlowLoss as JaxLoss
    from text_to_speech_tpu.train.trainer import make_train_step as jax_make_train_step
    params, mel, audio = setup
    opt = dict(lr_scheduler = {'name': 'DivideByStep', 'maxval': 1e-4, 'factor': 0.5},
               clip_norm = 0.5)

    task = _port_task(params)
    tx = get_optimizer('adam', ** opt)
    p = _leaf_params(task.params)
    opt_state = tx.init(p)
    step = make_train_step(task, WaveGlowLoss(), tx)
    inputs = (torch.from_numpy(mel), torch.from_numpy(audio))

    jtx = jax_optimizers.get_optimizer('adam', ** opt)
    jstep = jax_make_train_step(_jax_task(), JaxLoss(), jtx)
    jp = _jax(params)
    jopt = jtx.init(jp)
    jinputs = (jnp.asarray(mel), jnp.asarray(audio))
    for _ in range(3):
        p, _, opt_state, metrics = step(p, {}, opt_state, None, inputs, inputs[1])
        jp, _, jopt, jmetrics = jstep(jp, {}, jopt, jax.random.PRNGKey(0), jinputs,
                                      jinputs[1])
        assert abs(float(metrics['loss']) - float(jmetrics['loss'])) \
            <= 1e-5 * abs(float(jmetrics['loss']))
        assert abs(float(metrics['grad_norm']) - float(jmetrics['grad_norm'])) \
            <= 1e-4 * float(jmetrics['grad_norm'])
        assert float(jmetrics['grad_norm']) > opt['clip_norm']      # the clip acts
    assert opt_state.count == 3
    port_params = flatten_tree(waveglow_to_jax(p))
    for name, ref in flatten_tree(jp).items():
        np.testing.assert_allclose(port_params[name], np.asarray(ref), rtol = 0, atol = 1e-5,
                                   err_msg = name)


def test_use_pallas_eval_step_runs_the_layer_kernel(setup, monkeypatch):
    """The eval step of a ``use_pallas`` model takes `ops.wn_layer` for
    every layer of every flow (its plain version on the CPU) and gives the
    JAX eval step's loss on the XLA chain; its train step raises, as the
    kernel has no backward."""
    from text_to_speech_tpu.train.losses import WaveGlowLoss as JaxLoss
    from text_to_speech_tpu.train.trainer import make_eval_step as jax_make_eval_step
    params, mel, audio = setup
    calls = []
    layer = waveglow_arch.fused_wn_layer
    monkeypatch.setattr(waveglow_arch, 'fused_wn_layer',
                        lambda * a, ** kw: calls.append(kw['dilation']) or layer(* a, ** kw))
    task = _port_task(params, use_pallas = True)
    inputs = (torch.from_numpy(mel), torch.from_numpy(audio))
    metrics = make_eval_step(task, WaveGlowLoss())(task.params, {}, None, inputs, inputs[1])
    assert calls == [1, 2] * CONFIG['n_flows']
    jinputs = (jnp.asarray(mel), jnp.asarray(audio))
    ref = jax_make_eval_step(_jax_task(), JaxLoss())(_jax(params), {}, jax.random.PRNGKey(0),
                                                     jinputs, jinputs[1])
    assert abs(float(metrics['loss']) - float(ref['loss'])) <= 1e-5 * abs(float(ref['loss']))
    tx = get_optimizer('adam')
    p = _leaf_params(task.params)
    with pytest.raises(RuntimeError, match = 'wn_train_fused'):
        make_train_step(task, WaveGlowLoss(), tx)(p, {}, tx.init(p), None, inputs, inputs[1])


def test_wn_train_fused_matches_jax_kernel(setup):
    """Inside the JAX envelope (C % 128, 3 taps, grouped length % 512) the JAX
    forward runs `fused_wn_block` in interpret mode; the port runs the same
    block through the kernel's plain version.  Both backwards recompute
    through the float32 chain."""
    loss, grads = _port_loss_and_grads(setup, wn_train_fused = True)
    ref_loss, ref = _jax_loss_and_grads(setup, wn_train_fused = True)
    f32_loss, _ = _port_loss_and_grads(setup)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
    assert loss != f32_loss              # the bf16 kernel path ran
    for name, r in ref.items():
        g = grads[name]
        assert float(np.abs(g - r).max()) <= 2e-2 * float(np.abs(r).max()), name


def test_wn_train_fused_with_use_pallas_raises(setup):
    """The fused training block's backward recomputes through the per-layer
    chain, which under ``use_pallas`` reaches the layer kernel: no gradient."""
    with pytest.raises(RuntimeError, match = 'no backward'):
        _port_loss_and_grads(setup, wn_train_fused = True, use_pallas = True)


def test_weight_decay_only_with_adamw():
    """The JAX package adds `weight_decay` after the learning-rate-scaled
    update for any optimizer but adamw: a zero gradient moves a weight of
    1.0 to 1.1.  The port refuses it there, and adamw decays."""
    import optax
    from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer
    tx = jax_get_optimizer('adam', lr = 1e-3, weight_decay = 0.1)
    w = {'w': jnp.ones(())}
    updates, _ = tx.update({'w': jnp.zeros(())}, tx.init(w), w)
    assert abs(float(optax.apply_updates(w, updates)['w']) - 1.1) < 1e-6
    for name in ('adam', 'sgd', 'rmsprop', 'adagrad', 'adafactor', 'lion'):
        with pytest.raises(ValueError, match = 'adamw'):
            get_optimizer(name, lr = 1e-3, weight_decay = 0.1)
    w = torch.ones((), requires_grad = True)
    opt = get_optimizer('adamw', lr = 1e-3, weight_decay = 0.1).init({'w': w})
    w.grad = torch.zeros(())
    opt.step()
    assert abs(float(w.detach()) - (1. - 1e-3 * 0.1)) < 1e-7


def _rows(n, seed = 2):
    rng = np.random.default_rng(seed)
    return [{'audio': (0.3 * rng.standard_normal(4096 + 700 * i)).astype(np.float32),
             'rate': 22050} for i in range(n)]


def test_fit_checkpoint_loads_in_jax(setup, tmp_path):
    """Two epochs of `fit` write a checkpoint that the JAX package's
    `CheckpointManager` reads into its `WaveGlow.infer`, which then vocodes as
    the port's fitted model does; a third epoch resumes the optimizer."""
    import json
    from text_to_speech_tpu.train.checkpoint import CheckpointManager as JaxManager
    params, mel, _ = setup
    task = WaveGlowTask.from_jax(params, device = 'cpu', name = 'tiny_fit',
                                 root = str(tmp_path), ** CONFIG)
    rows = _rows(3)
    history = task.fit(rows[:2], valid_data = rows[2:], epochs = 2, batch_size = 2,
                       lr = 1e-4, device = 'cpu')
    assert task.epochs == 2 and len(history.get_metric('val_loss')) == 2
    directory = tmp_path / 'tiny_fit'
    manifest = json.loads((directory / 'saving' / 'checkpoint' / 'checkpoint.json').read_text())
    assert [c['epoch'] for c in manifest['checkpoints']] == [1, 2]
    assert sorted(manifest['checkpoints'][-1]['trees']) == ['opt', 'params']
    config = json.loads((directory / 'saving' / 'config_models.json').read_text())
    assert config.pop('architecture') == 'waveglow'

    jax_params = JaxManager(str(directory / 'saving' / 'checkpoint')).load(
        trees = ('params',), as_jax = True)['params']
    ref = JaxWaveGlow(** config).infer(jax_params, jnp.asarray(mel), deterministic = True,
                                       use_pallas = False)
    with torch.no_grad():
        out = task.arch.infer(task.params, torch.from_numpy(mel), deterministic = True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol = 0,
                               atol = 1e-5 * float(np.abs(np.asarray(ref)).max()))
    # the weights moved
    assert not np.allclose(np.asarray(jax_params['flow_0']['block']['start']['kernel']),
                           params['flow_0']['block']['start']['kernel'])

    task.fit(rows[:2], valid_data = rows[2:], epochs = 1, batch_size = 2, lr = 1e-4,
             device = 'cpu')
    assert task.history.trainings[-1]['config']['resumed_optimizer_from_epoch'] == 2
    saved = WaveGlowTask.from_pretrained('tiny_fit', root = str(tmp_path), device = 'cpu')
    for name, value in flatten_tree(saved.params).items():
        torch.testing.assert_close(value, flatten_tree(task.params)[name], rtol = 0, atol = 0)


def test_wn_train_fused_at_any_grouped_length(monkeypatch):
    """The JAX package takes the fused training block only at a grouped
    length that is a multiple of 512 (its TPU tiles); the port's kernel takes
    any length, so a 15-frame batch (grouped length 480) runs it too."""
    calls = []
    block = waveglow_arch.fused_wn_block
    monkeypatch.setattr(waveglow_arch, 'fused_wn_block',
                        lambda * a: calls.append(a[0].shape) or block(* a))
    arch = WaveGlow(** CONFIG, wn_train_fused = True)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 3)
    rng = np.random.default_rng(4)
    mel = torch.from_numpy((rng.standard_normal((1, 15, 8)) - 5.).astype(np.float32))
    audio = torch.from_numpy((0.3 * rng.standard_normal((1, 15 * 256))).astype(np.float32))
    p = _leaf_params(waveglow_from_jax(params))
    arch.loss(p, mel, audio).backward()
    assert calls == [(1, 480, CONFIG['wn_channels'])] * CONFIG['n_flows']
    assert all(bool(torch.isfinite(v).all()) for v in flatten_tree(_grads(p)).values())


@pytest.mark.parametrize('name,config', [
    ('DivideByStep', dict(maxval = 1e-3, factor = 0.5)),
    ('ReduceEvery', dict(lr = 1e-3, every = 10)),
    ('WarmupScheduler', dict(warmup_steps = 100, dim = 256)),
    ('SinScheduler', dict(period = 50)),
    ('TanhDecayScheduler', dict(decay_steps = 300))])
def test_schedulers_match_jax(name, config):
    """Each schedule gives the JAX package's value at optax's step count,
    within 2e-5 relative: JAX evaluates it in float32, the port in Python
    floats (a sine's phase of 2π·1000/50 = 125.7 carries 7.6e-6 of float32
    rounding)."""
    from text_to_speech_tpu.train.optimizers import get_scheduler as jax_get_scheduler
    from text_to_speech_tpu_torch.train.optimizers import get_scheduler
    port, ref = get_scheduler(dict(config, name = name)), jax_get_scheduler(name, ** config)
    for step in (0, 1, 7, 99, 1000):
        expected = float(ref(jnp.asarray(step)))
        assert abs(port(step) - expected) <= 2e-5 * abs(expected), step


@pytest.mark.parametrize('name', ['rmsprop', 'adagrad'])
def test_optimizer_steps_match_jax(name):
    """Three steps at lr 1e-2 from weights of 1.0, at gradients 1e-5, 1e-4,
    1e-3 and 1e-1, against the JAX package's `get_optimizer` (optax's
    `rmsprop` and `adagrad`): within 2.4e-7 absolute, four float32 units
    near 1.  The control, torch's own RMSprop (eps outside the square
    root), moves the 1e-5 weight by -0.0736 where optax moves it by -0.0030.
    Two steps, the state through `state_arrays` into a new optimizer, and
    the third step give the three steps' weights to the bit."""
    import optax
    from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer
    grads = np.asarray([1e-5, 1e-4, 1e-3, 1e-1], np.float32)
    tx = jax_get_optimizer(name, lr = 1e-2)
    w = {'w': jnp.ones(4)}
    state = tx.init(w)
    for _ in range(3):
        updates, state = tx.update({'w': jnp.asarray(grads)}, state, w)
        w = optax.apply_updates(w, updates)

    def port(resume_after = None):
        t = torch.ones(4, requires_grad = True)
        opt = get_optimizer(name, lr = 1e-2).init({'w': t})
        for step in range(3):
            if step == resume_after:
                arrays = opt.state_arrays()
                opt = get_optimizer(name, lr = 1e-2).init({'w': t})
                opt.load_state_arrays(arrays)
            t.grad = torch.from_numpy(grads)
            opt.step()
        return t.detach().numpy().copy()

    out = port()
    np.testing.assert_allclose(out, np.asarray(w['w']), atol = 2.4e-7, rtol = 0)
    np.testing.assert_array_equal(port(resume_after = 2), out)
    if name == 'rmsprop':
        # the control: torch's RMSprop with optax's constants misses by 0.07
        t = torch.ones(4, requires_grad = True)
        control = torch.optim.RMSprop([t], lr = 1e-2, alpha = 0.9, eps = 1e-8)
        for _ in range(3):
            t.grad = torch.from_numpy(grads)
            control.step()
        assert abs(float(t.detach()[0]) - float(w['w'][0])) > 0.05


# The calls of the JAX get_optimizer that the port once refused (optax's keywords, a dict
# config, `learning_rate`, lr=None, rmsprop's momentum and nesterov), and
# the rest of optax's keywords for the five ported names.
@pytest.mark.parametrize('args,kwargs', [
    (('adam',), dict(b1 = 0.8)),
    ((), dict(learning_rate = 1e-2)),
    (({'name': 'adam', 'b1': 0.8},), {}),
    (('adam',), dict(lr = None)),
    (('rmsprop',), dict(momentum = 0.9, nesterov = True, lr = 1e-2)),
    (('rmsprop',), dict(centered = True, lr = 1e-2)),
    (('rmsprop',), dict(bias_correction = True, eps_in_sqrt = False, momentum = 0.5, lr = 1e-2)),
    (('adam',), dict(nesterov = True, eps_root = 1e-8, b2 = 0.99, lr = 1e-2)),
    (('adamw',), dict(b1 = 0.85, weight_decay = 1e-2, learning_rate = 1e-2)),
    (({'class_name': 'sgd', 'momentum': 0.9, 'nesterov': True},), dict(lr = 1e-2)),
    (({'name': 'adagrad', 'initial_accumulator_value': 0.2},), dict(lr = 1e-2)),
    (('adam',), dict(lr = 1e-2, lr_scheduler = {'name': 'DivideByStep', 'maxval': 1e-2}))],
    ids = lambda v: repr(v) if isinstance(v, dict) else repr(v[0]) if v else '-')
def test_optimizer_keywords_match_jax(args, kwargs):
    """Each call gives the JAX `get_optimizer`'s update: three steps from
    weights of 1.0 at gradients 1e-5 .. 1e-1, within 2.4e-7 absolute (the
    limit of `test_optimizer_steps_match_jax`; measured equal to the bit)."""
    import optax
    from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer
    copy = lambda: [dict(a) if isinstance(a, dict) else a for a in args]
    grads = np.asarray([1e-5, 1e-4, 1e-3, 1e-1], np.float32)
    tx = jax_get_optimizer(* copy(), ** kwargs)
    w = {'w': jnp.ones(4)}
    state = tx.init(w)
    t = torch.ones(4, requires_grad = True)
    opt = get_optimizer(* copy(), ** kwargs).init({'w': t})
    for _ in range(3):
        updates, state = tx.update({'w': jnp.asarray(grads)}, state, w)
        w = optax.apply_updates(w, updates)
        t.grad = torch.from_numpy(grads)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(w['w']), atol = 2.4e-7, rtol = 0)


def test_optimizer_refuses_what_optax_refuses_or_torch_cannot_honour():
    with pytest.raises(TypeError, match = 'betas'):
        get_optimizer('adam', betas = (0.9, 0.99))          # torch's name, not optax's
    with pytest.raises(ValueError, match = 'mu_dtype'):
        get_optimizer('adam', mu_dtype = 'bfloat16')


def test_fit_takes_the_jax_keywords(setup, tmp_path, monkeypatch):
    """`fit` takes the JAX `fit`'s `async_checkpointing` and `token_multiple`:
    the background writer's checkpoint loads in the JAX package, as in
    `test_fit_checkpoint_loads_in_jax`, and an error on the writer's thread
    reaches the caller."""
    from text_to_speech_tpu.train.checkpoint import CheckpointManager as JaxManager
    from text_to_speech_tpu_torch.train import checkpoint
    params, _, _ = setup
    task = WaveGlowTask.from_jax(params, device = 'cpu', name = 'tiny_async',
                                 root = str(tmp_path), ** CONFIG)
    rows = _rows(2)
    fit_kw = dict(valid_size = 0, epochs = 1, batch_size = 2, lr = 1e-4, device = 'cpu',
                  async_checkpointing = True, token_multiple = 32)
    task.fit(rows, ** fit_kw)
    assert task.epochs == 1
    ckpt = tmp_path / 'tiny_async' / 'saving' / 'checkpoint'
    jax_params = JaxManager(str(ckpt)).load(trees = ('params',))['params']
    for name, value in flatten_tree(waveglow_to_jax(task.params)).items():
        np.testing.assert_array_equal(flatten_tree(jax_params)[name], np.asarray(value))

    def full_disk(* args, ** kwargs):
        raise OSError('disk full')
    writes = []
    save = checkpoint.AsyncCheckpointSaver._write
    monkeypatch.setattr(checkpoint.AsyncCheckpointSaver, '_write',
                        lambda * a, ** kw: writes.append(1) or save(* a, ** kw))
    monkeypatch.setattr(task.ckpt_manager, 'save', full_disk)
    with pytest.raises(OSError, match = 'disk full'):
        task.fit(rows, ** fit_kw)
    assert writes == [1]


def test_repeated_batch_spike_matches_jax():
    """Adam on one repeated batch of white noise (0.1 std) overshoots.  The
    loss falls toward the noise's Gaussian optimum (the flows' log-s summing
    to ln 10), each step's growth of log-s compounding through the layers,
    until one step carries the sum past it and ||z||²/2 jumps; the next
    steps fall again.  At NVIDIA width the 7th step jumps (loss -0.51 → 383
    on the H100, `benchmarks/torch_port_profile.py --trace-steps`); here, at
    C=128 with 4 layers a block, 8 frames and Adam at 1e-3, the 7th step
    jumps too.
    The JAX package's train step takes the same path within 2e-3 relative
    (measured 2.4e-5 before the jump, 3.3e-4 at it: 0.59 → 5.70, the
    gradient norm 2.9 → 564): the spike is the model's and the optimizer's
    on this data, not the port's."""
    from text_to_speech_tpu.train import optimizers as jax_optimizers
    from text_to_speech_tpu.train.losses import WaveGlowLoss as JaxLoss
    from text_to_speech_tpu.train.trainer import make_train_step as jax_make_train_step
    config = dict(CONFIG, wn_layers = 4)
    arch = WaveGlow(** config)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 3)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((1, 8, 8)).astype(np.float32)
    audio = (0.1 * rng.standard_normal((1, 8 * 256))).astype(np.float32)

    task = WaveGlowTask.from_jax(params, device = 'cpu', ** config)
    tx = get_optimizer('adam', lr = 1e-3)
    p = _leaf_params(task.params)
    opt_state = tx.init(p)
    step = make_train_step(task, WaveGlowLoss(), tx)
    jtx = jax_optimizers.get_optimizer('adam', lr = 1e-3)
    jstep = jax_make_train_step(_jax_task(wn_layers = 4), JaxLoss(), jtx)
    jp = _jax(params)
    jopt = jtx.init(jp)
    inputs = (torch.from_numpy(mel), torch.from_numpy(audio))
    jinputs = (jnp.asarray(mel), jnp.asarray(audio))
    losses, ref, norms, ref_norms = [], [], [], []
    for _ in range(8):
        p, _, opt_state, metrics = step(p, {}, opt_state, None, inputs, inputs[1])
        jp, _, jopt, jmetrics = jstep(jp, {}, jopt, jax.random.PRNGKey(0), jinputs,
                                      jinputs[1])
        losses.append(float(metrics['loss']))
        ref.append(float(jmetrics['loss']))
        norms.append(float(metrics['grad_norm']))
        ref_norms.append(float(jmetrics['grad_norm']))
    for loss, r in zip(losses, ref):
        assert abs(loss - r) <= 2e-3 * abs(r), (losses, ref)
    for trace, norm in ((losses, norms), (ref, ref_norms)):
        assert all(b < a < 0 for a, b in zip(trace[1:6], trace[2:6]))   # falling
        assert trace[6] > 5 * abs(trace[5]) and norm[6] > 100 * norm[5]  # the jump
        assert trace[7] < 0
