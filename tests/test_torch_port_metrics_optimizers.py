"""The port's `lion` and `adafactor`, the optimizer and scheduler registries,
and `train.metrics`, against the JAX package's (optax there).

  - three steps of each optimizer through `get_optimizer`, from the same
    seeded weights and gradients, on a tree with a factored (128 x 256), a
    row-wise (3 x 256) and a vector leaf: within 1e-6 of the weights'
    scale (float32; optax's ``x ** -0.5`` may round as XLA's rsqrt);
  - the registries list the same names; a registered class is built by
    name;
  - every metric on seeded inputs within 1e-6 (relative for the dB
    metrics), and the reduction-factor policy.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax.numpy as jnp
import optax

from text_to_speech_tpu.train import metrics as jmetrics
from text_to_speech_tpu.train import optimizers as joptimizers

from text_to_speech_tpu_torch.train import metrics, optimizers

SHAPES = {'a': (128, 256), 'b': (3, 256), 'c': (16,)}


@pytest.mark.parametrize('name, kwargs', [
    ('lion', dict(lr = 1e-3)),
    ('lion', dict(lr = 3e-4, b1 = 0.95, b2 = 0.98)),
    ('adafactor', dict(lr = 1e-2)),
    ('adafactor', dict(lr = 1e-2, momentum = 0.9, weight_decay_rate = 1e-3,
                       clipping_threshold = None, min_dim_size_to_factor = 3)),
    ('adafactor', dict(lr = 1e-2, factored = False, multiply_by_parameter_scale = False)),
    ('adafactor', dict(lr = 1e-2, lr_scheduler = {'name': 'DivideByStep', 'maxval': 1e-2}))],
    ids = lambda v: v if isinstance(v, str) else '-'.join(sorted(v)))
def test_three_steps_match_optax(name, kwargs):
    rng = np.random.default_rng(0)
    weights = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10. ** rng.uniform(-4, 0, s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    tx = joptimizers.get_optimizer(name, ** kwargs)
    w = {k: jnp.asarray(v) for k, v in weights.items()}
    state = tx.init(w)
    params = {k: torch.tensor(v, requires_grad = True) for k, v in weights.items()}
    opt = optimizers.get_optimizer(name, ** kwargs).init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, w)
        w = optax.apply_updates(w, updates)
        for k, t in params.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k, ref in w.items():
        ref = np.asarray(ref)
        moved = np.abs(ref - weights[k]).max()
        assert moved > 0, k
        diff = np.abs(params[k].detach().numpy() - ref).max()
        assert diff <= 1e-6 * np.abs(ref).max(), (k, diff, moved)


def test_registries_and_state_round_trip():
    assert optimizers.list_optimizers() == joptimizers.list_optimizers()
    assert optimizers.list_schedulers() == joptimizers.list_schedulers()
    params = {k: torch.ones(s, requires_grad = True) for k, s in SHAPES.items()}
    opt = optimizers.get_optimizer('adafactor', lr = 1e-2).init(params)
    for t in params.values():
        t.grad = torch.full_like(t, 0.5)
    opt.step()
    again = optimizers.get_optimizer('adafactor', lr = 1e-2).init(params)
    again.load_state_arrays(opt.state_arrays())
    for a, b in zip(again.torch.state_dict()['state'].values(),
                    opt.torch.state_dict()['state'].values()):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)

    @optimizers.register_optimizer('halving', factor = 0.5)
    class Halving(torch.optim.Optimizer):
        def __init__(self, params, lr = 1e-3, factor = 1.):
            super().__init__(params, dict(lr = lr, factor = factor))

        @torch.no_grad()
        def step(self):
            for group in self.param_groups:
                for p in group['params']:
                    p.mul_(group['factor'])

    try:
        t = torch.ones(2, requires_grad = True)
        opt = optimizers.get_optimizer('Halving').init({'t': t})
        t.grad = torch.zeros(2)
        opt.step()
        assert torch.equal(t.detach(), torch.full((2,), 0.5))
        with pytest.raises(TypeError, match = 'unexpected'):
            optimizers.get_optimizer('halving', momentum = 0.9)
        assert 'halving' in optimizers.list_optimizers()
    finally:
        for table in (optimizers._OPTIMIZERS, optimizers._AT_DEFAULT, optimizers._OPTAX_KEYWORDS):
            table.pop('halving')
    with pytest.raises(ValueError, match = 'mask'):
        optimizers.get_optimizer('lion', mask = {'a': True})


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    assert metrics.list_metrics() == jmetrics.list_metrics()
    labels = rng.integers(0, 5, 64)
    logits = rng.standard_normal((64, 5))
    probs = rng.uniform(size = 64)
    binary = rng.integers(0, 2, 64)
    same = rng.integers(0, 2, 200)
    scores = rng.standard_normal(200) + same
    texts = ['The cat sat on the mat.', 'Hello, world!', 'a b c d', '']
    preds = ['the cat sat on a mat', 'hello world', 'a c d e', 'x']
    mel_a = rng.standard_normal((40, 80)).astype(np.float32) - 5.
    mel_b = mel_a[3:] + 0.1 * rng.standard_normal((37, 80)).astype(np.float32)
    cases = [
        ('accuracy', (labels, logits), {}), ('accuracy', (labels, labels[::-1]), {}),
        ('binary_accuracy', (binary, probs), {}), ('binary_accuracy', (binary, probs),
                                                   {'threshold': 0.3}),
        ('eer', (same, scores), {}), ('exact_match', (texts, preds), {}),
        ('exact_match', (texts[1], 'hello world'), {'normalize': False}),
        ('f1', (texts, preds), {}), ('wer', (texts, preds), {}), ('cer', (texts, preds), {}),
        ('mcd', (mel_a, mel_b), {}), ('mcd', (mel_a, mel_b), {'align': 'dtw'}),
        ('mcd', (mel_a, mel_a), {'exclude_c0': False, 'n_mfcc': 20}),
        ('mel_snr', (mel_a, mel_b), {}),
    ]
    for name, args, kwargs in cases:
        out = metrics.get_metric(name, ** kwargs)(* args)
        ref = jmetrics.get_metric(name, ** kwargs)(* args)
        assert abs(out - ref) <= 1e-6 * max(1., abs(ref)), (name, kwargs, out, ref)
    assert metrics.get_metric({'name': 'binary_accuracy', 'threshold': 0.3})(binary, probs) \
        == jmetrics.get_metric({'name': 'binary_accuracy', 'threshold': 0.3})(binary, probs)
    by_r = {1: {'mcd_db': 4.0}, 2: {'mcd_db': 4.3}, 3: {'mcd_db': 4.6}, 4: {'mcd_db': 4.4}}
    for kw in ({}, {'max_mcd_penalty_db': 0.2}, {'max_mcd_penalty_db': 1.}):
        assert metrics.choose_reduction_factor(by_r, ** kw) \
            == jmetrics.choose_reduction_factor(by_r, ** kw)
    with pytest.raises(ValueError, match = 'r=1'):
        metrics.choose_reduction_factor({2: {'mcd_db': 1.}})
    with pytest.raises(ValueError, match = 'Unknown metric'):
        metrics.get_metric('bleu')
