"""Optimizers and learning-rate schedules on `torch.optim`.

Counterpart of ``text_to_speech_tpu/train/optimizers.py`` (optax there).
`get_optimizer` returns an `OptimizerConfig`, which, like an optax
transformation, holds no state: ``config.init(params)`` binds it to a tree
of parameter tensors and returns the stateful `Optimizer`.  Names with a
`torch.optim` counterpart are ported, with optax's default constants:

  - ``adam``: b1 0.9, b2 0.999, eps 1e-8 outside the square root (optax's
    and torch's formula alike);
  - ``adamw``: the same, weight decay 1e-4 (optax's default), decoupled and
    applied to the parameter before the step in both;
  - ``sgd``: no momentum;
  - ``rmsprop``: optax's `scale_by_rms` in the port's own `RMSprop`
    (decay 0.9, eps 1e-8 inside the square root, initial second moment 0);
    `torch.optim.RMSprop` adds eps outside the square root, where it damps
    nothing: a gradient far under sqrt(eps) moves its weight as far as a
    large one;
  - ``adagrad``: initial accumulator 0.1, eps 1e-7, which torch adds
    outside the square root and optax's `scale_by_rss` inside: with the
    accumulator at 0.1 or more the updates differ in float32 noise only.

``adafactor`` and ``lion`` have no `torch.optim` counterpart and raise.  A
schedule is evaluated at optax's step count (0 for the first update), and
``clip_norm`` clips the global norm of the gradients, as optax's
`clip_by_global_norm`, before the update.  ``weight_decay`` is taken by
``adamw`` only: the JAX package chains optax's `add_decayed_weights` after
the learning-rate-scaled update for the other names, which adds the decay
with the wrong sign (a zero gradient moves a weight of 1.0 to 1.1 at lr 1e-3
and decay 0.1), so the port refuses it.
"""

import math

import torch

_SCHEDULERS = {}


def register_scheduler(name):
    def deco(fn):
        _SCHEDULERS[name.lower()] = fn
        return fn
    return deco


@register_scheduler('DivideByStep')
def divide_by_step(maxval = 1e-3, minval = 1e-6, factor = 1., ** kwargs):
    return lambda step: max(maxval / (1. + factor * step), minval)


@register_scheduler('ReduceEvery')
def reduce_every(lr = 1e-3, every = 1000, factor = 0.5, minval = 1e-6, ** kwargs):
    return lambda step: max(lr * factor ** (step // every), minval)


@register_scheduler('WarmupScheduler')
def warmup_scheduler(factor = 1., warmup_steps = 4000, dim = 512, ** kwargs):
    """Transformer schedule: dim^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    def schedule(step):
        step = max(float(step), 1.)
        return factor * dim ** -0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)
    return schedule


@register_scheduler('SinScheduler')
def sin_scheduler(maxval = 1e-3, minval = 1e-5, period = 1000, ** kwargs):
    return lambda step: minval + (maxval - minval) * 0.5 * (
        1. + math.sin(2. * math.pi * step / period))


@register_scheduler('TanhDecayScheduler')
def tanh_decay_scheduler(maxval = 1e-3, minval = 1e-5, decay_steps = 10000, ** kwargs):
    return lambda step: maxval - (maxval - minval) * math.tanh(2. * step / decay_steps)


def get_scheduler(scheduler, ** kwargs):
    if callable(scheduler): return scheduler
    if isinstance(scheduler, dict):
        kwargs = {** scheduler, ** kwargs}
        scheduler = kwargs.pop('name', None) or kwargs.pop('class_name')
    key = scheduler.lower()
    if key not in _SCHEDULERS:
        raise ValueError('Unknown scheduler {!r} (known: {})'.format(
            scheduler, sorted(_SCHEDULERS)))
    return _SCHEDULERS[key](** kwargs)


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``: ``nu = decay * nu + (1 - decay) * g**2``, then
    ``p -= lr * g * rsqrt(nu + eps)`` (`scale_by_rms`, eps inside the
    square root, then the learning rate), in optax's order of operations."""

    def __init__(self, params, lr = 1e-3, decay = 0.9, eps = 1e-8, initial_scale = 0.):
        super().__init__(params, dict(lr = lr, decay = decay, eps = eps,
                                      initial_scale = initial_scale))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, eps, lr = group['decay'], group['eps'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'nu' not in state:
                    state['nu'] = torch.full_like(p, group['initial_scale'])
                g = p.grad
                nu = (1 - decay) * g ** 2 + decay * state['nu']
                state['nu'] = nu
                p.add_(torch.rsqrt(nu + eps) * g * -lr)


# name → (optimizer class, optax's default constants in its names)
_OPTIMIZERS = {
    'adam': (torch.optim.Adam, dict(betas = (0.9, 0.999), eps = 1e-8)),
    'adamw': (torch.optim.AdamW, dict(betas = (0.9, 0.999), eps = 1e-8,
                                      weight_decay = 1e-4)),
    'sgd': (torch.optim.SGD, dict(momentum = 0.)),
    'rmsprop': (RMSprop, dict(decay = 0.9, eps = 1e-8)),
    'adagrad': (torch.optim.Adagrad, dict(initial_accumulator_value = 0.1, eps = 1e-7)),
}
_NOT_PORTED = ('adafactor', 'lion')


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def global_norm(tensors):
    """sqrt of the sum of squares of every element (optax's `global_norm`)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class OptimizerConfig:
    """An optimizer without state: `init` binds it to parameters."""

    def __init__(self, name, lr, schedule = None, clip_norm = None, ** kwargs):
        self.name, self.lr, self.schedule, self.clip_norm = name, lr, schedule, clip_norm
        cls, defaults = _OPTIMIZERS[name]
        self.cls, self.kwargs = cls, {** defaults, ** kwargs}

    def init(self, params):
        """The stateful `Optimizer` over the tensors of `params` (a tree of
        dicts, walked in sorted key order), which it updates in place."""
        return Optimizer(self, _leaves(params))


class Optimizer:
    """`torch.optim` optimizer with an optax-style schedule and clip.

    `step` runs on the gradients in each parameter's ``.grad``; ``count`` is
    optax's update count."""

    def __init__(self, config, tensors):
        self.config = config
        self.tensors = tensors
        self.count = 0
        self.torch = config.cls(tensors, lr = self._lr(), ** config.kwargs)

    def _lr(self):
        schedule = self.config.schedule
        return float(schedule(self.count)) if schedule is not None else self.config.lr

    def zero_grad(self):
        self.torch.zero_grad(set_to_none = True)

    def step(self):
        clip = self.config.clip_norm
        if clip:
            grads = [t.grad for t in self.tensors if t.grad is not None]
            norm = global_norm(grads)
            scale = torch.where(norm > clip, clip / norm, torch.ones_like(norm))
            for g in grads:
                g.mul_(scale.to(g.dtype))
        for group in self.torch.param_groups:
            group['lr'] = self._lr()
        self.torch.step()
        self.count += 1

    # -- the port's checkpoint layout of the state -----------------------------

    def state_arrays(self):
        """{'count', 'state/<index>/<name>'}: numpy arrays of the state,
        indexed by the parameter's position in sorted-key order."""
        out = {'count': torch.tensor(self.count).numpy()}
        for index, state in self.torch.state_dict()['state'].items():
            for name, value in state.items():
                value = value if torch.is_tensor(value) else torch.tensor(value)
                out['state/{}/{}'.format(index, name)] = value.detach().cpu().numpy()
        return out

    def load_state_arrays(self, arrays):
        """Restore what `state_arrays` saved; raises ValueError when it does
        not fit these parameters."""
        state = {}
        for key, value in arrays.items():
            if key == 'count':
                continue
            _, index, name = key.split('/')
            index = int(index)
            if index >= len(self.tensors):
                raise ValueError('optimizer state for parameter {} of {}'.format(
                    index, len(self.tensors)))
            tensor = self.tensors[index]
            value = torch.as_tensor(value)
            if name != 'step' and tuple(value.shape) != tuple(tensor.shape):
                raise ValueError('optimizer state {} has shape {}, the parameter {}'
                                 .format(key, tuple(value.shape), tuple(tensor.shape)))
            state.setdefault(index, {})[name] = value
        saved = self.torch.state_dict()
        saved['state'] = state
        self.torch.load_state_dict(saved)
        self.count = int(arrays['count'])


def get_optimizer(optimizer = 'adam', *, lr = 1e-3, lr_scheduler = None, clip_norm = None,
                  weight_decay = None, ** kwargs):
    """An `OptimizerConfig` from a name (or the config itself).

    `lr_scheduler` is a schedule name, config or callable of the step;
    `clip_norm` adds global-norm clipping; `weight_decay` is decoupled decay,
    for ``adamw`` only; other keywords go to the optimizer class."""
    if isinstance(optimizer, OptimizerConfig):
        return optimizer
    schedule = get_scheduler(lr_scheduler) if lr_scheduler is not None else None
    key = optimizer.lower()
    if key in _NOT_PORTED:
        raise ValueError('optimizer {!r} has no torch.optim counterpart and is not '
                         'ported (known: {})'.format(optimizer, sorted(_OPTIMIZERS)))
    if key not in _OPTIMIZERS:
        raise ValueError('Unknown optimizer {!r} (known: {})'.format(
            optimizer, sorted(_OPTIMIZERS)))
    if weight_decay:
        if key != 'adamw':
            raise ValueError(
                'weight_decay is taken by adamw only: the JAX package adds it after '
                'the learning-rate-scaled update for {!r}, with the wrong sign; use '
                'adamw for decoupled weight decay'.format(optimizer))
        kwargs['weight_decay'] = weight_decay
    return OptimizerConfig(key, lr, schedule, clip_norm, ** kwargs)
