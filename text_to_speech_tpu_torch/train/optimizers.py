"""Optimizers and learning-rate schedules on `torch.optim`.

Counterpart of ``text_to_speech_tpu/train/optimizers.py`` (optax there).
`get_optimizer` takes what the JAX one takes (a name, a dict config with
``name`` or ``class_name``, ``lr`` or ``learning_rate``, ``lr_scheduler``,
``clip_norm``, ``weight_decay`` and optax's keywords for the optimizer) and
returns an `OptimizerConfig`, which, like an optax transformation, holds no
state: ``config.init(params)`` binds it to a tree of parameter tensors and
returns the stateful `Optimizer`.  Names with a `torch.optim` counterpart
are ported, with optax's default constants, and optax's keywords map onto
the classes:

  - ``adam``: optax's `adam` in the port's own `Adam` (``b1`` 0.9, ``b2``
    0.999, ``eps`` 1e-8, ``eps_root`` 0, ``nesterov``), in optax's order of
    operations, with optax's float32 bias correction: `torch.optim.Adam`
    rounds elsewhere and lands 3e-7 from optax after three steps at lr 1e-2;
    ``mu_dtype`` only as None;
  - ``adamw``: the same plus ``weight_decay`` (1e-4, optax's default),
    optax's `add_decayed_weights` before the learning rate; ``mask`` only as
    None;
  - ``sgd``: ``momentum`` (None: none) and ``nesterov``, optax's `trace`
    before the learning rate as torch's buffer; ``accumulator_dtype`` only
    as None;
  - ``rmsprop``: optax's whole `rmsprop` in the port's own `RMSprop`
    (``decay`` 0.9, ``eps`` 1e-8 inside the square root, ``initial_scale``
    0, ``eps_in_sqrt``, ``centered``, ``momentum``, ``nesterov``,
    ``bias_correction``), in optax's order of operations.
    `torch.optim.RMSprop` adds eps outside the square root, where it damps
    nothing: a gradient far under sqrt(eps) moves its weight as far as a
    large one;
  - ``adagrad``: ``initial_accumulator_value`` 0.1, ``eps`` 1e-7, which
    torch adds outside the square root and optax's `scale_by_rss` inside:
    with the accumulator at 0.1 or more the updates differ in float32 noise
    only.

  - ``lion``: optax's `lion` in the port's own `Lion` (``b1`` 0.9, ``b2``
    0.99, its own ``weight_decay`` 1e-3, which `get_optimizer` cannot
    change, as in the JAX package); ``mu_dtype`` and ``mask`` only as None;
  - ``adafactor``: optax's `adafactor` in the port's own `Adafactor`
    (factored second moments of the dims of 128 and more, ``decay_rate``
    0.8, ``eps`` 1e-30, block-RMS clipping at 1, the learning rate, the
    parameter-scale step, optional ``momentum`` and ``weight_decay_rate``),
    in optax's order; ``dtype_momentum`` is a torch dtype,
    ``weight_decay_mask`` only None.

`register_optimizer` adds a class, `list_optimizers` and `list_schedulers`
name what there is.  A
schedule is evaluated at optax's step count (0 for the first update), and
``clip_norm`` clips the global norm of the gradients, as optax's
`clip_by_global_norm`, before the update.  ``weight_decay`` is taken by
``adamw`` only: the JAX package chains optax's `add_decayed_weights` after
the learning-rate-scaled update for the other names, which adds the decay
with the wrong sign (a zero gradient moves a weight of 1.0 to 1.1 at lr 1e-3
and decay 0.1), so the port refuses it.
"""

import inspect
import math

import numpy as np
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


def _bias_correction(decay, count):
    """``1 - decay**count`` in float32, as optax computes it."""
    return 1 - torch.tensor(decay, dtype = torch.float32) ** count


class Adam(torch.optim.Optimizer):
    """optax's ``adam`` (and ``adamw``), in its order of operations:
    `scale_by_adam` (``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g**2
    + b2 * nu``, each divided by its bias correction ``1 - b**count`` in
    float32; with `nesterov` the first moment is ``b1 * mu / (1 -
    b1**(count + 1)) + (1 - b1) * g / (1 - b1**count)``; then ``mu_hat /
    (sqrt(nu_hat + eps_root) + eps)``), plus ``weight_decay * p`` (adamw's
    `add_decayed_weights`), times ``-lr``."""

    def __init__(self, params, lr = 1e-3, b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0.,
                 nesterov = False, weight_decay = 0.):
        super().__init__(params, dict(lr = lr, b1 = b1, b2 = b2, eps = eps, eps_root = eps_root,
                                      nesterov = nesterov, weight_decay = weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2, lr = group['b1'], group['b2'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'mu' not in state:
                    state.update(mu = torch.zeros_like(p), nu = torch.zeros_like(p),
                                 step = torch.zeros(()))
                g = p.grad
                state['mu'] = mu = (1 - b1) * g + b1 * state['mu']
                state['nu'] = nu = (1 - b2) * g ** 2 + b2 * state['nu']
                state['step'] += 1
                count = state['step']
                if group['nesterov']:
                    mu_hat = (b1 * (mu / _bias_correction(b1, count + 1))
                              + (1 - b1) * (g / _bias_correction(b1, count)))
                else:
                    mu_hat = mu / _bias_correction(b1, count)
                nu_hat = nu / _bias_correction(b2, count)
                u = mu_hat / (torch.sqrt(nu_hat + group['eps_root']) + group['eps'])
                if group['weight_decay']:
                    u = u + group['weight_decay'] * p
                p.add_(u * -lr)


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``, in its order of operations: `scale_by_rms`
    (``nu = (1 - decay) * g**2 + decay * nu``; centered, `scale_by_stddev`,
    which also keeps ``mu`` and uses ``nu - mu**2``; both optionally bias
    corrected), the scaling ``rsqrt(nu + eps)`` (or ``1 / (sqrt(nu) + eps)``
    without `eps_in_sqrt`) times g, times ``-lr``, then optax's `trace` with
    `momentum` (``t = u + momentum * t``; with `nesterov` the update is
    ``u + momentum * t``)."""

    def __init__(self, params, lr = 1e-3, decay = 0.9, eps = 1e-8, initial_scale = 0.,
                 eps_in_sqrt = True, centered = False, momentum = None, nesterov = False,
                 bias_correction = False):
        super().__init__(params, dict(
            lr = lr, decay = decay, eps = eps, initial_scale = initial_scale,
            eps_in_sqrt = eps_in_sqrt, centered = centered, momentum = momentum,
            nesterov = nesterov, bias_correction = bias_correction))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, eps, lr = group['decay'], group['eps'], group['lr']
            momentum = group['momentum']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'nu' not in state:
                    state['nu'] = torch.full_like(p, group['initial_scale'])
                    if group['centered']: state['mu'] = torch.zeros_like(p)
                    if momentum is not None: state['trace'] = torch.zeros_like(p)
                    if group['bias_correction']: state['step'] = torch.zeros(())
                g = p.grad
                nu = (1 - decay) * g ** 2 + decay * state['nu']
                state['nu'] = nu
                if group['centered']:
                    mu = (1 - decay) * g + decay * state['mu']
                    state['mu'] = mu
                if group['bias_correction']:
                    state['step'] += 1
                    correction = _bias_correction(decay, state['step'])
                    nu = nu / correction
                    if group['centered']: mu = mu / correction
                if group['centered']:
                    nu = nu - mu * mu
                scaling = (torch.rsqrt(nu + eps) if group['eps_in_sqrt']
                           else 1 / (torch.sqrt(nu) + eps))
                u = scaling * g * -lr
                if momentum is not None:
                    trace = u + momentum * state['trace']
                    state['trace'] = trace
                    u = u + momentum * trace if group['nesterov'] else trace
                p.add_(u)


class Lion(torch.optim.Optimizer):
    """optax's ``lion``, in its order of operations: `scale_by_lion`
    (``u = sign((1 - b1) * g + b1 * mu)``, then ``mu = (1 - b2) * g + b2 *
    mu``), plus ``weight_decay * p`` (`add_decayed_weights`), times
    ``-lr``."""

    def __init__(self, params, lr = 1e-3, b1 = 0.9, b2 = 0.99, weight_decay = 1e-3):
        super().__init__(params, dict(lr = lr, b1 = b1, b2 = b2, weight_decay = weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2, lr = group['b1'], group['b2'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'mu' not in state:
                    state['mu'] = torch.zeros_like(p)
                g = p.grad
                u = torch.sign((1. - b1) * g + b1 * state['mu'])
                state['mu'] = (1 - b2) * g + b2 * state['mu']
                if group['weight_decay']:
                    u = u + group['weight_decay'] * p
                p.add_(u * -lr)


def _factored_dims(shape, factored, min_dim_size_to_factor):
    """optax's choice: the largest dim and the second largest, when the
    second reaches `min_dim_size_to_factor`, → (d1 second, d0 largest)."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """optax's ``adafactor``, in its order of operations:
    `scale_by_factored_rms` (decay ``1 - (step + 1 - decay_offset) **
    -decay_rate`` in float32; a parameter with two dims of at least
    `min_dim_size_to_factor` keeps a row and a column mean of ``g**2 +
    eps``, another the whole ``g**2 + eps``; the update ``g`` over their
    square root), `clip_by_block_rms` (``u / max(1, rms(u) /
    clipping_threshold)``), times ``lr``, `scale_by_param_block_rms` (times
    ``max(rms(p), 1e-3)``) with `multiply_by_parameter_scale`, an `ema` of
    the updates with `momentum` (not debiased), ``weight_decay_rate * p``,
    then times -1."""

    def __init__(self, params, lr = 1e-3, min_dim_size_to_factor = 128, decay_rate = 0.8,
                 decay_offset = 0, multiply_by_parameter_scale = True,
                 clipping_threshold = 1.0, momentum = None, dtype_momentum = torch.float32,
                 weight_decay_rate = None, eps = 1e-30, factored = True):
        super().__init__(params, dict(
            lr = lr, min_dim_size_to_factor = min_dim_size_to_factor, decay_rate = decay_rate,
            decay_offset = decay_offset, multiply_by_parameter_scale = multiply_by_parameter_scale,
            clipping_threshold = clipping_threshold, momentum = momentum,
            dtype_momentum = dtype_momentum, weight_decay_rate = weight_decay_rate, eps = eps,
            factored = factored))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'step' not in state:
                    state['step'] = torch.zeros(())
                g = p.grad
                t = (state['step'] - group['decay_offset'] + 1).float()
                decay = 1. - t ** -group['decay_rate']
                dims = _factored_dims(tuple(p.shape), group['factored'],
                                      group['min_dim_size_to_factor'])
                grad_sqr = g * g + group['eps']
                if dims is not None:
                    d1, d0 = dims
                    row_mean = torch.mean(grad_sqr, dim = d0)
                    col_mean = torch.mean(grad_sqr, dim = d1)
                    if 'v_row' not in state:
                        state['v_row'] = torch.zeros_like(row_mean)
                        state['v_col'] = torch.zeros_like(col_mean)
                    v_row = decay * state['v_row'] + (1. - decay) * row_mean
                    v_col = decay * state['v_col'] + (1. - decay) * col_mean
                    state['v_row'], state['v_col'] = v_row, v_col
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = torch.mean(v_row, dim = reduced_d1, keepdim = True)
                    row_factor = (v_row / row_col_mean) ** -0.5
                    col_factor = v_col ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    if 'v' not in state:
                        state['v'] = torch.zeros_like(p)
                    v = decay * state['v'] + (1. - decay) * grad_sqr
                    state['v'] = v
                    u = g * v ** -0.5
                state['step'] += 1
                if group['clipping_threshold'] is not None:
                    u = u / torch.clamp(_rms(u) / group['clipping_threshold'], min = 1.)
                u = u * group['lr']
                if group['multiply_by_parameter_scale']:
                    rms = _rms(p)
                    u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
                if group['momentum'] is not None:
                    if 'momentum' not in state:
                        state['momentum'] = torch.zeros_like(p, dtype = group['dtype_momentum'])
                    u = ((1 - group['momentum']) * u + group['momentum'] * state['momentum']).to(
                        group['dtype_momentum'])
                    state['momentum'] = u
                if group['weight_decay_rate'] is not None:
                    u = u + group['weight_decay_rate'] * p
                p.add_(u * -1)


# name → (optimizer class, optax's default constants in the class's names)
_OPTIMIZERS = {
    'adam': (Adam, dict(b1 = 0.9, b2 = 0.999, eps = 1e-8)),
    'adamw': (Adam, dict(b1 = 0.9, b2 = 0.999, eps = 1e-8, weight_decay = 1e-4)),
    'sgd': (torch.optim.SGD, dict(momentum = 0.)),
    'rmsprop': (RMSprop, dict(decay = 0.9, eps = 1e-8)),
    'adagrad': (torch.optim.Adagrad, dict(initial_accumulator_value = 0.1, eps = 1e-7)),
    'lion': (Lion, dict(b1 = 0.9, b2 = 0.99, weight_decay = 1e-3)),
    'adafactor': (Adafactor, {}),
}
# optax's keywords that the classes have no counterpart for, and the
# only value each may take
_AT_DEFAULT = {
    'adam': dict(mu_dtype = None),
    'adamw': dict(mu_dtype = None, mask = None),
    'sgd': dict(accumulator_dtype = None),
    'rmsprop': {}, 'adagrad': {},
    'lion': dict(mu_dtype = None, mask = None),
    'adafactor': dict(weight_decay_mask = None),
}
_OPTAX_KEYWORDS = {
    'adam': ('b1', 'b2', 'eps', 'eps_root', 'nesterov'),
    'adamw': ('b1', 'b2', 'eps', 'eps_root', 'nesterov', 'weight_decay'),
    'sgd': ('momentum', 'nesterov'),
    'rmsprop': ('decay', 'eps', 'initial_scale', 'eps_in_sqrt', 'centered', 'momentum',
                'nesterov', 'bias_correction'),
    'adagrad': ('initial_accumulator_value', 'eps'),
    'lion': ('b1', 'b2', 'weight_decay'),
    'adafactor': ('min_dim_size_to_factor', 'decay_rate', 'decay_offset',
                  'multiply_by_parameter_scale', 'clipping_threshold', 'momentum',
                  'dtype_momentum', 'weight_decay_rate', 'eps', 'factored'),
}


def register_optimizer(name, ** defaults):
    """Register an optimizer class under `name`: a `torch.optim.Optimizer`
    taking ``(params, lr, ** keywords)``; `defaults` are its constants
    where `get_optimizer` is not given them."""
    def deco(cls):
        key = name.lower()
        _OPTIMIZERS[key] = (cls, defaults)
        _AT_DEFAULT[key] = {}
        _OPTAX_KEYWORDS[key] = tuple(
            k for k in inspect.signature(cls.__init__).parameters
            if k not in ('self', 'params', 'lr'))
        return cls
    return deco


def list_optimizers():
    return sorted(_OPTIMIZERS)


def list_schedulers():
    return sorted(_SCHEDULERS)


def _class_keywords(key, kwargs):
    """optax's keywords of optimizer `key` → its class's; raises
    TypeError for a keyword optax's constructor does not take, ValueError for
    one the class cannot honour."""
    out = {}
    for name, value in kwargs.items():
        if name in _AT_DEFAULT[key]:
            if value != _AT_DEFAULT[key][name]:
                raise ValueError('{}={!r} has no counterpart in torch.optim for {!r}; only '
                                 '{!r} is ported'.format(name, value, key,
                                                         _AT_DEFAULT[key][name]))
        elif name not in _OPTAX_KEYWORDS[key]:
            raise TypeError('optax.{} got an unexpected keyword argument {!r}'.format(key, name))
        elif key == 'sgd' and name == 'momentum':
            out['momentum'] = 0. if value is None else value
        else:
            out[name] = value
    return out


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

    def state_arrays(self, host = True):
        """{'count', 'state/<index>/<name>'}: numpy arrays of the state,
        indexed by the parameter's position in sorted-key order; with `host`
        False the state's own tensors, left where they are (for
        `AsyncCheckpointSaver`, which copies them)."""
        out = {'count': torch.tensor(self.count).numpy()}
        for index, state in self.torch.state_dict()['state'].items():
            for name, value in state.items():
                value = (value if torch.is_tensor(value) else torch.tensor(value)).detach()
                out['state/{}/{}'.format(index, name)] = value.cpu().numpy() if host else value
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
            # the step count and Adafactor's factored means are not parameter-shaped
            if name not in ('step', 'v_row', 'v_col') \
                    and tuple(value.shape) != tuple(tensor.shape):
                raise ValueError('optimizer state {} has shape {}, the parameter {}'
                                 .format(key, tuple(value.shape), tuple(tensor.shape)))
            state.setdefault(index, {})[name] = value
        saved = self.torch.state_dict()
        saved['state'] = state
        self.torch.load_state_dict(saved)
        self.count = int(arrays['count'])


def get_optimizer(optimizer = 'adam', *, lr = None, learning_rate = None,
                  lr_scheduler = None, clip_norm = None, weight_decay = None, ** kwargs):
    """An `OptimizerConfig` from a name, a dict config (``name`` or
    ``class_name``, the rest as keywords) or the config itself.

    The learning rate is `learning_rate`, else `lr`, else 1e-3, as in the
    JAX package; `lr_scheduler` (a schedule name, config or callable of the
    step) overrides both.  `clip_norm` adds global-norm clipping;
    `weight_decay` is decoupled decay, for ``adamw`` only; other keywords
    are optax's for the optimizer (module docstring)."""
    if isinstance(optimizer, OptimizerConfig):
        return optimizer
    if isinstance(optimizer, dict):
        kwargs = {** optimizer, ** kwargs}
        optimizer = kwargs.pop('name', kwargs.pop('class_name', 'adam'))
    learning_rate = learning_rate if learning_rate is not None else (lr or 1e-3)
    schedule = get_scheduler(lr_scheduler) if lr_scheduler is not None else None
    key = optimizer.lower()
    if key not in _OPTIMIZERS:
        raise ValueError('Unknown optimizer {!r} (known: {})'.format(
            optimizer, sorted(_OPTIMIZERS)))
    if weight_decay is not None:
        if key == 'adamw':
            kwargs['weight_decay'] = weight_decay
        elif weight_decay:
            raise ValueError(
                'weight_decay is taken by adamw only: the JAX package adds it after '
                'the learning-rate-scaled update for {!r}, with the wrong sign; use '
                'adamw for decoupled weight decay'.format(optimizer))
    return OptimizerConfig(key, learning_rate, schedule, clip_norm,
                           ** _class_keywords(key, kwargs))
