"""Activations by name.

Counterpart of ``text_to_speech_tpu/nn/activations.py``, with its names:
``'gelu'`` is ``jax.nn.gelu``'s default, the tanh approximation, as is
``'gelu_new'``; ``'gelu_exact'`` is the erf form (BERT's and BART's FFN,
the MLM head's transform).  ``'softmax'`` and ``'glu'`` act on the last axis.
"""

import math

import torch
import torch.nn.functional as F


def l2_norm(x, axis = -1, epsilon = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim = axis, keepdim = True), min = epsilon)


def glu(x, axis = -1):
    a, b = torch.chunk(x, 2, dim = axis)
    return a * torch.sigmoid(b)


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


_ACTIVATIONS = {
    None: None,
    'linear': None,
    'relu': torch.relu,
    'relu6': F.relu6,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'softmax': lambda x: torch.softmax(x, dim = -1),
    'softplus': F.softplus,
    'silu': F.silu,
    'swish': F.silu,
    'gelu': lambda x: F.gelu(x, approximate = 'tanh'),
    'gelu_exact': F.gelu,
    'gelu_new': gelu_new,
    'quick_gelu': quick_gelu,
    'glu': glu,
    'elu': F.elu,
    'leaky_relu': F.leaky_relu,
    'l2_norm': l2_norm,
    'mish': mish,
}


def get_activation(name):
    """Resolve an activation by name (callables pass through)."""
    if callable(name): return name
    if isinstance(name, str): name = name.lower()
    if name in _ACTIVATIONS: return _ACTIVATIONS[name]
    raise ValueError('Unknown activation: {!r} (known: {})'.format(
        name, [k for k in _ACTIVATIONS if k]))
