"""Per-call numpy / PyTorch ops dispatcher.

Counterpart of ``text_to_speech_tpu/xp.py``: ``xp.foo(x)`` runs the torch
function when any argument (or any item of a list or tuple argument) is a
torch tensor, and ``np.foo`` otherwise, so that utility code works on host
data without device round trips and on the port's tensors where they lie.

Usage::

    from text_to_speech_tpu_torch import xp
    y = xp.matmul(a, b)          # numpy or torch depending on the inputs
    xp.convert_to_tensor(x)      # onto the port's default device (cuda)
    xp.convert_to_numpy(x)       # onto the host

Where torch's signature differs from numpy's, a translation runs instead
(`_TORCH`): ``pad`` (numpy's pad-width pairs and ``constant_values`` →
`F.pad`), ``maximum`` and ``minimum`` with a Python scalar, ``asarray``
(a numpy dtype or its name).  Torch takes the rest as numpy does
(``axis=``, ``keepdims=``, ``concatenate``, ``where`` with scalars,
``clip``).  With a tensor among the arguments, a name torch lacks raises
`AttributeError`.
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .devices import default_device


def is_tensor(value):
    return torch.is_tensor(value)


def _any_tensor(args, kwargs):
    for value in itertools.chain(args, kwargs.values()):
        if torch.is_tensor(value):
            return value
        if isinstance(value, (list, tuple)):
            found = next((v for v in value if torch.is_tensor(v)), None)
            if found is not None:
                return found
    return None


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def convert_to_tensor(x, dtype = None, device = None):
    """`x` as a tensor of `dtype` on `device` (default: the port's default
    device, `devices.default_device`: cuda, raising without a GPU)."""
    return torch.as_tensor(x, dtype = _torch_dtype(dtype), device = default_device(device))


def convert_to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(value, ref):
    """A Python scalar as a tensor beside `ref` (tensors pass)."""
    if torch.is_tensor(value):
        return value
    return torch.as_tensor(value, dtype = ref.dtype if isinstance(value, float)
                           and ref.is_floating_point() else None, device = ref.device)


def _pad(x, pad_width, mode = 'constant', constant_values = 0):
    if mode != 'constant':
        raise ValueError('xp.pad on tensors takes mode="constant" only, got {!r}'.format(mode))
    pairs = np.broadcast_to(np.asarray(pad_width, dtype = np.int64), (x.ndim, 2))
    flat = [int(v) for pair in pairs[::-1] for v in pair]
    return F.pad(x, flat, value = constant_values)


def _asarray(x, dtype = None):
    if torch.is_tensor(x):
        return x if dtype is None else x.to(_torch_dtype(dtype))
    ref = _any_tensor((x,), {})
    if ref is not None:
        return torch.stack([_asarray(v, dtype) for v in x])
    return torch.as_tensor(x, dtype = _torch_dtype(dtype))


def _binary(fn):
    def apply(a, b, * args, ** kwargs):
        ref = a if torch.is_tensor(a) else b
        return fn(_like(a, ref), _like(b, ref), * args, ** kwargs)
    return apply


_TORCH = {
    'pad': _pad,
    'maximum': _binary(torch.maximum),
    'minimum': _binary(torch.minimum),
    'asarray': _asarray,
}


def __getattr__(name):
    if name.startswith('__'):
        raise AttributeError(name)

    def dispatched(* args, ** kwargs):
        if _any_tensor(args, kwargs) is not None:
            if name in _TORCH:
                return _TORCH[name](* args, ** kwargs)
            return getattr(torch, name)(* args, ** kwargs)
        return getattr(np, name)(* args, ** kwargs)

    dispatched.__name__ = name
    return dispatched
