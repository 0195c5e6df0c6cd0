"""Mixed-precision training policy: a compute dtype over float32 master params.

Counterpart of ``text_to_speech_tpu/train/precision.py``.  Params stay
float32 masters (the optimizer state, the updates and the checkpoints are
exact, and gradients arrive in float32: the cast's backward casts them up);
the train step casts params and float inputs to the compute dtype at the
loss boundary; the sums that decide loss values stay float32 in the
architectures.  bfloat16 shares float32's exponent range, so there is no
loss scaling.  ``fit(..., precision='mixed_bfloat16')`` selects it per run,
`set_global_policy` for the process.
"""

import threading
from dataclasses import dataclass

import torch

__all__ = ['Policy', 'get_policy', 'set_global_policy', 'get_global_policy',
           'cast_floating', 'compute_dtype']


@dataclass(frozen = True)
class Policy:
    """A training dtype policy."""
    name: str
    compute_dtype: str = 'float32'
    param_dtype: str = 'float32'

    @property
    def is_mixed(self):
        return self.compute_dtype != self.param_dtype


_POLICIES = {
    'float32': Policy('float32'),
    'mixed_bfloat16': Policy('mixed_bfloat16', compute_dtype = 'bfloat16'),
    # bf16 params would degrade the Adam moments for no extra rate over the
    # mixed policy: the name maps to it
    'bfloat16': Policy('mixed_bfloat16', compute_dtype = 'bfloat16'),
}

_lock = threading.Lock()
_global_policy = _POLICIES['float32']


def get_policy(policy = None):
    """Resolve `policy` (None → the global policy; str → by name)."""
    if policy is None:
        return _global_policy
    if isinstance(policy, Policy):
        return policy
    try:
        return _POLICIES[str(policy)]
    except KeyError:
        raise ValueError('unknown precision policy {!r} (known: {})'.format(
            policy, sorted(_POLICIES)))


def set_global_policy(policy):
    """Install the process-wide default policy; returns it."""
    global _global_policy
    resolved = get_policy(policy if policy is not None else 'float32')
    with _lock:
        _global_policy = resolved
    return resolved


def get_global_policy():
    return _global_policy


def compute_dtype(policy):
    """The torch dtype a mixed policy computes in, None for float32."""
    policy = get_policy(policy)
    return getattr(torch, policy.compute_dtype) if policy.is_mixed else None


def cast_floating(tree, dtype, exempt = ()):
    """Cast every floating-point tensor of a tree of dicts, tuples and lists
    to `dtype`; other leaves (None among them), and every leaf under a dict
    key in `exempt`, pass through."""
    if isinstance(tree, dict):
        return {k: v if k in exempt else cast_floating(v, dtype, exempt)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype, exempt) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point() and tree.dtype != dtype:
        return tree.to(dtype)
    return tree
