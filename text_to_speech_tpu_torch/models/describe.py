"""Model description utilities.

Counterpart of ``text_to_speech_tpu/models/describe.py``: `describe_model`
summary strings, parameter counts and the sampling factors of a conv stack,
on trees of tensors or arrays.  For the same model the strings equal the
JAX package's.
"""

import numpy as np

from ..weights import flatten_tree


def count_params(tree):
    return int(sum(int(np.prod(np.shape(v))) for v in flatten_tree(tree).values()))


def summarize_tree(tree, max_depth = 2):
    """Per-subtree parameter counts: {'encoder': 1234, 'decoder/prenet': ...}."""
    flat = flatten_tree(tree)
    groups = {}
    for path, value in flat.items():
        key = '/'.join(path.split('/')[:max_depth])
        groups[key] = groups.get(key, 0) + int(np.prod(np.shape(value)))
    return dict(sorted(groups.items()))


def describe_model(model, max_depth = 2):
    """Human-readable summary of a task model or raw param tree."""
    if isinstance(model, dict):
        params, name, extra = model, 'params', {}
    else:
        params = model.params
        name = getattr(model, 'name', type(model).__name__)
        extra = {
            'class': type(model).__name__,
            'architecture': type(model.arch).__name__,
            'epochs trained': getattr(model, 'epochs', '?'),
        }

    lines = ['========== {} =========='.format(name)]
    for k, v in extra.items():
        lines.append('{} : {}'.format(k, v))
    total = count_params(params)
    lines.append('total parameters : {:,} ({:.1f} MB fp32)'.format(
        total, total * 4 / 1024 / 1024))
    lines.append('--- per component ---')
    for key, n in summarize_tree(params, max_depth).items():
        lines.append('  {:<40s} {:>12,}'.format(key, n))
    return '\n'.join(lines)


def infer_downsampling_factor(strides):
    """Total temporal downsampling of a conv stack (product of strides)."""
    factor = 1
    for s in strides:
        factor *= int(s[0] if isinstance(s, (tuple, list)) else s)
    return factor


def infer_upsampling_factor(strides):
    return infer_downsampling_factor(strides)
