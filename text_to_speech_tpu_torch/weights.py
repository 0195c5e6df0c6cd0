"""The weight bridge: the JAX package's parameter trees → the port's.

The JAX package stores parameter trees as ``.npz`` files of ``/``-joined
flat paths (``text_to_speech_tpu/train/checkpoint.py``).  `load_tree` reads
them without JAX.  `convert_tree` (FastSpeech-2's params and state, the
HiFi-GAN discriminators: a grouped conv's kernel (W, in / groups, out)
becomes (out, in / groups, W) as any conv's),
`tacotron2_from_jax`, `waveglow_from_jax`, `hifigan_from_jax` (HiFi-GAN's
and Vocos's params), `vits_from_jax`, `transformer_from_jax` (the
transformer zoo and its heads: MoE experts stacked as ``weight (E, out,
in)``) and `audio_encoder_from_jax` turn those trees (nested dicts of numpy arrays)
into nested dicts of torch tensors in the layouts `nn.layers` takes
(`tree_to_jax` and the ``*_to_jax`` functions go back; a bare array, such
as VITS's relative tables or Vocos's layer scale, stays an array):

  - conv ``kernel (W, in, out)``           → ``weight (out, in, W)``
  - conv-transpose ``kernel (W, in, out)`` → ``weight (in, out, W)``, taps
    flipped (``lax.conv_transpose`` applies its kernel unflipped)
  - dense ``kernel (in, out)``              → ``weight = kernel.T``; WaveGlow's
    1×1 invertible conv ``(c, c)`` maps the same way
  - LSTM ``kernel`` / ``recurrent_kernel`` / ``bias`` → ``weight_ih`` /
    ``weight_hh`` / one fused ``bias``
  - batch and layer norm ``gamma``/``beta`` → ``weight``/``bias``; the running
    statistics ``moving_mean``/``moving_var`` → ``running_mean``/``running_var``
    (a separate state tree, as in the JAX package)
  - embedding ``embeddings`` → ``weight``
"""

import re

import numpy as np
import torch


def flatten_tree(tree, prefix = '', sep = '/'):
    """Nested dicts of arrays → flat {'a/b/c': array}."""
    flat = {}
    for key, value in tree.items():
        path = '{}{}{}'.format(prefix, sep if prefix else '', key)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path, sep))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat, sep = '/'):
    tree = {}
    for path, value in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_tree(filename):
    """A JAX-package ``.npz`` tree → nested dicts of numpy arrays."""
    with np.load(filename) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat)


def _tensor(array):
    return torch.from_numpy(np.array(array, dtype = np.float32, order = 'C'))


def _convert_leaf_dict(node):
    """One layer's parameter dict, recognised by its keys."""
    keys = set(node)
    if 'recurrent_kernel' in keys:
        return {'weight_ih': _tensor(np.asarray(node['kernel']).T),
                'weight_hh': _tensor(np.asarray(node['recurrent_kernel']).T),
                'bias': _tensor(node['bias'])}
    if 'embeddings' in keys:
        return {'weight': _tensor(node['embeddings'])}
    if keys == {'gamma', 'beta'}:
        return {'weight': _tensor(node['gamma']), 'bias': _tensor(node['beta'])}
    if keys == {'moving_mean', 'moving_var'}:
        return {'running_mean': _tensor(node['moving_mean']),
                'running_var': _tensor(node['moving_var'])}
    if 'kernel' in keys and keys <= {'kernel', 'bias'}:
        kernel = np.asarray(node['kernel'])
        if kernel.ndim == 2:
            out = {'weight': _tensor(kernel.T)}
        elif kernel.ndim == 3:
            out = {'weight': _tensor(np.transpose(kernel, (2, 1, 0)))}
        else:
            raise ValueError('unexpected kernel rank {}'.format(kernel.ndim))
        if 'bias' in node:
            out['bias'] = _tensor(node['bias'])
        return out
    return None


def convert_tree(tree):
    """Walk a JAX parameter or state tree and convert every layer dict."""
    if not isinstance(tree, dict):
        return _tensor(tree)
    converted = _convert_leaf_dict(tree) \
        if all(not isinstance(v, dict) for v in tree.values()) else None
    if converted is not None:
        return converted
    return {k: convert_tree(v) for k, v in tree.items()}


def conv_transpose_from_jax(node):
    """``lax.conv_transpose`` kernel (W, in, out) → ``ConvTranspose1d``
    weight (in, out, W) with the taps flipped."""
    kernel = np.asarray(node['kernel'])[::-1]
    out = {'weight': _tensor(np.transpose(kernel, (1, 2, 0)))}
    if 'bias' in node:
        out['bias'] = _tensor(node['bias'])
    return out


def tacotron2_from_jax(params, state):
    """JAX Tacotron-2 (params, state) trees → the port's (params, state)."""
    return convert_tree(params), convert_tree(state)


def audio_encoder_from_jax(params, state):
    """JAX speaker encoder (params, state) → the port's; the GE2E scalars
    ``ge2e/w`` and ``ge2e/b`` become 0-d tensors."""
    return convert_tree(params), convert_tree(state)


def waveglow_from_jax(params):
    """JAX WaveGlow params tree → the port's params."""
    out = {k: convert_tree(v) for k, v in params.items() if k != 'upsample'}
    out['upsample'] = conv_transpose_from_jax(params['upsample'])
    return out


# a stage of the HiFi-GAN generator: ``up{i}``, its transposed conv ``up``
# beside the resblocks
_HIFIGAN_STAGE = re.compile(r'up\d+')


def hifigan_from_jax(params):
    """JAX HiFi-GAN generator params → the port's: each stage's transposed
    conv ``up`` through `conv_transpose_from_jax`, the rest `convert_tree`
    (all of a Vocos tree, which has no stage)."""
    return {k: {n: conv_transpose_from_jax(v) if n == 'up' else convert_tree(v)
                for n, v in node.items()}
            if _HIFIGAN_STAGE.fullmatch(k) else convert_tree(node)
            for k, node in params.items()}


def vits_from_jax(params):
    """JAX VITS params → the port's: the generator through
    `hifigan_from_jax`, the rest `convert_tree`."""
    out = convert_tree({k: v for k, v in params.items() if k != 'generator'})
    out['generator'] = hifigan_from_jax(params['generator'])
    return out


def _experts_from_jax(node):
    """Stacked expert kernels (E, in, out) → ``weight (E, out, in)``, each
    expert's in `nn.dense`'s layout (`convert_tree` would take a 3-D kernel
    for a conv)."""
    return {name: {'weight': _tensor(np.transpose(np.asarray(leaf['kernel']), (0, 2, 1)))}
            for name, leaf in node.items()}


def transformer_from_jax(params):
    """A JAX `Transformer` tree (one stack, an encoder-decoder's
    ``{'encoder', 'decoder'}`` or a task head) → the port's: `convert_tree`
    for every layer, an rms norm's ``{'gamma'}`` kept as it is, a relative
    bias table ``{'embeddings'}`` → ``{'weight'}`` as any embedding, and the
    stacked experts ``(E, in, out)`` → ``weight (E, out, in)``."""
    if not isinstance(params, dict) or all(not isinstance(v, dict) for v in params.values()):
        return convert_tree(params)
    return {k: _experts_from_jax(v) if k == 'experts' else transformer_from_jax(v)
            for k, v in params.items()}


def _array(tensor):
    # a copy: a CPU tensor's numpy view would follow the in-place updates of
    # training into a checkpoint still being written
    return tensor.detach().cpu().float().numpy().copy()


def _conv_to_jax(node):
    """One converted layer dict back to the JAX layout (the inverse of
    `_convert_leaf_dict` for dense, conv and 1×1 invertible conv weights)."""
    weight = _array(node['weight'])
    if weight.ndim == 2:
        out = {'kernel': np.ascontiguousarray(weight.T)}
    elif weight.ndim == 3:
        out = {'kernel': np.ascontiguousarray(np.transpose(weight, (2, 1, 0)))}
    else:
        raise ValueError('unexpected weight rank {}'.format(weight.ndim))
    if 'bias' in node:
        out['bias'] = _array(node['bias'])
    return out


def _node_to_jax(name, node):
    """One of the port's layer dicts back to the JAX layout; `name` (its key
    in the tree) tells an embedding from a dense layer without bias."""
    if 'weight_hh' in node:
        return {'kernel': np.ascontiguousarray(_array(node['weight_ih']).T),
                'recurrent_kernel': np.ascontiguousarray(_array(node['weight_hh']).T),
                'bias': _array(node['bias'])}
    if 'running_mean' in node:
        return {'moving_mean': _array(node['running_mean']),
                'moving_var': _array(node['running_var'])}
    if node['weight'].dim() == 1:
        return {'gamma': _array(node['weight']), 'beta': _array(node['bias'])}
    if name == 'embedding' or name.endswith('_embedding'):
        return {'embeddings': _array(node['weight'])}
    return _conv_to_jax(node)


def _conv_transpose_to_jax(node):
    """The inverse of `conv_transpose_from_jax`."""
    weight = _array(node['weight'])                             # (in, out, W)
    out = {'kernel': np.ascontiguousarray(np.transpose(weight, (2, 0, 1))[::-1])}
    if 'bias' in node: out['bias'] = _array(node['bias'])
    return out


_LAYER_KEYS = ('weight', 'weight_hh', 'running_mean')


def tree_to_jax(tree, name = ''):
    """The inverse of `convert_tree` (numpy float32) for the trees of
    Tacotron-2, FastSpeech-2, WaveGlow's coupling blocks, Vocos, VITS but
    its generator, and the HiFi-GAN discriminators: a bare tensor becomes
    an array."""
    if torch.is_tensor(tree):
        return _array(tree)
    if tree and all(not isinstance(v, dict) for v in tree.values()) \
            and any(k in tree for k in _LAYER_KEYS):
        return _node_to_jax(name, tree)
    return {k: tree_to_jax(v, k) for k, v in tree.items()}


def tacotron2_to_jax(params, state):
    """The port's Tacotron-2 (params, state) → the JAX package's trees
    (numpy float32), the inverse of `tacotron2_from_jax`:
    ``tacotron2_from_jax(* tacotron2_to_jax(p, s))`` equals ``(p, s)``.
    Kernel layouts a model may carry are not parameters and are left out."""
    return tree_to_jax(params), tree_to_jax(state)


def waveglow_to_jax(params):
    """The port's WaveGlow params → the JAX package's tree (numpy float32),
    the inverse of `waveglow_from_jax`: ``waveglow_from_jax(waveglow_to_jax(p))``
    equals ``p``.  Kernel layouts a model may carry (``'packed'``,
    ``'packed_q'``) are not parameters and are left out."""
    out = {}
    for name, value in params.items():
        if name == 'upsample':
            out[name] = _conv_transpose_to_jax(value)
        else:
            block = {k: v for k, v in value['block'].items()
                     if k not in ('packed', 'packed_q')}
            out[name] = {'convinv': {'kernel': _conv_to_jax(value['convinv'])['kernel']},
                         'block': tree_to_jax(block)}
    return out


def hifigan_to_jax(params):
    """The port's HiFi-GAN generator params → the JAX package's tree (numpy
    float32), the inverse of `hifigan_from_jax`."""
    return {k: {n: _conv_transpose_to_jax(v) if n == 'up' else tree_to_jax(v, n)
                for n, v in node.items()}
            if _HIFIGAN_STAGE.fullmatch(k) else tree_to_jax(node, k)
            for k, node in params.items()}


def vits_to_jax(params):
    """The inverse of `vits_from_jax` (numpy float32)."""
    out = tree_to_jax({k: v for k, v in params.items() if k != 'generator'})
    out['generator'] = hifigan_to_jax(params['generator'])
    return out


def audio_encoder_to_jax(params, state):
    """The port's speaker-encoder (params, state) → the JAX package's trees
    (numpy float32), the inverse of `audio_encoder_from_jax`."""
    out = {}
    for name, node in params.items():
        if name == 'ge2e':
            out[name] = {k: _array(v) for k, v in node.items()}
        elif 'bn' in node:
            out[name] = {'conv': _conv_to_jax(node['conv']),
                         'bn': {'gamma': _array(node['bn']['weight']),
                                'beta': _array(node['bn']['bias'])}}
        else:
            out[name] = _conv_to_jax(node)
    jax_state = {name: {'bn': {'moving_mean': _array(node['bn']['running_mean']),
                               'moving_var': _array(node['bn']['running_var'])}}
                 for name, node in state.items()}
    return out, jax_state


def transformer_to_jax(params):
    """The inverse of `transformer_from_jax` (numpy float32):
    ``transformer_to_jax(transformer_from_jax(p))`` equals ``p``."""
    out = {}
    for name, node in params.items():
        if name == 'experts':
            out[name] = {k: {'kernel': np.ascontiguousarray(
                np.transpose(_array(leaf['weight']), (0, 2, 1)))} for k, leaf in node.items()}
        elif name == 'relative_bias':
            out[name] = {'embeddings': _array(node['weight'])}
        elif isinstance(node, dict) and any(isinstance(v, dict) for v in node.values()):
            out[name] = transformer_to_jax(node)
        else:
            out[name] = tree_to_jax(node, name)
    return out


def tree_to(tree, device):
    """Move a tensor tree to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device = device)


def cast_tree(tree, dtype, keep = ()):
    """Cast the floating leaves of a tensor tree, except under keys in `keep`."""
    if isinstance(tree, dict):
        return {k: v if k in keep else cast_tree(v, dtype, keep) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
