"""Functional layers over dictionaries of tensors.

Counterpart of ``text_to_speech_tpu/nn/layers.py``: every layer is a plain
function of a parameter dict and its inputs.  Activations keep the JAX
package's ``(batch, time, channels)`` layout; parameters use PyTorch's own
layouts, which `weights.py` produces from the JAX trees:

  - dense:      ``weight (out, in)``, ``bias (out,)``
  - embedding:  ``weight (vocab, dim)``
  - conv1d:     ``weight (out, in, width)``, ``bias (out,)``
  - conv1d_transpose: ``weight (in, out, width)`` (``nn.ConvTranspose1d``)
  - LSTM cell:  ``weight_ih (4U, in)``, ``weight_hh (4U, U)``, one fused
    ``bias (4U,)``; gates ordered i, f, g, o
  - batch norm: params ``weight``/``bias``, state ``running_mean``/``running_var``
    (`batch_norm` on the running statistics, `batch_norm_train` on the
    batch's, masked, moving the running ones)
  - layer norm: ``weight``/``bias`` (the JAX package's ``gamma``/``beta``)
  - rms norm: ``gamma`` alone, as in the JAX package
"""

import math

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    batch_draw, batch_sum, current_shard, tp_all_gather, tp_enter, tp_exit, tp_reduce_scatter,
    tp_split)


def generator(seed, device):
    """A `torch.Generator` on `device` seeded with `seed`; a generator
    passes through.  Every random init and draw of the port takes one."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device = device).manual_seed(int(seed))


def _uniform(gen, shape, limit, device):
    return (torch.rand(shape, generator = gen, device = device) * 2. - 1.) * limit


def init_dense(gen, in_dim, out_dim, use_bias = True, device = None):
    """A dense layer ``weight (out, in)``, glorot-uniform as the JAX
    `init_dense` draws it, and a zero bias."""
    limit = math.sqrt(6. / (in_dim + out_dim))
    params = {'weight': _uniform(gen, (out_dim, in_dim), limit, device)}
    if use_bias: params['bias'] = torch.zeros((out_dim,), device = device)
    return params


def init_embedding(gen, vocab_size, dim, scale = 0.05, device = None):
    return {'weight': _uniform(gen, (vocab_size, dim), scale, device)}


def init_conv1d(gen, width, in_ch, out_ch, use_bias = True, device = None):
    """A conv ``weight (out, in, width)``, glorot-uniform over its fans."""
    limit = math.sqrt(6. / ((in_ch + out_ch) * width))
    params = {'weight': _uniform(gen, (out_ch, in_ch, width), limit, device)}
    if use_bias: params['bias'] = torch.zeros((out_ch,), device = device)
    return params


def init_layer_norm(dim, device = None):
    return {'weight': torch.ones((dim,), device = device),
            'bias': torch.zeros((dim,), device = device)}


def init_rms_norm(dim, device = None):
    return {'gamma': torch.ones((dim,), device = device)}


def dense(params, x):
    y = x @ params['weight'].T
    if 'bias' in params: y = y + params['bias']
    return y


def embedding(params, ids):
    return params['weight'][ids]


def _same_pads(width, dilation, stride = 1, length = 1):
    """XLA's SAME padding of a `length`-long input: ``ceil(length / stride)``
    outputs, the pad split with its smaller half in front (at stride 2 and
    width 5 an even length pads (1, 2), where PyTorch's rule would pad 2 and 2)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + dilation * (width - 1) + 1 - length, 0)
    return total // 2, total - total // 2


def conv1d(params, x, *, stride = 1, padding = 'SAME', dilation = 1, groups = 1):
    """x: (B, T, C_in) → (B, T', C_out); `padding` 'SAME' (XLA's rule),
    'VALID' or explicit ``[(front, back)]`` (the JAX `conv1d`'s list form);
    ``groups = C_in`` is a depthwise conv (weight (C, 1, W), the JAX
    ``feature_group_count``)."""
    weight = params['weight']
    h = x.transpose(1, 2)
    if not isinstance(padding, str):
        (front, back), = padding
        h = F.pad(h, (front, back))
    elif padding.upper() == 'SAME':
        h = F.pad(h, _same_pads(weight.shape[2], dilation, stride, h.shape[2]))
    y = F.conv1d(h, weight, params.get('bias'), stride = stride, dilation = dilation,
                 groups = groups)
    return y.transpose(1, 2)


def row_parallel(layer, params, x, tp, ** kwargs):
    """`layer` (`dense`, `conv1d` or `conv1d_transpose`, with its keyword
    arguments) of a weight split on its in channels over `tp` (a
    `parallel.collectives.Axis`; x this rank's channels): the partial sums
    all-reduced, then the bias; without an axis, `layer` as it is."""
    if tp is None:
        return layer(params, x, ** kwargs)
    out = tp_exit(layer({'weight': params['weight']}, x, ** kwargs), tp)
    return out + params['bias'] if 'bias' in params else out


def col_parallel(layer, params, x, tp, ** kwargs):
    """`layer` of a weight split on its out channels over `tp`, its bias
    replicated: the whole `x` enters (`tp_enter`) and the bias is sliced to
    this rank's channels (`tp_split`, so that every rank holds its whole
    gradient); without an axis, `layer` as it is."""
    if tp is None:
        return layer(params, x, ** kwargs)
    local = {'weight': params['weight']}
    if 'bias' in params:
        local['bias'] = tp_split(params['bias'], 0, tp)
    return layer(local, tp_enter(x, tp), ** kwargs)


def res_skip_split(params, gated, channels, tp, *, last):
    """A WaveNet layer's res / skip conv on `gated` (the whole gate) →
    (res, skip), res None for the `last` layer, whose conv makes the skip
    alone.  Over `tp` the conv is split on its in channels: this rank's
    channels of the gate go in, the partial sums are reduce-scattered onto
    this rank's channels of the residual and of the skip (each of
    `channels` whole), then their slices of the bias are added."""
    if tp is None:
        out = conv1d(params, gated)
        return (None, out) if last else (out[..., :channels], out[..., channels:])
    part = conv1d({'weight': params['weight']}, tp_split(gated, -1, tp))
    bias = params.get('bias')
    if last:
        skip = tp_reduce_scatter(part, -1, tp)
        return None, skip if bias is None else skip + tp_split(bias, 0, tp)
    out = tp_reduce_scatter(part.unflatten(-1, (2, channels)), -1, tp)
    if bias is not None:
        out = out + tp_split(bias.reshape(2, channels), -1, tp)
    return out[..., 0, :], out[..., 1, :]


def conv1d_transpose(params, x, *, stride):
    """VALID transposed conv: (B, T, C_in) → (B, (T-1)*stride + width, C_out)."""
    y = F.conv_transpose1d(x.transpose(1, 2), params['weight'], params.get('bias'),
                           stride = stride)
    return y.transpose(1, 2)


def l2_norm(x, dim = -1, epsilon = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim = dim, keepdim = True), min = epsilon)


def batch_norm(params, state, x, *, epsilon = 1e-5):
    """Inference batch norm over the last axis; statistics in float32 and
    the result in the input's dtype."""
    x32 = x.float()
    inv = torch.rsqrt(state['running_var'].float() + epsilon) * params['weight'].float()
    y = (x32 - state['running_mean'].float()) * inv + params['bias'].float()
    return y.to(x.dtype)


def batch_norm_train(params, state, x, *, momentum = 0.1, epsilon = 1e-5, mask = None):
    """Training batch norm over the last axis: the batch's statistics
    normalize `x`, masked to the valid (B, T) frames by `mask`, and the
    running statistics move as ``new = (1 - momentum) * old + momentum *
    batch``.  Both use the biased variance, as the JAX package does
    (`F.batch_norm` would move the running variance by the unbiased one).
    The statistics are float32, the result in the input's dtype.  Inside a
    `parallel.collectives.batch_shard` the sums and counts are the whole
    batch's (all-reduced over the shards).  Returns (y, new_state); the new
    state carries no gradient."""
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    if mask is not None or current_shard() is not None:
        m = mask[..., None].float() if mask is not None else torch.ones_like(x32[..., :1])
        count = torch.clamp(batch_sum(m.sum()), min = 1.)
        mean = batch_sum((x32 * m).sum(dim = axes)) / count
        var = batch_sum(((x32 - mean) ** 2 * m).sum(dim = axes)) / count
    else:
        mean = x32.mean(dim = axes)
        var = x32.var(dim = axes, unbiased = False)
    with torch.no_grad():
        new_state = {
            'running_mean': (1. - momentum) * state['running_mean'].float() + momentum * mean,
            'running_var': (1. - momentum) * state['running_var'].float() + momentum * var,
        }
    inv = torch.rsqrt(var + epsilon) * params['weight'].float()
    y = (x32 - mean) * inv + params['bias'].float()
    return y.to(x.dtype), new_state


def lstm_cell(params, x, carry, tp = None):
    """One LSTM step.  carry = (h, c); gates ordered i, f, g, o.  `tp` (a
    `parallel.collectives.Axis`): the weights hold this rank's rows of the
    4U pre-activations (`parallel.tacotron2_param_specs`), which are
    gathered before the bias and the gates (a contiguous slice cuts across
    the i / f / g / o blocks)."""
    h, c = carry
    units = h.shape[-1]
    z = tp_all_gather(tp_enter(x, tp) @ params['weight_ih'].T
                      + tp_enter(h, tp) @ params['weight_hh'].T, -1, tp) + params['bias']
    i = torch.sigmoid(z[..., :units])
    f = torch.sigmoid(z[..., units: 2 * units])
    g = torch.tanh(z[..., 2 * units: 3 * units])
    o = torch.sigmoid(z[..., 3 * units:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, (h_new, c_new)


def lstm_init_carry(batch_size, units, dtype = torch.float32, device = None):
    zeros = torch.zeros((batch_size, units), dtype = dtype, device = device)
    return (zeros, zeros.clone())


def lstm(params, xs, *, mask = None, reverse = False):
    """Run an LSTM over time.

    xs: (B, T, C); mask: (B, T).  Masked steps carry the state through
    unchanged and output zeros (Keras masking semantics).  A reverse scan
    over a padded batch therefore starts from the zero state at the padded
    end and carries it through the padding, which is not what
    `pack_padded_sequence` does.  Returns (outputs (B, T, units), final_carry).
    """
    batch, steps = xs.shape[0], xs.shape[1]
    units = params['weight_hh'].shape[1]
    carry = lstm_init_carry(batch, units, xs.dtype, xs.device)
    outputs = [None] * steps
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for t in order:
        h_new, new_carry = lstm_cell(params, xs[:, t], carry)
        if mask is not None:
            m = mask[:, t, None].to(h_new.dtype)
            new_carry = (m * new_carry[0] + (1. - m) * carry[0],
                         m * new_carry[1] + (1. - m) * carry[1])
            h_new = m * h_new
        carry = new_carry
        outputs[t] = h_new
    return torch.stack(outputs, dim = 1), carry


def bilstm(params, xs, *, mask = None):
    """Bidirectional LSTM, concatenated outputs (B, T, 2*units)."""
    fw, _ = lstm(params['forward'], xs, mask = mask)
    bw, _ = lstm(params['backward'], xs, mask = mask, reverse = True)
    return torch.cat([fw, bw], dim = -1)


def layer_norm(params, x, epsilon = 1e-5):
    """Over the last axis, as the JAX package computes it: population
    variance and ``rsqrt(var + epsilon)``; for a bfloat16 `x` the mean and
    the variance are reduced in float32 and rounded to bfloat16, as
    ``jnp.mean`` / ``jnp.var`` do, and the rest runs in bfloat16."""
    x32 = x.float()
    mean32 = x32.mean(dim = -1, keepdim = True)
    var = ((x32 - mean32) ** 2).mean(dim = -1, keepdim = True).to(x.dtype)
    return (x - mean32.to(x.dtype)) * torch.rsqrt(var + epsilon) * params['weight'] \
        + params['bias']


def rms_norm(params, x, epsilon = 1e-6):
    """``x * rsqrt(mean(x ** 2) + epsilon) * gamma`` over the last axis; its
    one parameter keeps the JAX name ``gamma``."""
    var = torch.mean(torch.square(x), dim = -1, keepdim = True)
    return x * torch.rsqrt(var + epsilon) * params['gamma']


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate = 'tanh')


def dropout(x, rate, *, generator = None, tp = None):
    """Inverted dropout drawing its mask from `generator` (on x's device);
    `x` is batch-leading: inside a `parallel.collectives.batch_shard` its
    mask is its rows of the whole batch's.  `tp` (a `collectives.Axis`):
    `x` holds this rank's slice of the last dimension, and the mask is its
    slice of the whole tensor's."""
    if rate <= 0.: return x
    if tp is None:
        keep = batch_draw(torch.rand, x.shape, generator = generator, device = x.device)
    else:
        n = x.shape[-1]
        keep = batch_draw(torch.rand, x.shape[:-1] + (n * tp.size,), generator = generator,
                          device = x.device)[..., tp.index * n: (tp.index + 1) * n]
    keep = keep < 1. - rate
    return torch.where(keep, x / (1. - rate), torch.zeros_like(x))
