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
"""

import torch
import torch.nn.functional as F


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
    """x: (B, T, C_in) → (B, T', C_out); `padding` 'SAME' (XLA's rule) or
    'VALID'; ``groups = C_in`` is a depthwise conv (weight (C, 1, W), the JAX
    ``feature_group_count``)."""
    weight = params['weight']
    h = x.transpose(1, 2)
    if padding.upper() == 'SAME':
        h = F.pad(h, _same_pads(weight.shape[2], dilation, stride, h.shape[2]))
    y = F.conv1d(h, weight, params.get('bias'), stride = stride, dilation = dilation,
                 groups = groups)
    return y.transpose(1, 2)


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
    The statistics are float32, the result in the input's dtype.  Returns
    (y, new_state); the new state carries no gradient."""
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    if mask is not None:
        m = mask[..., None].float()
        count = torch.clamp(m.sum(), min = 1.)
        mean = (x32 * m).sum(dim = axes) / count
        var = ((x32 - mean) ** 2 * m).sum(dim = axes) / count
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


def lstm_cell(params, x, carry):
    """One LSTM step.  carry = (h, c); gates ordered i, f, g, o."""
    h, c = carry
    units = h.shape[-1]
    z = x @ params['weight_ih'].T + h @ params['weight_hh'].T + params['bias']
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


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate = 'tanh')


def dropout(x, rate, *, generator = None):
    """Inverted dropout drawing its mask from `generator` (on x's device)."""
    if rate <= 0.: return x
    keep = torch.rand(x.shape, generator = generator, device = x.device) < 1. - rate
    return torch.where(keep, x / (1. - rate), torch.zeros_like(x))
