"""Multi-head attention with a KV cache, rotary embeddings, grouped heads
and an additive relative bias.

Counterpart of ``text_to_speech_tpu/models/transformers/attention.py``:
plain matrix products and a softmax, as the JAX package leaves them to XLA
(no Pallas kernel computes them there).  Masked logits are set to -1e9
before a plain softmax; `scaled_dot_product_attention` is not used, so that
masking and summation order stay the JAX package's.

The KV cache is the port's own layout: ``k`` and ``v`` of shape ``(B,
n_kv_heads, max_length, head_dim)`` (the JAX cache is (B, max_length,
heads, head_dim)), so that a head's keys are one contiguous matrix.  Its
``index`` is a Python int (the JAX scalar write index) or a ``(B,)`` long
tensor, one write position a row: the JAX serving stepper gets the per-row
index by `vmap` over rows, the port takes it directly.  From it `mha`
derives the write position, the RoPE positions and the new index, per
row.  The write is in place: the returned cache holds the same tensors.
A write that would run past the end starts at ``max_length - Tq``, as
``lax.dynamic_update_slice`` clamps its start.
"""

import math

import torch

from ...devices import default_device
from ...nn import layers as nn
from ...parallel.collectives import tp_enter


def init_mha(generator, dim, n_heads, *, kv_dim = None, n_kv_heads = None,
             use_bias = True, out_dim = None, device = None):
    """The four projections of an attention (``query``, ``key``, ``value``,
    ``output``) in `nn.layers`' dense layout, drawn from `generator` (a seed
    or a `torch.Generator`) on `device` (cuda unless given)."""
    device = default_device(device)
    gen = nn.generator(generator, device)
    kv_dim = kv_dim or dim
    n_kv_heads = n_kv_heads or n_heads
    head_dim = dim // n_heads
    return {
        'query': nn.init_dense(gen, dim, n_heads * head_dim, use_bias, device),
        'key': nn.init_dense(gen, kv_dim, n_kv_heads * head_dim, use_bias, device),
        'value': nn.init_dense(gen, kv_dim, n_kv_heads * head_dim, use_bias, device),
        'output': nn.init_dense(gen, n_heads * head_dim, out_dim or dim, use_bias, device),
    }


def rope(x, positions, *, base = 10000.0):
    """Rotary position embedding of x (B, T, H, D) at positions (B, T): the
    interleaved pairs ``(x[2i], x[2i+1])`` rotate (not HF's rotate_half;
    the importers permute the q/k columns to match).  The angles are
    float32 and the result is in x's dtype: a bfloat16 stack stays
    bfloat16 (the JAX package's promotes it to float32 here, and torch's
    matmuls do not promote a mixed pair)."""
    d = x.shape[-1]
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype = torch.float32, device = x.device),
                               torch.arange(0, d, 2, device = x.device, dtype = torch.float32) / d)
    angles = positions[..., None].to(torch.float32) * inv_freq         # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim = -1)
    return rotated.reshape(x.shape).to(x.dtype)


def init_kv_cache(batch, max_length, n_kv_heads, head_dim, dtype = torch.float32,
                  device = None):
    """An empty cache: zero ``k`` / ``v`` (B, n_kv_heads, max_length,
    head_dim) and write index 0."""
    device = default_device(device)
    shape = (batch, n_kv_heads, max_length, head_dim)
    return {'k': torch.zeros(shape, dtype = dtype, device = device),
            'v': torch.zeros(shape, dtype = dtype, device = device),
            'index': 0}


def cache_positions(index, steps, batch, device):
    """(B, steps) positions ``index + t``: `index` an int or a (B,) tensor."""
    t = torch.arange(steps, device = device)
    if torch.is_tensor(index):
        return index[:, None].to(torch.long) + t
    return (t + index)[None].expand(batch, steps)


def _write(buffer, new, index):
    """Write `new` (B, H, Tq, D) into `buffer` (B, H, L, D) at `index` (an
    int or a (B,) tensor), each start clamped to [0, L - Tq]."""
    L, Tq = buffer.shape[2], new.shape[2]
    new = new.to(buffer.dtype)
    if torch.is_tensor(index):
        start = torch.clamp(index.to(torch.long), 0, L - Tq)
        pos = start[:, None] + torch.arange(Tq, device = buffer.device)
        rows = torch.arange(buffer.shape[0], device = buffer.device)[:, None]
        buffer[rows, :, pos] = new.transpose(1, 2)                    # (B, Tq, H, D)
    else:
        start = min(max(int(index), 0), L - Tq)
        buffer[:, :, start: start + Tq] = new


def mha(params,
        query,
        key_value = None,
        *,
        n_heads,
        mask = None,
        cache = None,
        positions = None,
        use_rope = False,
        rope_base = 10000.0,
        rel_bias = None,
        scale = None,
        tp = None):
    """Attention of `query` (B, Tq, D) over `key_value` (self-attention when
    None).

    - `mask`: boolean, broadcastable to (B, heads, Tq, Tk); True = attend.
    - `cache`: a KV cache (module docstring); the new keys and values are
      written at its index and the attention runs over the whole cache.
    - `positions`: (B, Tq) RoPE positions; by default the cache index (0
      without a cache) plus the step.
    - `rel_bias`: additive bias broadcastable to (B, heads, Tq, Tk) (T5).
    - fewer key/value heads than query heads: each group of
      ``heads / kv_heads`` query heads shares a key/value head, as
      ``jnp.repeat`` over the head axis does.
    - `tp`: a `collectives.Axis` over which the projections are split as
      Megatron splits them (`parallel.fastspeech2_param_specs`): q / k / v
      hold this rank's ``n_heads / tp`` heads, ``output`` their part of its
      inputs; the partial outputs are all-reduced before its bias.
    Returns (output (B, Tq, D_out), the cache with its new index or None)."""
    if tp is not None:
        if n_heads % tp.size:
            raise ValueError('{} heads do not split over {} ranks'.format(n_heads, tp.size))
        n_heads //= tp.size
        query = tp_enter(query, tp)
        if key_value is not None:
            key_value = tp_enter(key_value, tp)
    kv = key_value if key_value is not None else query
    B, Tq, _ = query.shape
    Tk = kv.shape[1]
    q = nn.dense(params['query'], query)
    k = nn.dense(params['key'], kv)
    v = nn.dense(params['value'], kv)
    head_dim = q.shape[-1] // n_heads
    n_kv = k.shape[-1] // head_dim
    q = q.reshape(B, Tq, n_heads, head_dim)
    k = k.reshape(B, Tk, n_kv, head_dim)
    v = v.reshape(B, Tk, n_kv, head_dim)

    if use_rope:
        if positions is None:
            positions = cache_positions(cache['index'] if cache is not None else 0,
                                        Tq, B, query.device)
        q = rope(q, positions, base = rope_base)
        kv_positions = positions if key_value is None else \
            cache_positions(0, Tk, B, query.device)
        k = rope(k, kv_positions, base = rope_base)

    k = k.transpose(1, 2)                                               # (B, n_kv, Tk, hd)
    v = v.transpose(1, 2)
    new_cache = None
    if cache is not None:
        index = cache['index']
        _write(cache['k'], k, index)
        _write(cache['v'], v, index)
        new_cache = {'k': cache['k'], 'v': cache['v'], 'index': index + Tq}
        k, v = cache['k'].to(q.dtype), cache['v'].to(q.dtype)
    L = k.shape[2]

    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    rep = n_heads // n_kv
    # query head h = g * rep + r reads key/value head g
    qg = q.reshape(B, Tq, n_kv, rep, head_dim).permute(0, 2, 3, 1, 4) \
        .reshape(B, n_kv, rep * Tq, head_dim)
    logits = (qg @ k.transpose(-1, -2)).reshape(B, n_heads, Tq, L) * scale
    if rel_bias is not None:
        logits = logits + rel_bias
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    weights = torch.softmax(logits, dim = -1)
    out = (weights.reshape(B, n_kv, rep * Tq, L) @ v).reshape(B, n_heads, Tq, head_dim)
    out = out.transpose(1, 2).reshape(B, Tq, n_heads * head_dim)
    return nn.row_parallel(nn.dense, params['output'], out, tp), new_cache


def build_padding_mask(lengths = None, tokens = None, pad_token = 0, max_length = None):
    """(B, 1, 1, T) boolean mask, True = valid: from `lengths` (B,) over
    `max_length` (default: the longest) or from `tokens` != `pad_token`."""
    if lengths is not None:
        T = max_length if max_length is not None else int(lengths.max())
        valid = torch.arange(T, device = lengths.device)[None, :] < lengths[:, None]
    else:
        valid = tokens != pad_token
    return valid[:, None, None, :]


def build_look_ahead_mask(T, dtype = torch.bool, device = None):
    """(1, 1, T, T) causal mask, True = attend (lower triangle)."""
    return torch.tril(torch.ones((T, T), dtype = dtype, device = device))[None, None]


def combine_masks(* masks):
    out = None
    for m in masks:
        if m is None: continue
        out = m if out is None else torch.logical_and(out, m)
    return out
