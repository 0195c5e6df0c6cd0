"""Multi-head attention, the path FastSpeech-2 takes.

Counterpart of `mha` and `build_padding_mask` in
``text_to_speech_tpu/models/transformers/attention.py``, without the KV
cache, rotary embeddings, relative bias and grouped heads: plain matrix
products and a softmax, as the JAX package leaves them to XLA (no Pallas
kernel computes them there).  Masked logits are set to -1e9 before the
softmax, as there; `scaled_dot_product_attention` is not used, so that
masking and summation order stay the JAX package's.
"""

import math

import torch

from ...nn import layers as nn


def mha(params, query, key_value = None, *, n_heads, mask = None, scale = None):
    """Attention of `query` (B, Tq, D) over `key_value` (self-attention when
    None).  `mask`: broadcastable to (B, heads, Tq, Tk), True = attend.
    Returns (output (B, Tq, D_out), None), the JAX function's
    (output, cache) with no cache."""
    kv = key_value if key_value is not None else query
    B, Tq, _ = query.shape
    Tk = kv.shape[1]
    q = nn.dense(params['query'], query)
    k = nn.dense(params['key'], kv)
    v = nn.dense(params['value'], kv)
    head_dim = q.shape[-1] // n_heads
    q = q.reshape(B, Tq, n_heads, head_dim).transpose(1, 2)           # (B, H, Tq, hd)
    k = k.reshape(B, Tk, n_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, Tk, n_heads, head_dim).transpose(1, 2)
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    logits = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    weights = torch.softmax(logits, dim = -1)
    out = (weights @ v).transpose(1, 2).reshape(B, Tq, n_heads * head_dim)
    return nn.dense(params['output'], out), None


def build_padding_mask(lengths = None, tokens = None, pad_token = 0, max_length = None):
    """(B, 1, 1, T) boolean mask, True = valid: from `lengths` (B,) over
    `max_length` (default: the longest) or from `tokens` != `pad_token`."""
    if lengths is not None:
        T = max_length if max_length is not None else int(lengths.max())
        valid = torch.arange(T, device = lengths.device)[None, :] < lengths[:, None]
    else:
        valid = tokens != pad_token
    return valid[:, None, None, :]
