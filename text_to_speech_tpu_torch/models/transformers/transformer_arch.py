"""The sinusoidal position table of
``text_to_speech_tpu/models/transformers/transformer_arch.py``; the
`Transformer` families are not ported."""

import torch


def sinusoidal_embedding(max_position, dim, device = None):
    """(max_position, dim) float32: sin on the even columns, cos on the odd
    ones, angle ``pos / 10000 ** (2 i / dim)``."""
    pos = torch.arange(max_position, device = device, dtype = torch.float32)[:, None]
    i = torch.arange(dim // 2, device = device, dtype = torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000., device = device), 2. * i / dim)
    emb = torch.zeros((max_position, dim), device = device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb
