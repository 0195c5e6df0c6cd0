"""Speaker encoder: mel → l2-normalized speaker embedding (inference).

Counterpart of ``text_to_speech_tpu/models/encoder_arch.py``: four strided
convs (SAME padding by XLA's rule, `nn.layers.conv1d`), batch norm on the
running statistics, relu, masked statistics pooling (mean ⊕ std) and an
l2-normalized projection.  Parameters are the port's layouts
(`weights.audio_encoder_from_jax`); the GE2E scalars ``ge2e/w`` and
``ge2e/b`` ride along unused, so that a tree round-trips.
"""

import torch

from ..hparams import HParams
from ..nn import layers as nn

HParamsAudioEncoder = HParams(
    n_mel_channels = 80,
    embedding_dim = 256,
    filters = (128, 128, 256, 256),
    kernel_size = 5,
    strides = (2, 2, 2, 2),
    epsilon = 1e-5,
    momentum = 0.1,
    drop_rate = 0.1,
    normalize = True,
)


class AudioEncoder:
    def __init__(self, ** kwargs):
        self.hp = HParamsAudioEncoder.extract(kwargs)

    def __call__(self, params, state, mel, *, lengths = None):
        """mel (B, T, n_mel) → embeddings (B, embedding_dim).  With `lengths`,
        frames past them are zeroed before the first conv and left out of
        the pooling (the mask follows each stride)."""
        hp = self.hp
        x, mask = mel, None
        if lengths is not None:
            mask = torch.arange(mel.shape[1], device = mel.device)[None, :] \
                < lengths.to(mel.device)[:, None]
            x = torch.where(mask[..., None], x, torch.zeros_like(x))

        for i, stride in enumerate(hp.strides):
            name = 'conv_{}'.format(i)
            x = nn.conv1d(params[name]['conv'], x, stride = stride, padding = 'SAME')
            if mask is not None:
                mask = mask[:, ::stride][:, :x.shape[1]]
            x = torch.relu(nn.batch_norm(params[name]['bn'], state[name]['bn'], x,
                                         epsilon = hp.epsilon))

        if mask is not None:
            m = mask[..., None].to(x.dtype)
            count = torch.clamp(m.sum(dim = 1), min = 1.)
            mean = (x * m).sum(dim = 1) / count
            var = ((x - mean[:, None]) ** 2 * m).sum(dim = 1) / count
        else:
            mean = x.mean(dim = 1)
            var = x.var(dim = 1, unbiased = False)
        pooled = torch.cat([mean, torch.sqrt(var + 1e-6)], dim = -1)

        emb = nn.dense(params['projection'], pooled)
        return nn.l2_norm(emb) if hp.normalize else emb

    def get_config(self):
        return self.hp.get_config()
