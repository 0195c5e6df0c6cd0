"""Speaker encoder: mel → l2-normalized speaker embedding (inference).

Counterpart of ``text_to_speech_tpu/models/encoder_arch.py``: four strided
convs (SAME padding by XLA's rule, `nn.layers.conv1d`), batch norm, relu,
masked statistics pooling (mean ⊕ std) and an l2-normalized projection.
`__call__` embeds on the running statistics; `forward` is the JAX
package's ``__call__``: in train mode the batch norms run on the batch's
statistics over the valid frames (the mask follows each stride) and move
the running ones, and dropout follows each conv.  Parameters are the port's
layouts (`weights.audio_encoder_from_jax`); the GE2E scale ``ge2e/w`` and
offset ``ge2e/b`` are trainable leaves of the tree that `GE2ELoss` reads.
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
        return self.forward(params, state, mel, lengths = lengths)[0]

    def forward(self, params, state, mel, *, lengths = None, train = False,
                generator = None):
        """→ (embeddings (B, embedding_dim), new_state); in `train` mode the
        batch norms run on the batch and dropout draws from `generator`."""
        hp = self.hp
        x, mask = mel, None
        if lengths is not None:
            mask = torch.arange(mel.shape[1], device = mel.device)[None, :] \
                < lengths.to(mel.device)[:, None]
            x = torch.where(mask[..., None], x, torch.zeros_like(x))

        new_state = {}
        for i, stride in enumerate(hp.strides):
            name = 'conv_{}'.format(i)
            x = nn.conv1d(params[name]['conv'], x, stride = stride, padding = 'SAME')
            if mask is not None:
                mask = mask[:, ::stride][:, :x.shape[1]]
            bn_state = state[name]['bn']
            if train:
                x, bn_state = nn.batch_norm_train(params[name]['bn'], bn_state, x,
                                                  momentum = hp.momentum,
                                                  epsilon = hp.epsilon, mask = mask)
            else:
                x = nn.batch_norm(params[name]['bn'], bn_state, x, epsilon = hp.epsilon)
            x = torch.relu(x)
            if train:
                x = nn.dropout(x, hp.drop_rate, generator = generator)
            new_state[name] = {'bn': bn_state}

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
        return (nn.l2_norm(emb) if hp.normalize else emb), {** state, ** new_state}

    def get_config(self):
        return self.hp.get_config()
