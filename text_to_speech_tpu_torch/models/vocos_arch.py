"""Vocos generator over dictionaries of tensors.

Counterpart of the generator of ``text_to_speech_tpu/models/vocos_arch.py``:
a ConvNeXt backbone at frame rate (the `embed` conv, a layer norm, blocks of
depthwise conv → layer norm → GELU MLP → layer scale `gamma` added back, a
final layer norm), then a dense head to [log-magnitude | phase] over
``n_fft // 2 + 1`` bins; the magnitude is ``exp`` clipped at `mag_clip`, and
one inverse STFT (`ops.stft.STFT.inverse_transform`) gives the waveform.
One frame is reflected at the end of the mel, so the inverse covers
``T * hop`` samples; the waveform is cropped or zero-padded to exactly that.
GELU is ``jax.nn.gelu``'s default, the tanh approximation.  Parameters are
the port's layouts (`weights.hifigan_from_jax`); random ones come from
`init.init_vocos`.

It trains by the HiFi-GAN recipe (`train.gan.make_hifigan_train_step`):
the discriminators and the GAN losses are HiFi-GAN's
(`hifigan_arch.GANDiscriminators`, a base of both), as in the JAX package.

The JAX package computes it in XLA, outside any Pallas kernel: the port
runs it as plain tensor code.
"""

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..ops.stft import STFT
from ..weights import cast_tree
from .hifigan_arch import GANDiscriminators

HParamsVocos = HParams(
    n_mel_channels = 80,
    dim = 512,
    intermediate_dim = 1536,
    n_layers = 8,
    kernel_size = 7,                # the depthwise conv's width
    layer_scale = None,             # None → 1 / n_layers (the published default)
    epsilon = 1e-6,
    # the inverse STFT head (the TacotronSTFT geometry)
    n_fft = 1024,
    hop_length = 256,
    win_length = 1024,
    mag_clip = 1e2,
    # the discriminators (HiFi-GAN's, by composition)
    mpd_periods = (2, 3, 5, 7, 11),
    msd_scales = 3,
    leaky_slope = 0.1,
)


class Vocos(GANDiscriminators):
    """Static hyper-parameters and the generator."""

    def __init__(self, ** kwargs):
        self.hp = HParamsVocos.extract(kwargs)
        self.total_upsampling = self.hp.hop_length
        self._stft = None

    def get_config(self):
        return self.hp.get_config()

    @property
    def stft(self):
        if self._stft is None:
            self._stft = STFT(filter_length = self.hp.n_fft, hop_length = self.hp.hop_length,
                              win_length = self.hp.win_length)
        return self._stft

    def _block(self, p, x):
        hp = self.hp
        h = nn.conv1d(p['depthwise'], x, groups = x.shape[-1])
        h = nn.layer_norm(p['norm'], h, hp.epsilon)
        h = nn.dense(p['pw2'], nn.gelu(nn.dense(p['pw1'], h)))
        return x + p['gamma'] * h

    def spectral_head(self, params, mel, *, cond = None, dtype = None):
        """mel (B, T, n_mel) → (magnitude, phase), each (B, T + 1, bins),
        float32."""
        hp = self.hp
        x = mel
        if dtype is not None:
            x = x.to(dtype)
            params = cast_tree(params, dtype)
        x = torch.cat([x, x[:, -1:]], dim = 1)                 # T + 1 frames
        x = nn.conv1d(params['embed'], x)
        if cond is not None:
            x = x + cond[:, None, :].to(x.dtype)
        x = nn.layer_norm(params['norm_pre'], x, hp.epsilon)
        for i in range(hp.n_layers):
            x = self._block(params['block_{}'.format(i)], x)
        x = nn.layer_norm(params['norm_post'], x, hp.epsilon)
        out = nn.dense(params['head'], x).float()
        bins = hp.n_fft // 2 + 1
        magnitude = torch.clamp(torch.exp(out[..., :bins]), max = hp.mag_clip)
        return magnitude, out[..., bins:]

    def apply(self, params, mel, *, cond = None, dtype = None):
        """mel (B, T, n_mel) → float32 waveform (B, T * hop)."""
        magnitude, phase = self.spectral_head(params, mel, cond = cond, dtype = dtype)
        audio = self.stft.inverse_transform(magnitude, phase)
        want = mel.shape[1] * self.hp.hop_length
        if want > audio.shape[1]:
            audio = F.pad(audio, (0, want - audio.shape[1]))
        return audio[:, :want].float()

    infer = apply

