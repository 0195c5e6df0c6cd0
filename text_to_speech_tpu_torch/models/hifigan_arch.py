"""HiFi-GAN generator over dictionaries of tensors.

Counterpart of the generator of ``text_to_speech_tpu/models/hifigan_arch.py``:
`conv_pre` (width 7), then per upsampling stage a leaky ReLU, a transposed
conv cropped back to ``T * prod(rates so far)`` (the VALID output trimmed
evenly at both ends, as the JAX package's SAME-style crop), and the
multi-receptive-field block (the mean of one residual block per kernel
size: version 1 pairs a dilated conv with a plain one, version 2 has the
dilated conv alone), then a leaky ReLU of slope 0.01 (the published
generator's last activation), `conv_post` and tanh.  `cond` (B,
upsample_initial_channel) is the global conditioning bias that VITS adds
after `conv_pre`.  Parameters are the port's layouts (`weights.hifigan_from_jax`
of the JAX tree, whose transposed convs sit under the key ``up`` of each
stage); random ones come from `init.init_hifigan`.

The JAX package computes the generator in XLA, outside any Pallas kernel:
the port runs its convs as cuDNN calls through `nn.layers`, with no
kernel of its own.  The discriminators and the GAN losses are not ported.
"""

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..weights import cast_tree

HParamsHiFiGAN = HParams(
    n_mel_channels = 80,
    upsample_rates = (8, 8, 2, 2),              # product = 256 = mel hop
    upsample_kernel_sizes = (16, 16, 4, 4),
    upsample_initial_channel = 512,
    resblock_kernel_sizes = (3, 7, 11),
    resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    resblock_version = 1,   # 1: dilated + plain conv pairs; 2: the dilated conv alone
    leaky_slope = 0.1,
    # discriminators (kept in the config; not ported)
    mpd_periods = (2, 3, 5, 7, 11),
    msd_scales = 3,
)

#: the published configurations: ``HiFiGAN(** HIFIGAN_V2)``
HIFIGAN_V1 = {}
HIFIGAN_V2 = {'upsample_initial_channel': 128}
HIFIGAN_V3 = {
    'upsample_rates': (8, 8, 4),
    'upsample_kernel_sizes': (16, 16, 8),
    'upsample_initial_channel': 256,
    'resblock_kernel_sizes': (3, 5, 7),
    'resblock_dilation_sizes': ((1, 2), (2, 6), (3, 12)),
    'resblock_version': 2,
}


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


class HiFiGAN:
    """Static hyper-parameters and the generator."""

    def __init__(self, ** kwargs):
        self.hp = HParamsHiFiGAN.extract(kwargs)
        self.total_upsampling = _prod(self.hp.upsample_rates)

    def get_config(self):
        return self.hp.get_config()

    def _resblock(self, block, x, dilations, slope):
        for di, d in enumerate(dilations):
            unit = block['d{}'.format(di)]
            h = nn.conv1d(unit['conv1'], F.leaky_relu(x, slope), dilation = d)
            if 'conv2' in unit:
                h = nn.conv1d(unit['conv2'], F.leaky_relu(h, slope))
            x = x + h
        return x

    def apply(self, params, mel, *, cond = None, dtype = None):
        """mel (B, T, n_mel) → float32 waveform (B, T * total_upsampling);
        under `dtype` the params and the mel are cast."""
        hp = self.hp
        x = mel
        if dtype is not None:
            x = x.to(dtype)
            params = cast_tree(params, dtype)
        x = nn.conv1d(params['conv_pre'], x)
        if cond is not None:
            x = x + cond[:, None, :].to(x.dtype)
        n_kernels = len(hp.resblock_kernel_sizes)
        for i, rate in enumerate(hp.upsample_rates):
            stage = params['up{}'.format(i)]
            x = nn.conv1d_transpose(stage['up'], F.leaky_relu(x, hp.leaky_slope), stride = rate)
            extra = x.shape[1] - mel.shape[1] * _prod(hp.upsample_rates[:i + 1])
            x = x[:, extra // 2: x.shape[1] - (extra - extra // 2)]
            acc = None
            for j, dils in enumerate(hp.resblock_dilation_sizes):
                y = self._resblock(stage['res{}'.format(j)], x, dils, hp.leaky_slope)
                acc = y if acc is None else acc + y
            x = acc / n_kernels
        x = nn.conv1d(params['conv_post'], F.leaky_relu(x, 0.01))
        return torch.tanh(x)[..., 0].float()

    infer = apply
