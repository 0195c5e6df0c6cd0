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

The discriminators (JAX ``:154-336``) train it adversarially
(`train.gan`); `GANDiscriminators` holds them and the losses for HiFi-GAN
and Vocos alike:

  - the multi-period one (`apply_mpd`): per period p the waveform is
    reflect-padded to a multiple of p (edge-padded, PyTorch's
    ``replicate``, where the pad exceeds T - 1), folded to (B p, T / p, 1),
    and run through four stride-3 width-5 convs, `conv5` and `post`, the
    features kept after every leaky ReLU and the score;
  - the multi-scale one (`apply_msd`): seven grouped, strided convs
    (`MSD_SPECS`, XLA's SAME pads through `nn.conv1d`) and `post` at the
    waveform's rate and, for the later scales, after average pools of width
    4 and stride 2 taken as XLA's ``reduce_window`` takes them: a zero-padded
    sum over SAME pads divided by 4, at the edges too (`_pool`), which
    ``F.avg_pool1d``'s symmetric padding is not;
  - the LSGAN losses (`discriminator_loss`, `generator_adversarial_loss`,
    `feature_matching_loss`) reduce in float32; `generator_loss` adds the
    L1 distance of float32 mels of the float32 waveforms; under a
    `compute_dtype` the generator, the discriminators and their operands
    are cast.

Their channels are the published ones (`MPD_CHANNELS`, `MSD_SPECS`)
whatever the generator's width; random ones come from `init.init_mpd` /
`init.init_msd` through `init_mpd(seed)` / `init_msd(seed)`, and a JAX tree
converts through `weights.convert_tree` (`weights.tree_to_jax` back).

The JAX package computes all of it in XLA, outside any Pallas kernel: the
port runs its convs as cuDNN calls through `nn.layers`, with no kernel of
its own.
"""

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..parallel.collectives import tp_split
from ..weights import cast_tree, convert_tree

HParamsHiFiGAN = HParams(
    n_mel_channels = 80,
    upsample_rates = (8, 8, 2, 2),              # product = 256 = mel hop
    upsample_kernel_sizes = (16, 16, 4, 4),
    upsample_initial_channel = 512,
    resblock_kernel_sizes = (3, 7, 11),
    resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    resblock_version = 1,   # 1: dilated + plain conv pairs; 2: the dilated conv alone
    leaky_slope = 0.1,
    # discriminators
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


#: the multi-period discriminator's conv channels (then `conv5` at 1024)
MPD_CHANNELS = (32, 128, 512, 1024)
#: the multi-scale discriminator's convs: (width, stride, groups, out channels)
MSD_SPECS = ((15, 1, 1, 128), (41, 2, 4, 128), (41, 2, 16, 256), (41, 4, 16, 512),
             (41, 4, 16, 1024), (41, 1, 16, 1024), (5, 1, 1, 1024))


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _pool(x):
    """``lax.reduce_window(x, 0., add, (1, 4), (1, 2), 'SAME') / 4.`` on
    (B, T): zeros over XLA's SAME pads, every window divided by 4."""
    x = F.pad(x, nn._same_pads(4, 1, 2, x.shape[1]))
    return x.unfold(1, 4, 2).sum(dim = -1) / 4.


def _mean32(x):
    return torch.mean(x.float())


class GANDiscriminators:
    """The multi-period and multi-scale discriminators and the GAN losses
    of a vocoder whose hparams carry `mpd_periods`, `msd_scales` and
    `leaky_slope` and whose ``apply(params, mel, dtype=)`` is its generator
    (`HiFiGAN`, `vocos_arch.Vocos`)."""

    def init_mpd(self, seed = 0):
        """Random multi-period discriminator params (the port's layout)."""
        from ..init import init_mpd
        return convert_tree(init_mpd(self.hp, seed = seed))

    def init_msd(self, seed = 0):
        """Random multi-scale discriminator params (the port's layout)."""
        from ..init import init_msd
        return convert_tree(init_msd(self.hp, seed = seed))

    def _apply_period_d(self, p, audio, period, slope):
        B, T = audio.shape
        pad = (-T) % period
        if pad:
            # reflection needs pad <= T - 1; the JAX package takes the edge beyond
            mode = 'reflect' if pad <= T - 1 else 'replicate'
            audio = F.pad(audio[:, None], (0, pad), mode = mode)[:, 0]
        # (B, T/p, p) → the p phases as B·p signals of T/p samples
        x = audio.reshape(B, -1, period).transpose(1, 2).reshape(B * period, -1, 1)
        feats = []
        for ci in range(len(p['convs'])):
            x = F.leaky_relu(nn.conv1d(p['convs']['c{}'.format(ci)], x, stride = 3), slope)
            feats.append(x)
        x = F.leaky_relu(nn.conv1d(p['conv5'], x), slope)
        feats.append(x)
        x = nn.conv1d(p['post'], x)
        feats.append(x)
        return x.reshape(B, -1), feats

    def apply_mpd(self, params, audio):
        """audio (B, T) → [(score (B, ·), features)] per period."""
        return [self._apply_period_d(params['p{}'.format(i)], audio, period, self.hp.leaky_slope)
                for i, period in enumerate(self.hp.mpd_periods)]

    def _apply_scale_d(self, p, audio, slope):
        x = audio[..., None]
        feats = []
        for ci, (_, stride, groups, _) in enumerate(MSD_SPECS):
            x = F.leaky_relu(nn.conv1d(p['convs']['c{}'.format(ci)], x, stride = stride,
                                       groups = groups), slope)
            feats.append(x)
        x = nn.conv1d(p['post'], x)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats

    def apply_msd(self, params, audio):
        """audio (B, T) → [(score (B, ·), features)] per scale: the waveform,
        then average-pooled ×2, ×4, ..."""
        out, x = [], audio
        for i in range(self.hp.msd_scales):
            if i > 0:
                x = _pool(x)
            out.append(self._apply_scale_d(params['s{}'.format(i)], x, self.hp.leaky_slope))
        return out

    # -- the losses -----------------------------------------------------------------

    @staticmethod
    def discriminator_loss(real_outs, fake_outs):
        """LSGAN: real scores to 1, fake ones to 0 (the fake audio detached
        by the caller); float32 means."""
        loss = 0.
        for (real, _), (fake, _) in zip(real_outs, fake_outs):
            loss = loss + _mean32((real.float() - 1.) ** 2) + _mean32(fake.float() ** 2)
        return loss

    @staticmethod
    def generator_adversarial_loss(fake_outs):
        loss = 0.
        for fake, _ in fake_outs:
            loss = loss + _mean32((fake.float() - 1.) ** 2)
        return loss

    @staticmethod
    def feature_matching_loss(real_outs, fake_outs):
        loss = 0.
        for (_, real_feats), (_, fake_feats) in zip(real_outs, fake_outs):
            for r, f in zip(real_feats, fake_feats):
                loss = loss + _mean32(torch.abs(r.float() - f.float()))
        return loss

    def discriminator_terms(self, disc_params, fake, real, *, compute_dtype = None):
        """The discriminators' LSGAN loss on (fake, real) waveforms of one
        length, `fake` detached by the caller; under `compute_dtype` both
        discriminators and both waveforms cast to it."""
        if compute_dtype is not None:
            disc_params = cast_tree(disc_params, compute_dtype)
            fake, real = fake.to(compute_dtype), real.to(compute_dtype)
        return (self.discriminator_loss(self.apply_mpd(disc_params['mpd'], real),
                                        self.apply_mpd(disc_params['mpd'], fake))
                + self.discriminator_loss(self.apply_msd(disc_params['msd'], real),
                                          self.apply_msd(disc_params['msd'], fake)))

    def generator_terms(self, disc_params, fake, real, mel_fn = None, *, compute_dtype = None):
        """{'adv', 'fm', 'mel'} of the generator's objective on (fake, real)
        waveforms of one length: the discriminators in `compute_dtype`
        (their operands cast), the L1 distance of `mel_fn`'s float32 mels of
        the float32 waveforms (0. without `mel_fn`)."""
        fake_c = fake if compute_dtype is None else fake.to(compute_dtype)
        real_c = real.to(fake_c.dtype)
        if compute_dtype is not None:
            disc_params = cast_tree(disc_params, compute_dtype)
        mpd_real = self.apply_mpd(disc_params['mpd'], real_c)
        mpd_fake = self.apply_mpd(disc_params['mpd'], fake_c)
        msd_real = self.apply_msd(disc_params['msd'], real_c)
        msd_fake = self.apply_msd(disc_params['msd'], fake_c)
        adv = self.generator_adversarial_loss(mpd_fake) + self.generator_adversarial_loss(msd_fake)
        fm = (self.feature_matching_loss(mpd_real, mpd_fake)
              + self.feature_matching_loss(msd_real, msd_fake))
        mel_l1 = torch.mean(torch.abs(mel_fn(fake.float()) - mel_fn(real.float()))) \
            if mel_fn is not None else 0.
        return {'adv': adv, 'fm': fm, 'mel': mel_l1}

    def generator_loss(self, gen_params, disc_params, mel_fn, mel, audio, *, lambda_mel = 45.,
                       lambda_fm = 2., compute_dtype = None):
        """The HiFi-GAN generator objective → (loss, {'adv', 'fm', 'mel'}):
        ``adv + lambda_fm * fm + lambda_mel * mel`` on the generator's audio
        and `audio`, both cut to the shorter."""
        fake = self.apply(gen_params, mel, dtype = compute_dtype)
        n = min(fake.shape[1], audio.shape[1])
        terms = self.generator_terms(disc_params, fake[:, :n], audio[:, :n], mel_fn,
                                     compute_dtype = compute_dtype)
        loss = terms['adv'] + lambda_fm * terms['fm'] + lambda_mel * terms['mel']
        return loss, terms

    def discriminator_step_loss(self, disc_params, gen_params, mel, audio, *,
                                compute_dtype = None):
        """The discriminators' objective on the generator's detached audio
        and `audio`, both cut to the shorter."""
        fake = self.apply(gen_params, mel, dtype = compute_dtype).detach()
        n = min(fake.shape[1], audio.shape[1])
        return self.discriminator_terms(disc_params, fake[:, :n], audio[:, :n],
                                        compute_dtype = compute_dtype)


class HiFiGAN(GANDiscriminators):
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

    def apply(self, params, mel, *, cond = None, dtype = None, tp = None):
        """mel (B, T, n_mel) → float32 waveform (B, T * total_upsampling);
        under `dtype` the params and the mel are cast.  `tp` (a
        `parallel.collectives.Axis`): ``conv_pre`` holds this rank's out
        channels and the first upsample its in channels
        (`parallel.vits_param_specs`); their partial sums are all-reduced
        before the upsample's bias, and the rest runs whole."""
        hp = self.hp
        x = mel
        if dtype is not None:
            x = x.to(dtype)
            params = cast_tree(params, dtype)
        x = nn.col_parallel(nn.conv1d, params['conv_pre'], x, tp)
        if cond is not None:
            x = x + tp_split(cond, -1, tp)[:, None, :].to(x.dtype)
        n_kernels = len(hp.resblock_kernel_sizes)
        for i, rate in enumerate(hp.upsample_rates):
            stage = params['up{}'.format(i)]
            x = nn.row_parallel(nn.conv1d_transpose, stage['up'], F.leaky_relu(x, hp.leaky_slope),
                                tp if i == 0 else None, stride = rate)
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
