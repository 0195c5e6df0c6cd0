"""Random parameter trees in the JAX package's layout, made with numpy.

`init_tacotron2`, `init_waveglow`, `init_audio_encoder`, `init_fastspeech2`,
`init_hifigan`, `init_mpd`, `init_msd`, `init_vocos` and `init_vits`
follow the JAX package's ``init`` methods
(glorot-uniform kernels, orthogonal recurrent and invertible kernels, unit
forget bias, identity batch and layer norms, the identity 'start' speaker
projection) but draw from a numpy generator, so that
NVIDIA-size models can be built without JAX and the same arrays can be
handed to both packages.  Pass the trees through `weights.tacotron2_from_jax`
/ `weights.waveglow_from_jax` / `weights.audio_encoder_from_jax`, or
FastSpeech-2's params and state each through `weights.convert_tree`,
HiFi-GAN's and Vocos's through `weights.hifigan_from_jax`, the
discriminators' through `weights.convert_tree` and VITS's through
`weights.vits_from_jax`, for the port.

`nvidia_tacotron2_state_dict`, `nvidia_waveglow_state_dict`,
`hifigan_state_dict`, `vocos_state_dict` and `vits_state_dict` make seeded
state dicts in the published PyTorch layouts (names, shapes, weight norm),
for the importers of `models.tts_checkpoints`.

WaveGlow's ``end`` convs start at zero in the JAX package, which leaves the
waveform independent of the WN blocks; here they get small normal weights
(`end_scale`) so that a random vocoder exercises every block.
"""

import math
import warnings

import numpy as np


def _glorot(rng, shape, in_axis = -2, out_axis = -1):
    receptive = int(np.prod([s for i, s in enumerate(shape)
                             if i not in (in_axis % len(shape), out_axis % len(shape))]))
    fan_in, fan_out = shape[in_axis] * receptive, shape[out_axis] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def _orthogonal(rng, shape):
    n_rows, n_cols = shape
    a = rng.standard_normal((max(shape), max(shape)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))[None, :]
    return q[:n_rows, :n_cols].astype(np.float32)


def _dense(rng, n_in, n_out, use_bias = True):
    out = {'kernel': _glorot(rng, (n_in, n_out))}
    if use_bias: out['bias'] = np.zeros((n_out,), np.float32)
    return out


def _conv(rng, width, n_in, n_out, use_bias = True):
    out = {'kernel': _glorot(rng, (width, n_in, n_out), in_axis = 1, out_axis = 2)}
    if use_bias: out['bias'] = np.zeros((n_out,), np.float32)
    return out


def _lstm(rng, n_in, units):
    bias = np.zeros((4 * units,), np.float32)
    bias[units: 2 * units] = 1.
    return {'kernel': _glorot(rng, (n_in, 4 * units)),
            'recurrent_kernel': _orthogonal(rng, (units, 4 * units)),
            'bias': bias}


def _batch_norm(dim):
    return ({'gamma': np.ones((dim,), np.float32), 'beta': np.zeros((dim,), np.float32)},
            {'moving_mean': np.zeros((dim,), np.float32),
             'moving_var': np.ones((dim,), np.float32)})


def _postnet(rng, hp):
    """The conv + batch-norm postnet of Tacotron-2 and FastSpeech-2:
    (params, state)."""
    post, post_state = {}, {}
    ch_in = hp.n_mel_channels
    for i in range(hp.postnet_n_conv):
        ch_out = hp.n_mel_channels if i == hp.postnet_n_conv - 1 else hp.postnet_filters
        bn, bn_state = _batch_norm(ch_out)
        post['conv_{}'.format(i)] = {
            'conv': _conv(rng, hp.postnet_kernel_size, ch_in, ch_out), 'bn': bn}
        post_state['conv_{}'.format(i)] = {'bn': bn_state}
        ch_in = ch_out
    return post, post_state


def init_tacotron2(hp, seed = 0):
    """(params, state) for a `Tacotron2` with hparams `hp`, speaker widths
    included (`speaker_embedding_dim`, `speaker_concat_pos`)."""
    from .models.tacotron2_arch import Tacotron2
    arch = Tacotron2(** hp.get_config())
    D = arch.encoder_output_dim
    rng = np.random.default_rng(seed)
    enc, enc_state = {}, {}
    enc['embedding'] = {'embeddings': rng.uniform(
        -0.05, 0.05, (hp.vocab_size, hp.encoder_embedding_dim)).astype(np.float32)}
    if 'start' in arch.concat_pos:
        E = hp.encoder_embedding_dim
        # the identity on the embedding's rows, zeros on the speaker's
        enc['speaker_projection'] = {
            'kernel': np.eye(E + hp.speaker_embedding_dim, E, dtype = np.float32),
            'bias': np.zeros((E,), np.float32)}
    for i in range(hp.encoder_n_conv):
        bn, bn_state = _batch_norm(hp.encoder_embedding_dim)
        enc['conv_{}'.format(i)] = {
            'conv': _conv(rng, hp.encoder_kernel_size, hp.encoder_embedding_dim,
                          hp.encoder_embedding_dim),
            'bn': bn}
        enc_state['conv_{}'.format(i)] = {'bn': bn_state}
    half = hp.encoder_embedding_dim // 2
    enc['bilstm'] = {'forward': _lstm(rng, hp.encoder_embedding_dim, half),
                     'backward': _lstm(rng, hp.encoder_embedding_dim, half)}

    dec = {'prenet': {}}
    pre_in = arch.prenet_in_dim
    for i, size in enumerate(hp.prenet_sizes):
        dec['prenet']['layer_{}'.format(i)] = _dense(rng, pre_in, size, hp.prenet_use_bias)
        pre_in = size
    dec['attention_rnn'] = _lstm(rng, hp.prenet_sizes[-1] + D, hp.attention_rnn_dim)
    dec['attention'] = {
        'query': _dense(rng, hp.attention_rnn_dim, hp.lsa_attention_dim, False),
        'memory': _dense(rng, D, hp.lsa_attention_dim, False),
        'location_conv': _conv(rng, hp.lsa_attention_kernel_size, 2,
                               hp.lsa_attention_filters, False),
        'location_dense': _dense(rng, hp.lsa_attention_filters, hp.lsa_attention_dim, False),
        'value': _dense(rng, hp.lsa_attention_dim, 1, False),
    }
    rnn_in, rnns = hp.attention_rnn_dim + D, {}
    for i in range(hp.decoder_n_lstm):
        rnns['cell_{}'.format(i)] = _lstm(rng, rnn_in, hp.decoder_rnn_dim)
        rnn_in = hp.decoder_rnn_dim
    dec['decoder_rnn'] = rnns
    proj_in = hp.decoder_rnn_dim + D
    r = hp.n_frames_per_step
    dec['linear_projection'] = _dense(rng, proj_in, hp.n_mel_channels * r)
    gate_in = proj_in + (hp.n_mel_channels * r if hp.pred_stop_on_mel else 0)
    dec['gate_layer'] = _dense(rng, gate_in, r)

    post, post_state = _postnet(rng, hp)
    params = {'encoder': enc, 'decoder': dec, 'postnet': post}
    state = {'encoder': enc_state, 'postnet': post_state}
    return params, state


def init_waveglow(hp, flow_channels, seed = 0, end_scale = 1e-2):
    """Params for a `WaveGlow` with hparams `hp` and per-flow audio channel
    counts `flow_channels` (`WaveGlow.flow_channels`)."""
    rng = np.random.default_rng(seed)
    cond = hp.n_mel_channels * hp.n_group
    C = hp.wn_channels
    params = {'upsample': _conv(rng, hp.upsample_width, hp.n_mel_channels,
                                hp.n_mel_channels)}
    for k, c in enumerate(flow_channels):
        n_half = c // 2
        block = {
            'start': _conv(rng, 1, n_half, C),
            'end': {'kernel': (end_scale * rng.standard_normal((1, C, 2 * n_half)))
                    .astype(np.float32),
                    'bias': np.zeros((2 * n_half,), np.float32)},
        }
        for i in range(hp.wn_layers):
            block['in_conv_{}'.format(i)] = _conv(rng, hp.wn_kernel_size, C, 2 * C)
            block['cond_conv_{}'.format(i)] = _conv(rng, 1, cond, 2 * C)
            out_ch = 2 * C if i < hp.wn_layers - 1 else C
            block['res_skip_conv_{}'.format(i)] = _conv(rng, 1, C, out_ch)
        params['flow_{}'.format(k)] = {'convinv': {'kernel': _orthogonal(rng, (c, c))},
                                       'block': block}
    return params


def init_audio_encoder(hp, seed = 0, statistics = False):
    """(params, state) for an `AudioEncoder` with hparams `hp`.  With
    `statistics`, the batch norms get seeded running statistics and affine
    parameters away from the identity, so that a random encoder exercises
    every term of its inference batch norm."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    ch_in = hp.n_mel_channels
    for i, ch_out in enumerate(hp.filters):
        bn, bn_state = _batch_norm(ch_out)
        if statistics:
            bn = {'gamma': rng.uniform(0.5, 1.5, ch_out).astype(np.float32),
                  'beta': (0.1 * rng.standard_normal(ch_out)).astype(np.float32)}
            bn_state = {'moving_mean': (0.1 * rng.standard_normal(ch_out)).astype(np.float32),
                        'moving_var': rng.uniform(0.5, 2., ch_out).astype(np.float32)}
        params['conv_{}'.format(i)] = {'conv': _conv(rng, hp.kernel_size, ch_in, ch_out),
                                       'bn': bn}
        state['conv_{}'.format(i)] = {'bn': bn_state}
        ch_in = ch_out
    # statistics pooling (mean ⊕ std) doubles the channels
    params['projection'] = _dense(rng, 2 * ch_in, hp.embedding_dim)
    params['ge2e'] = {'w': np.array(10., np.float32), 'b': np.array(-5., np.float32)}
    return params, state


def _layer_norm(dim):
    return {'gamma': np.ones((dim,), np.float32), 'beta': np.zeros((dim,), np.float32)}


def init_fastspeech2(hp, seed = 0):
    """(params, state) for a `FastSpeech2` with hparams `hp`, in the tree of
    the JAX package's ``FastSpeech2.init`` (glorot kernels, zero biases,
    uniform embeddings, identity layer and batch norms)."""
    rng = np.random.default_rng(seed)
    k1, k2 = hp.ffn_kernels

    def fft_block():
        return {'attention': {name: _dense(rng, hp.dim, hp.dim)
                              for name in ('query', 'key', 'value', 'output')},
                'attention_norm': _layer_norm(hp.dim),
                'conv1': _conv(rng, k1, hp.dim, hp.ffn_dim),
                'conv2': _conv(rng, k2, hp.ffn_dim, hp.dim),
                'ffn_norm': _layer_norm(hp.dim)}

    def variance_predictor():
        k, f = hp.variance_kernel_size, hp.variance_filters
        return {'conv1': _conv(rng, k, hp.dim, f), 'norm1': _layer_norm(f),
                'conv2': _conv(rng, k, f, f), 'norm2': _layer_norm(f),
                'proj': _dense(rng, f, 1)}

    def embedding(n):
        return {'embeddings': rng.uniform(-0.05, 0.05, (n, hp.dim)).astype(np.float32)}

    params = {
        'embedding': embedding(hp.vocab_size),
        'encoder': {'layer_{}'.format(i): fft_block() for i in range(hp.encoder_layers)},
        'decoder': {'layer_{}'.format(i): fft_block() for i in range(hp.decoder_layers)},
        'duration_predictor': variance_predictor(),
        'mel_linear': _dense(rng, hp.dim, hp.n_mel_channels),
    }
    for name in ('pitch', 'energy'):
        if hp['use_' + name]:
            params[name + '_predictor'] = variance_predictor()
            params[name + '_embedding'] = embedding(hp.n_bins)
    if hp.speaker_embedding_dim:
        params['speaker_projection'] = _dense(rng, hp.speaker_embedding_dim, hp.dim)
    state = {}
    if hp.use_postnet:
        params['postnet'], post_state = _postnet(rng, hp)
        state = {'postnet': post_state}
    return params, state


def _conv_transpose(rng, width, n_in, n_out):
    """A transposed conv in the JAX layout (W, in, out), glorot over in and out."""
    return {'kernel': _glorot(rng, (width, n_in, n_out), in_axis = 1, out_axis = 2),
            'bias': np.zeros((n_out,), np.float32)}


def init_hifigan(hp, seed = 0):
    """Params of a HiFi-GAN generator with hparams `hp` (the JAX
    ``HiFiGAN.init`` tree: `conv_pre`, ``up<i>`` stages of a transposed conv
    ``up`` and residual blocks ``res<j>/d<k>``, `conv_post`)."""
    rng = np.random.default_rng(seed)
    params = {'conv_pre': _conv(rng, 7, hp.n_mel_channels, hp.upsample_initial_channel)}
    ch = hp.upsample_initial_channel
    for i, width in enumerate(hp.upsample_kernel_sizes):
        out_ch = ch // 2
        stage = {'up': _conv_transpose(rng, width, ch, out_ch)}
        for j, (k, dils) in enumerate(zip(hp.resblock_kernel_sizes, hp.resblock_dilation_sizes)):
            stage['res{}'.format(j)] = {
                'd{}'.format(di): ({'conv1': _conv(rng, k, out_ch, out_ch),
                                    'conv2': _conv(rng, k, out_ch, out_ch)}
                                   if hp.resblock_version == 1 else
                                   {'conv1': _conv(rng, k, out_ch, out_ch)})
                for di in range(len(dils))}
        params['up{}'.format(i)] = stage
        ch = out_ch
    params['conv_post'] = _conv(rng, 7, ch, 1)
    return params


def init_mpd(hp, seed = 0):
    """Params of HiFi-GAN's multi-period discriminator for hparams `hp`
    (its `mpd_periods`), the JAX ``HiFiGAN.init_mpd`` tree: per period
    ``p<i>`` the width-5 convs ``convs/c<k>`` at the published channels,
    `conv5` and `post` (width 3)."""
    from .models.hifigan_arch import MPD_CHANNELS
    rng = np.random.default_rng(seed)

    def period():
        convs, n_in = {}, 1
        for ci, n_out in enumerate(MPD_CHANNELS):
            convs['c{}'.format(ci)] = _conv(rng, 5, n_in, n_out)
            n_in = n_out
        return {'convs': convs, 'conv5': _conv(rng, 3, n_in, 1024),
                'post': _conv(rng, 3, 1024, 1)}
    return {'p{}'.format(i): period() for i in range(len(hp.mpd_periods))}


def init_msd(hp, seed = 0):
    """Params of HiFi-GAN's multi-scale discriminator for hparams `hp` (its
    `msd_scales`), the JAX ``HiFiGAN.init_msd`` tree: per scale ``s<i>`` the
    convs ``convs/c<k>`` of `MSD_SPECS`, grouped kernels (W, in / groups,
    out), and `post` (width 3)."""
    from .models.hifigan_arch import MSD_SPECS
    rng = np.random.default_rng(seed)
    scales = {}
    for si in range(hp.msd_scales):
        convs, n_in = {}, 1
        for ci, (width, _, groups, n_out) in enumerate(MSD_SPECS):
            convs['c{}'.format(ci)] = _conv(rng, width, n_in // groups, n_out)
            n_in = n_out
        scales['s{}'.format(si)] = {'convs': convs, 'post': _conv(rng, 3, n_in, 1)}
    return scales


def init_vocos(hp, seed = 0):
    """Params of a Vocos generator with hparams `hp` (the JAX ``Vocos.init``
    tree; the layer scale `gamma` at ``1 / n_layers`` unless `layer_scale`)."""
    rng = np.random.default_rng(seed)
    scale = 1. / hp.n_layers if hp.layer_scale is None else float(hp.layer_scale)
    params = {'embed': _conv(rng, hp.kernel_size, hp.n_mel_channels, hp.dim),
              'norm_pre': _layer_norm(hp.dim), 'norm_post': _layer_norm(hp.dim)}
    for i in range(hp.n_layers):
        params['block_{}'.format(i)] = {
            'depthwise': _conv(rng, hp.kernel_size, 1, hp.dim),
            'norm': _layer_norm(hp.dim),
            'pw1': _dense(rng, hp.dim, hp.intermediate_dim),
            'pw2': _dense(rng, hp.intermediate_dim, hp.dim),
            'gamma': np.full((hp.dim,), scale, np.float32)}
    params['head'] = _dense(rng, hp.dim, hp.n_fft + 2)
    return params


def init_vits(hp, seed = 0):
    """Params of a `VITS` with hparams `hp`, in the JAX ``VITS.init`` tree
    (its conditioning heads when it has speakers; the couplings' `post` and
    the ConvFlows' `proj` at zero, so that every flow starts as the
    identity, as there)."""
    rng = np.random.default_rng(seed)
    cond = bool(hp.n_speakers or hp.speaker_embedding_dim)
    H, C, half = hp.hidden_channels, hp.inter_channels, hp.inter_channels // 2

    def wn(n_layers, kernel):
        out = {}
        for i in range(n_layers):
            out['in_conv_{}'.format(i)] = _conv(rng, kernel, H, 2 * H)
            out['res_skip_conv_{}'.format(i)] = _conv(rng, 1, H, 2 * H if i < n_layers - 1 else H)
        if cond: out['cond'] = _dense(rng, hp.gin_channels, n_layers * 2 * H)
        return out

    def text_block():
        block = {'attention': {name: _dense(rng, H, H)
                               for name in ('query', 'key', 'value', 'output')},
                 'attention_norm': _layer_norm(H),
                 'conv1': _conv(rng, hp.text_kernel_size, H, hp.filter_channels),
                 'conv2': _conv(rng, hp.text_kernel_size, hp.filter_channels, H),
                 'ffn_norm': _layer_norm(H)}
        if hp.text_rel_window is not None:
            head_dim = H // hp.n_heads
            for name in ('rel_k', 'rel_v'):
                block[name] = (rng.standard_normal((2 * hp.text_rel_window + 1, head_dim))
                               * head_dim ** -0.5).astype(np.float32)
        return block

    def dds(f):
        return {'layer_{}'.format(i): {'depthwise': _conv(rng, hp.sdp_kernel_size, 1, f),
                                       'pointwise': _conv(rng, 1, f, f),
                                       'norm1': _layer_norm(f), 'norm2': _layer_norm(f)}
                for i in range(hp.sdp_dds_layers)}

    def flow_stack(f):
        stack = {'affine': {'m': np.zeros((2,), np.float32), 'logs': np.zeros((2,), np.float32)}}
        n_out = 3 * hp.sdp_n_bins - 1
        for i in range(hp.sdp_n_flows):
            stack['conv_flow_{}'.format(i)] = {
                'pre': _conv(rng, 1, 1, f), 'dds': dds(f),
                'proj': {'kernel': np.zeros((1, f, n_out), np.float32),
                         'bias': np.zeros((n_out,), np.float32)}}
        return stack

    params = {
        'embedding': {'embeddings': rng.uniform(-0.05, 0.05, (hp.vocab_size, H))
                      .astype(np.float32)},
        'text_encoder': {'layer_{}'.format(i): text_block() for i in range(hp.n_text_layers)},
        'text_proj': _conv(rng, 1, H, 2 * C),
        'posterior': {'pre': _conv(rng, 1, hp.spec_channels, H),
                      'wn': wn(hp.posterior_layers, hp.posterior_kernel_size),
                      'proj': _conv(rng, 1, H, 2 * C)},
    }
    if hp.use_sdp:
        f = hp.sdp_filter_channels
        dp = {'pre': _conv(rng, 1, H, f), 'dds': dds(f), 'proj': _conv(rng, 1, f, f),
              'flows': flow_stack(f), 'post_pre': _conv(rng, 1, 1, f), 'post_dds': dds(f),
              'post_proj': _conv(rng, 1, f, f), 'post_flows': flow_stack(f)}
        if cond: dp['cond'] = _dense(rng, hp.gin_channels, f)
    else:
        k, f = hp.duration_kernel_size, hp.duration_filters
        dp = {'conv1': _conv(rng, k, H, f), 'norm1': _layer_norm(f),
              'conv2': _conv(rng, k, f, f), 'norm2': _layer_norm(f), 'proj': _dense(rng, f, 1)}
    params['duration_predictor'] = dp
    from .models.vits_arch import VITS
    params['generator'] = init_hifigan(VITS(** hp.get_config()).generator.hp, seed = seed + 1)
    for k in range(hp.flow_layers):
        params['flow_{}'.format(k)] = {
            'pre': _conv(rng, 1, half, H), 'wn': wn(hp.flow_wn_layers, hp.flow_kernel_size),
            'post': {'kernel': np.zeros((1, H, half), np.float32),
                     'bias': np.zeros((half,), np.float32)}}
    if hp.n_speakers:
        params['speaker_embedding'] = {'embeddings': rng.uniform(
            -0.05, 0.05, (hp.n_speakers, hp.gin_channels)).astype(np.float32)}
    if hp.speaker_embedding_dim:
        params['speaker_projection'] = _dense(rng, hp.speaker_embedding_dim, hp.gin_channels)
    if cond:
        params['generator_cond'] = _dense(rng, hp.gin_channels, hp.upsample_initial_channel)
        if not hp.use_sdp:
            params['duration_cond'] = _dense(rng, hp.gin_channels, H)
    return params


class _StateDict(dict):
    """A seeded state dict in a published layout: `add` draws ``scale *
    N(0, 1)`` float32 values; `add_normed` draws a weight-normed layer's
    ``weight_v`` and a positive ``weight_g`` (one per output row, torch's
    default ``dim=0``)."""

    def __init__(self, seed, scale):
        super().__init__()
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def add(self, name, * shape, scale = None):
        self[name] = ((self.scale if scale is None else scale)
                      * self.rng.standard_normal(shape)).astype(np.float32)

    def add_conv(self, prefix, n_out, n_in, width, *, bias = True, normed = False,
                 scale = None):
        if normed:
            self.add(prefix + '.weight_v', n_out, n_in, width, scale = scale)
            self[prefix + '.weight_g'] = self.rng.uniform(0.5, 1.5, (n_out, 1, 1))                 .astype(np.float32) * np.float32(self.scale if scale is None else scale)                 * np.float32(np.sqrt(n_in * width))
        else:
            self.add(prefix + '.weight', n_out, n_in, width, scale = scale)
        if bias:
            self.add(prefix + '.bias', n_out, scale = scale)


def _hifigan_generator_sd(sd, prefix, n_mel, upsample_rates, upsample_kernel_sizes,
                          upsample_initial_channel, resblock_kernel_sizes,
                          resblock_dilation_sizes, *, pre_normed, post_bias):
    """The official generator's tensors under `prefix`: `conv_pre`, the
    weight-normed ``ups`` (ConvTranspose1d, (in, out, k)) and ``resblocks``
    (``convs1`` / ``convs2``), `conv_post`."""
    ch = upsample_initial_channel
    sd.add_conv(prefix + 'conv_pre', ch, n_mel, 7, normed = pre_normed)
    n_kernels = len(resblock_kernel_sizes)
    for i, width in enumerate(upsample_kernel_sizes):
        sd.add(prefix + 'ups.{}.weight_v'.format(i), ch, ch // 2, width)
        sd[prefix + 'ups.{}.weight_g'.format(i)] = sd.rng.uniform(0.5, 1.5, (ch, 1, 1))             .astype(np.float32) * np.float32(sd.scale * np.sqrt(ch // 2 * width))
        sd.add(prefix + 'ups.{}.bias'.format(i), ch // 2)
        ch //= 2
        for j, (k, dils) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
            r = i * n_kernels + j
            for d in range(len(dils)):
                for conv in ('convs1', 'convs2'):
                    sd.add_conv(prefix + 'resblocks.{}.{}.{}'.format(r, conv, d), ch, ch, k,
                                normed = True)
    sd.add_conv(prefix + 'conv_post', 1, ch, 7, bias = post_bias, normed = pre_normed)


def hifigan_state_dict(seed = 0, *, n_mel = 80, upsample_rates = (8, 8, 2, 2),
                       upsample_kernel_sizes = (16, 16, 4, 4), upsample_initial_channel = 512,
                       resblock_kernel_sizes = (3, 7, 11),
                       resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                       scale = 0.02):
    """A seeded HiFi-GAN V1 generator ``state_dict`` (numpy) as the official
    release ships it (``generator.`` keys dropped): weight norm on every
    conv, ResBlock1 pairs, at V1's widths unless given; values ``scale *
    N(0, 1)``, each ``weight_g`` row ``U(0.5, 1.5) * scale * sqrt(fan_in)``
    (the norm of its ``weight_v`` row, about)."""
    sd = _StateDict(seed, scale)
    _hifigan_generator_sd(sd, '', n_mel, upsample_rates, upsample_kernel_sizes,
                          upsample_initial_channel, resblock_kernel_sizes,
                          resblock_dilation_sizes, pre_normed = True, post_bias = True)
    return dict(sd)


def vocos_state_dict(seed = 0, *, n_mel = 80, dim = 512, intermediate_dim = 1536,
                     n_layers = 8, kernel_size = 7, n_fft = 1024, scale = 0.02):
    """A seeded Vocos ``state_dict`` (numpy) in the published mel release's
    layout (``backbone.embed``, ``backbone.norm``, ``backbone.convnext.<i>``
    with ``dwconv``, ``norm``, ``pwconv1``, ``pwconv2`` and ``gamma``,
    ``backbone.final_layer_norm``, ``head.out``), at `HParamsVocos`' widths
    unless given: values ``scale * N(0, 1)``, the layer norms near the
    identity, ``gamma`` at ``1 / n_layers``."""
    sd = _StateDict(seed, scale)

    def norm(prefix):
        sd[prefix + '.weight'] = (1. + 0.1 * sd.rng.standard_normal(dim)).astype(np.float32)
        sd.add(prefix + '.bias', dim)

    sd.add_conv('backbone.embed', dim, n_mel, kernel_size)
    norm('backbone.norm')
    for i in range(n_layers):
        p = 'backbone.convnext.{}'.format(i)
        sd.add_conv(p + '.dwconv', dim, 1, kernel_size, scale = 0.2)
        norm(p + '.norm')
        sd.add(p + '.pwconv1.weight', intermediate_dim, dim)
        sd.add(p + '.pwconv1.bias', intermediate_dim)
        sd.add(p + '.pwconv2.weight', dim, intermediate_dim)
        sd.add(p + '.pwconv2.bias', dim)
        sd[p + '.gamma'] = np.full((dim,), 1. / n_layers, np.float32)
    norm('backbone.final_layer_norm')
    sd.add('head.out.weight', n_fft + 2, dim)
    sd.add('head.out.bias', n_fft + 2)
    return dict(sd)


def vits_state_dict(seed = 0, *, vocab_size = 148, spec_channels = 513, inter_channels = 192,
                    hidden_channels = 192, filter_channels = 768, n_heads = 2, n_layers = 6,
                    kernel_size = 3, window = 4, posterior_layers = 16, flow_layers = 4,
                    flow_wn_layers = 4, wn_kernel = 5, sdp_n_flows = 4, sdp_dds_layers = 3,
                    sdp_n_bins = 10, n_speakers = None, gin_channels = 256,
                    upsample_rates = (8, 8, 2, 2), upsample_kernel_sizes = (16, 16, 4, 4),
                    upsample_initial_channel = 512, resblock_kernel_sizes = (3, 7, 11),
                    resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                    scale = 0.02):
    """A seeded VITS ``SynthesizerTrn`` ``state_dict`` (numpy) as the
    official LJSpeech release ships it, at its widths unless given: the
    relative-window text encoder (``enc_p``), the WaveNet posterior
    (``enc_q``), the residual couplings (``flow.flows``, at even indices),
    the stochastic duration predictor (``dp`` with ``dp.flows``: an
    ElementwiseAffine, then ConvFlows at odd indices) and the HiFi-GAN
    decoder (``dec``: plain `conv_pre`, `conv_post` without bias); weight
    norm on the WaveNet and decoder convs, as there.  `n_speakers` adds
    ``emb_g`` and the conditioning layers.  Values ``scale * N(0, 1)``, the
    layer norms near the identity."""
    sd = _StateDict(seed, scale)
    H, C, F_, half = hidden_channels, inter_channels, hidden_channels, inter_channels // 2
    head_dim = H // n_heads
    gin = gin_channels if n_speakers else None

    def norm(prefix, dim):
        sd[prefix + '.gamma'] = (1. + 0.1 * sd.rng.standard_normal(dim)).astype(np.float32)
        sd.add(prefix + '.beta', dim)

    def wn(prefix, n):
        for i in range(n):
            sd.add_conv('{}.in_layers.{}'.format(prefix, i), 2 * H, H, wn_kernel, normed = True)
            sd.add_conv('{}.res_skip_layers.{}'.format(prefix, i),
                        2 * H if i < n - 1 else H, H, 1, normed = True)
        if gin:
            sd.add_conv(prefix + '.cond_layer', 2 * H * n, gin, 1, normed = True)

    def dds(prefix):
        for i in range(sdp_dds_layers):
            sd.add_conv('{}.convs_sep.{}'.format(prefix, i), F_, 1, kernel_size, scale = 0.2)
            sd.add_conv('{}.convs_1x1.{}'.format(prefix, i), F_, F_, 1)
            norm('{}.norms_1.{}'.format(prefix, i), F_)
            norm('{}.norms_2.{}'.format(prefix, i), F_)

    def flows(prefix):
        sd.add(prefix + '.0.m', 2, 1)
        sd.add(prefix + '.0.logs', 2, 1)
        for i in range(sdp_n_flows):
            p = '{}.{}'.format(prefix, 1 + 2 * i)
            sd.add_conv(p + '.pre', F_, 1, 1)
            dds(p + '.convs')
            sd.add_conv(p + '.proj', 3 * sdp_n_bins - 1, F_, 1)

    sd.add('enc_p.emb.weight', vocab_size, H, scale = H ** -0.5)
    for i in range(n_layers):
        a = 'enc_p.encoder.attn_layers.{}'.format(i)
        for name in ('conv_q', 'conv_k', 'conv_v', 'conv_o'):
            sd.add_conv('{}.{}'.format(a, name), H, H, 1, scale = H ** -0.5)
        sd.add(a + '.emb_rel_k', 1, 2 * window + 1, head_dim, scale = head_dim ** -0.5)
        sd.add(a + '.emb_rel_v', 1, 2 * window + 1, head_dim, scale = head_dim ** -0.5)
        norm('enc_p.encoder.norm_layers_1.{}'.format(i), H)
        sd.add_conv('enc_p.encoder.ffn_layers.{}.conv_1'.format(i), filter_channels, H,
                    kernel_size)
        sd.add_conv('enc_p.encoder.ffn_layers.{}.conv_2'.format(i), H, filter_channels,
                    kernel_size)
        norm('enc_p.encoder.norm_layers_2.{}'.format(i), H)
    sd.add_conv('enc_p.proj', 2 * C, H, 1)
    sd.add_conv('enc_q.pre', H, spec_channels, 1)
    wn('enc_q.enc', posterior_layers)
    sd.add_conv('enc_q.proj', 2 * C, H, 1)
    for k in range(flow_layers):
        p = 'flow.flows.{}'.format(2 * k)
        sd.add_conv(p + '.pre', H, half, 1)
        wn(p + '.enc', flow_wn_layers)
        sd.add_conv(p + '.post', half, H, 1)
    _hifigan_generator_sd(sd, 'dec.', C, upsample_rates, upsample_kernel_sizes,
                          upsample_initial_channel, resblock_kernel_sizes,
                          resblock_dilation_sizes, pre_normed = False, post_bias = False)
    sd.add_conv('dp.pre', F_, H, 1)
    dds('dp.convs')
    sd.add_conv('dp.proj', F_, F_, 1)
    flows('dp.flows')
    sd.add_conv('dp.post_pre', F_, 1, 1)
    dds('dp.post_convs')
    sd.add_conv('dp.post_proj', F_, F_, 1)
    flows('dp.post_flows')
    if gin:
        sd.add('emb_g.weight', n_speakers, gin)
        sd.add_conv('dp.cond', F_, gin, 1)
        sd.add_conv('dec.cond', upsample_initial_channel, gin, 1)
    return dict(sd)


def nvidia_tacotron2_state_dict(seed = 0, *, vocab_size = 148, embedding_dim = 512,
                                prenet_dim = 256, attention_rnn_dim = 1024,
                                decoder_rnn_dim = 1024, attention_dim = 128,
                                location_filters = 32, location_kernel = 31,
                                postnet_filters = 512, n_mel = 80, gate_bias = None):
    """A seeded Tacotron-2 ``state_dict`` (numpy) in NVIDIA's layout and
    names (3 encoder convs of width 5, a BiLSTM, 2 prenet layers, 5 postnet
    convs), at NVIDIA's widths unless given: values ``0.05 * N(0, 1)``,
    running variances ``|N(0, 1)| + 0.5``.  `gate_bias` sets the stop
    gate's bias (far negative keeps a random decoder running)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, * shape):
        sd[name] = (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def batch_norm(prefix, dim):
        add(prefix + '.weight', dim)
        add(prefix + '.bias', dim)
        add(prefix + '.running_mean', dim)
        sd[prefix + '.running_var'] = (np.abs(rng.standard_normal(dim)) + 0.5).astype(np.float32)

    def lstm(prefix, n_in, units, suffix = ''):
        add('{}.weight_ih{}'.format(prefix, suffix), 4 * units, n_in)
        add('{}.weight_hh{}'.format(prefix, suffix), 4 * units, units)
        add('{}.bias_ih{}'.format(prefix, suffix), 4 * units)
        add('{}.bias_hh{}'.format(prefix, suffix), 4 * units)

    E, A, R = embedding_dim, attention_rnn_dim, decoder_rnn_dim
    add('embedding.weight', vocab_size, E)
    for i in range(3):
        add('encoder.convolutions.{}.0.conv.weight'.format(i), E, E, 5)
        add('encoder.convolutions.{}.0.conv.bias'.format(i), E)
        batch_norm('encoder.convolutions.{}.1'.format(i), E)
    for suffix in ('_l0', '_l0_reverse'):
        lstm('encoder.lstm', E, E // 2, suffix)
    add('decoder.prenet.layers.0.linear_layer.weight', prenet_dim, n_mel)
    add('decoder.prenet.layers.1.linear_layer.weight', prenet_dim, prenet_dim)
    lstm('decoder.attention_rnn', prenet_dim + E, A)
    attention = 'decoder.attention_layer.'
    add(attention + 'query_layer.linear_layer.weight', attention_dim, A)
    add(attention + 'memory_layer.linear_layer.weight', attention_dim, E)
    add(attention + 'v.linear_layer.weight', 1, attention_dim)
    add(attention + 'location_layer.location_conv.conv.weight', location_filters, 2,
        location_kernel)
    add(attention + 'location_layer.location_dense.linear_layer.weight', attention_dim,
        location_filters)
    lstm('decoder.decoder_rnn', A + E, R)
    add('decoder.linear_projection.linear_layer.weight', n_mel, R + E)
    add('decoder.linear_projection.linear_layer.bias', n_mel)
    add('decoder.gate_layer.linear_layer.weight', 1, R + E)
    add('decoder.gate_layer.linear_layer.bias', 1)
    if gate_bias is not None:
        sd['decoder.gate_layer.linear_layer.bias'][:] = gate_bias
    for i in range(5):
        ch_in = n_mel if i == 0 else postnet_filters
        ch_out = n_mel if i == 4 else postnet_filters
        add('postnet.convolutions.{}.0.conv.weight'.format(i), ch_out, ch_in, 5)
        add('postnet.convolutions.{}.0.conv.bias'.format(i), ch_out)
        batch_norm('postnet.convolutions.{}.1'.format(i), ch_out)
    return sd


def nvidia_waveglow_state_dict(seed = 0, *, n_flows = 12, n_group = 8, n_early_every = 4,
                               n_early_size = 2, wn_layers = 8, wn_channels = 512, n_mel = 80,
                               upsample_width = 1024, upsample_stride = 256,
                               end_scale = 1e-2):
    """A seeded WaveGlow ``state_dict`` (torch tensors) as NVIDIA's release
    ships it: its module names, a fused cond layer per WN block, early
    outputs every `n_early_every` flows, and ``torch.nn.utils.weight_norm``
    on the start, in, res/skip and cond convs (``weight_g`` / ``weight_v``),
    at NVIDIA's widths unless given.  Glorot-uniform convs, orthogonal
    invertible convs, and ``end`` convs of scale `end_scale` (as
    `init_waveglow`), so that a random vocoder gives finite audio."""
    import torch

    rng = np.random.default_rng(seed)
    C = wn_channels

    def weight_norm(layer):
        with warnings.catch_warnings():      # the parametrization gives other keys
            warnings.simplefilter('ignore', FutureWarning)
            return torch.nn.utils.weight_norm(layer)

    def conv(n_in, n_out, width = 1, dilation = 1, scale = None, normed = True):
        layer = torch.nn.Conv1d(n_in, n_out, width, dilation = dilation,
                                padding = dilation * (width - 1) // 2)
        weight = (scale * rng.standard_normal((n_out, n_in, width))).astype(np.float32) \
            if scale is not None else _glorot(rng, (n_out, n_in, width), in_axis = 1, out_axis = 0)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(weight))
            layer.bias.zero_()
        return weight_norm(layer) if normed else layer

    model = torch.nn.Module()
    model.upsample = torch.nn.ConvTranspose1d(n_mel, n_mel, upsample_width,
                                              stride = upsample_stride)
    with torch.no_grad():
        model.upsample.weight.copy_(torch.from_numpy(_glorot(
            rng, (n_mel, n_mel, upsample_width), in_axis = 0, out_axis = 1)))
        model.upsample.bias.zero_()
    model.WN, model.convinv = torch.nn.ModuleList(), torch.nn.ModuleList()
    remaining = n_group
    for k in range(n_flows):
        if k % n_early_every == 0 and k > 0:
            remaining -= n_early_size
        n_half = remaining // 2
        wn = torch.nn.Module()
        wn.start = conv(n_half, C)
        wn.end = conv(C, 2 * n_half, scale = end_scale, normed = False)
        wn.cond_layer = conv(n_mel * n_group, 2 * C * wn_layers)
        wn.in_layers = torch.nn.ModuleList(
            [conv(C, 2 * C, 3, dilation = 2 ** i) for i in range(wn_layers)])
        wn.res_skip_layers = torch.nn.ModuleList(
            [conv(C, 2 * C if i < wn_layers - 1 else C) for i in range(wn_layers)])
        model.WN.append(wn)
        invertible = torch.nn.Module()
        invertible.conv = torch.nn.Conv1d(remaining, remaining, 1, bias = False)
        with torch.no_grad():
            invertible.conv.weight.copy_(torch.from_numpy(
                _orthogonal(rng, (remaining, remaining))[..., None]))
        model.convinv.append(invertible)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def random_tts_models(device = None, *, tacotron2 = {}, waveglow = {}, seed = 0):
    """(Tacotron2, WaveGlow) task models with random weights, at NVIDIA sizes
    unless `tacotron2` / `waveglow` override hparams; vocabulary: the
    default English symbols.  A random stop gate would end decoding at an
    arbitrary step, so its bias is set far negative: the decoder runs to
    ``max_length`` frames."""
    from .models.tacotron2_arch import HParamsTacotron2
    from .models.tts import Tacotron2, WaveGlow
    from .models.waveglow_arch import WaveGlow as WaveGlowArch
    from .text import default_english_tokenizer, en_symbols

    config = dict(tacotron2, vocab_size = len(en_symbols))
    params, state = init_tacotron2(HParamsTacotron2(** config), seed = seed)
    params['decoder']['gate_layer']['bias'][:] = -50.
    model = Tacotron2.from_jax(params, state, tokenizer = default_english_tokenizer(),
                               device = device, ** config)
    arch = WaveGlowArch(** waveglow)
    vocoder = WaveGlow.from_jax(init_waveglow(arch.hp, arch.flow_channels, seed = seed + 1),
                                device = device, ** waveglow)
    return model, vocoder
