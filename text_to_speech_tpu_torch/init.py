"""Random parameter trees in the JAX package's layout, made with numpy.

`init_tacotron2`, `init_waveglow` and `init_audio_encoder` follow the JAX
package's ``init`` methods (glorot-uniform kernels, orthogonal recurrent and
invertible kernels, unit forget bias, identity batch norms, the identity
'start' speaker projection) but draw from a numpy generator, so that
NVIDIA-size models can be built without JAX and the same arrays can be
handed to both packages.  Pass the trees through `weights.tacotron2_from_jax`
/ `weights.waveglow_from_jax` / `weights.audio_encoder_from_jax` for the
port.

WaveGlow's ``end`` convs start at zero in the JAX package, which leaves the
waveform independent of the WN blocks; here they get small normal weights
(`end_scale`) so that a random vocoder exercises every block.
"""

import math

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

    post, post_state = {}, {}
    ch_in = hp.n_mel_channels
    for i in range(hp.postnet_n_conv):
        ch_out = hp.n_mel_channels if i == hp.postnet_n_conv - 1 else hp.postnet_filters
        bn, bn_state = _batch_norm(ch_out)
        post['conv_{}'.format(i)] = {
            'conv': _conv(rng, hp.postnet_kernel_size, ch_in, ch_out), 'bn': bn}
        post_state['conv_{}'.format(i)] = {'bn': bn_state}
        ch_in = ch_out
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
