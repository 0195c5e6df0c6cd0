"""Importers for published PyTorch TTS checkpoints.

The port's copy of ``text_to_speech_tpu/models/tts_checkpoints.py``:
NVIDIA's Tacotron-2 and WaveGlow, the official HiFi-GAN generator
(`convert_hifigan`, both resblock versions), the Vocos mel release
(`convert_vocos`) and the official VITS ``SynthesizerTrn`` (`convert_vits`:
the relative-window text encoder, the WaveNet posterior, the residual
couplings, either duration predictor, the HiFi-GAN decoder, the speaker
layers), each with the architecture sizes read from the tensors' shapes
(``*_config_from_state_dict``).  The converters rebuild the JAX package's
numpy parameter trees from the PyTorch ``state_dict`` layouts;
`weights.tacotron2_from_jax` / `weights.waveglow_from_jax` /
`weights.hifigan_from_jax` / `weights.vits_from_jax` then turn those trees
into the port's, so that both
packages share one definition of every layout:

  - Linear (out, in) → kernel (in, out): ``.T``
  - Conv1d (out, in, k) → kernel (k, in, out): ``transpose(2, 1, 0)``
  - ConvTranspose1d (in, out, k) → kernel (k, in, out) with the width
    flipped: ``transpose(2, 0, 1)[::-1]``
  - LSTM / LSTMCell ``weight_ih`` (4H, in) → kernel (in, 4H): ``.T``; the two
    biases sum into one; the gate order i, f, g, o is kept.

`_load_state_dict` reads a dict, a ``.pt`` / ``.pth`` file holding a state
dict (at its top level, under ``state_dict`` or under ``model``), or a
``.safetensors`` file (`load_safetensors`).
"""

import json
import os
import re

import numpy as np
import torch


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _strip_prefix(sd, pattern):
    """`sd` with `pattern` (a wrapper prefix such as ``module.``) cut from
    its keys; `sd` itself when no key matches."""
    if not any(re.match(pattern, k) for k in sd):
        return sd
    return {re.sub(pattern, '', k): v for k, v in sd.items()}


def _count(sd, pattern):
    """1 + the largest index that `pattern`'s group matches in a key, 0 if none."""
    idx = [int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m]
    return 1 + max(idx) if idx else 0


def _conv(sd, prefix):
    out = {'kernel': np.ascontiguousarray(np.asarray(sd[prefix + '.weight']).transpose(2, 1, 0))}
    if prefix + '.bias' in sd:
        out['bias'] = np.asarray(sd[prefix + '.bias'])
    return out


def _dense(sd, prefix):
    out = {'kernel': _t(sd[prefix + '.weight'])}
    if prefix + '.bias' in sd:
        out['bias'] = np.asarray(sd[prefix + '.bias'])
    return out


def _lstm_cell(sd, prefix, suffix = ''):
    return {
        'kernel': _t(sd['{}.weight_ih{}'.format(prefix, suffix)]),
        'recurrent_kernel': _t(sd['{}.weight_hh{}'.format(prefix, suffix)]),
        'bias': (np.asarray(sd['{}.bias_ih{}'.format(prefix, suffix)])
                 + np.asarray(sd['{}.bias_hh{}'.format(prefix, suffix)])),
    }


def _batch_norm(sd, prefix):
    params = {'gamma': np.asarray(sd[prefix + '.weight']),
              'beta': np.asarray(sd[prefix + '.bias'])}
    state = {'moving_mean': np.asarray(sd[prefix + '.running_mean']),
             'moving_var': np.asarray(sd[prefix + '.running_var'])}
    return params, state


def convert_nvidia_tacotron2(sd):
    """NVIDIA Tacotron-2 ``state_dict`` → the JAX package's (params, state)
    trees of `Tacotron2` (numpy)."""
    sd = _strip_prefix(sd, r'^module\.')
    params = {'encoder': {}, 'decoder': {}, 'postnet': {}}
    state = {'encoder': {}, 'postnet': {}}

    params['encoder']['embedding'] = {'embeddings': np.asarray(sd['embedding.weight'])}
    for i in range(3):
        conv = _conv(sd, 'encoder.convolutions.{}.0.conv'.format(i))
        bn, bn_state = _batch_norm(sd, 'encoder.convolutions.{}.1'.format(i))
        params['encoder']['conv_{}'.format(i)] = {'conv': conv, 'bn': bn}
        state['encoder']['conv_{}'.format(i)] = {'bn': bn_state}
    params['encoder']['bilstm'] = {
        'forward': _lstm_cell(sd, 'encoder.lstm', '_l0'),
        'backward': _lstm_cell(sd, 'encoder.lstm', '_l0_reverse'),
    }

    dec = params['decoder']
    dec['prenet'] = {
        'layer_0': _dense(sd, 'decoder.prenet.layers.0.linear_layer'),
        'layer_1': _dense(sd, 'decoder.prenet.layers.1.linear_layer'),
    }
    dec['attention_rnn'] = _lstm_cell(sd, 'decoder.attention_rnn')
    dec['attention'] = {
        'query': _dense(sd, 'decoder.attention_layer.query_layer.linear_layer'),
        'memory': _dense(sd, 'decoder.attention_layer.memory_layer.linear_layer'),
        'value': _dense(sd, 'decoder.attention_layer.v.linear_layer'),
        'location_conv': _conv(sd, 'decoder.attention_layer.location_layer.location_conv.conv'),
        'location_dense': _dense(
            sd, 'decoder.attention_layer.location_layer.location_dense.linear_layer'),
    }
    dec['decoder_rnn'] = {'cell_0': _lstm_cell(sd, 'decoder.decoder_rnn')}
    dec['linear_projection'] = _dense(sd, 'decoder.linear_projection.linear_layer')
    dec['gate_layer'] = _dense(sd, 'decoder.gate_layer.linear_layer')

    for i in range(5):
        conv = _conv(sd, 'postnet.convolutions.{}.0.conv'.format(i))
        bn, bn_state = _batch_norm(sd, 'postnet.convolutions.{}.1'.format(i))
        params['postnet']['conv_{}'.format(i)] = {'conv': conv, 'bn': bn}
        state['postnet']['conv_{}'.format(i)] = {'bn': bn_state}
    return params, state


def convert_nvidia_waveglow(sd):
    """NVIDIA WaveGlow ``state_dict`` (weight norm folded) → the JAX
    package's params tree of `WaveGlow` with fused cond layers (numpy)."""
    sd = _strip_prefix(sd, r'^module\.')
    params = {'upsample': {
        'kernel': np.ascontiguousarray(np.asarray(sd['upsample.weight']).transpose(2, 0, 1)[::-1]),
        'bias': np.asarray(sd['upsample.bias']),
    }}
    n_flows = _count(sd, r'WN\.(\d+)\.')
    n_layers = _count(sd, r'WN\.\d+\.in_layers\.(\d+)\.')
    for k in range(n_flows):
        w = np.asarray(sd['convinv.{}.conv.weight'.format(k)])[:, :, 0]
        block = {
            'start': _conv(sd, 'WN.{}.start'.format(k)),
            'end': _conv(sd, 'WN.{}.end'.format(k)),
            'cond_layer': _conv(sd, 'WN.{}.cond_layer'.format(k)),
        }
        for i in range(n_layers):
            block['in_conv_{}'.format(i)] = _conv(sd, 'WN.{}.in_layers.{}'.format(k, i))
            block['res_skip_conv_{}'.format(i)] = _conv(
                sd, 'WN.{}.res_skip_layers.{}'.format(k, i))
        # torch's 1x1 conv computes y_c = sum_d W[c, d] x_d, that is x @ W.T
        params['flow_{}'.format(k)] = {'convinv': {'kernel': _t(w)}, 'block': block}
    return params


def tacotron2_config_from_state_dict(sd):
    """The `HParamsTacotron2` sizes that an NVIDIA-layout ``state_dict``'s
    shapes give; rates and flags keep their defaults."""
    sd = _strip_prefix(sd, r'^module\.')
    shp = lambda k: tuple(np.shape(sd[k]))
    vocab_size, emb = shp('embedding.weight')
    location = 'decoder.attention_layer.location_layer.location_conv.conv.weight'
    return {
        'vocab_size': vocab_size,
        'encoder_embedding_dim': emb,
        'encoder_n_conv': _count(sd, r'encoder\.convolutions\.(\d+)\.'),
        'encoder_kernel_size': shp('encoder.convolutions.0.0.conv.weight')[2],
        'prenet_sizes': tuple(
            shp('decoder.prenet.layers.{}.linear_layer.weight'.format(i))[0]
            for i in range(_count(sd, r'decoder\.prenet\.layers\.(\d+)\.'))),
        'lsa_attention_dim': shp('decoder.attention_layer.query_layer.linear_layer.weight')[0],
        'lsa_attention_filters': shp(location)[0],
        'lsa_attention_kernel_size': shp(location)[2],
        'attention_rnn_dim': shp('decoder.attention_rnn.weight_hh')[1],
        'decoder_rnn_dim': shp('decoder.decoder_rnn.weight_hh')[1],
        'postnet_n_conv': _count(sd, r'postnet\.convolutions\.(\d+)\.'),
        'postnet_filters': shp('postnet.convolutions.0.0.conv.weight')[0],
        'postnet_kernel_size': shp('postnet.convolutions.0.0.conv.weight')[2],
        'n_mel_channels': shp('decoder.linear_projection.linear_layer.weight')[0],
    }


def waveglow_config_from_state_dict(sd):
    """The `HParamsWaveGlow` sizes that an NVIDIA-layout ``state_dict``
    (weight norm folded) gives.  The early-output schedule comes from the
    per-flow 1x1 conv channel counts.  ``upsample_stride`` is in no shape
    (the published checkpoints use 256)."""
    sd = _strip_prefix(sd, r'^module\.')
    shp = lambda k: tuple(np.shape(sd[k]))
    n_flows = _count(sd, r'WN\.(\d+)\.')
    remaining = [shp('convinv.{}.conv.weight'.format(k))[0] for k in range(n_flows)]
    n_early_every, n_early_size = n_flows + 1, 0
    for k in range(1, n_flows):
        if remaining[k] < remaining[k - 1]:
            n_early_every = k
            n_early_size = remaining[k - 1] - remaining[k]
            break
    return {
        'n_mel_channels': shp('upsample.weight')[0],
        'n_flows': n_flows,
        'n_group': remaining[0],
        'n_early_every': n_early_every,
        'n_early_size': n_early_size,
        'wn_layers': _count(sd, r'WN\.0\.in_layers\.(\d+)\.'),
        'wn_channels': shp('WN.0.start.weight')[0],
        'wn_kernel_size': shp('WN.0.in_layers.0.weight')[2],
        'wn_fused': 'WN.0.cond_layer.weight' in sd,
        'upsample_width': shp('upsample.weight')[2],
    }


def convert_hifigan(sd, *, num_kernels = None):
    """An official HiFi-GAN generator ``state_dict`` (weight norm folded:
    `conv_pre`, ``ups.N``, ``resblocks.{stage * num_kernels + j}``,
    `conv_post`) → the JAX package's params tree.  Version 1 / 2 resblocks
    name their conv lists ``convs1`` / ``convs2``, version 3 (ResBlock2)
    one ``convs`` list; `num_kernels` defaults to the resblocks over the
    stages."""
    sd = _strip_prefix(sd, r'^(module\.|generator\.)')
    params = {'conv_pre': _conv(sd, 'conv_pre'), 'conv_post': _conv(sd, 'conv_post')}
    n_up = _count(sd, r'ups\.(\d+)\.')
    n_resblocks = _count(sd, r'resblocks\.(\d+)\.')
    if num_kernels is None:
        if n_resblocks % n_up:
            raise ValueError('cannot infer num_kernels: {} resblocks over {} '
                             'stages'.format(n_resblocks, n_up))
        num_kernels = n_resblocks // n_up

    def _dils(prefix):
        return _count(sd, re.escape(prefix) + r'\.(\d+)\.')

    for i in range(n_up):
        stage = {'up': {'kernel': np.ascontiguousarray(
            np.asarray(sd['ups.{}.weight'.format(i)]).transpose(2, 0, 1)[::-1])}}
        if 'ups.{}.bias'.format(i) in sd:
            stage['up']['bias'] = np.asarray(sd['ups.{}.bias'.format(i)])
        for j in range(num_kernels):
            r = i * num_kernels + j
            paired = _dils('resblocks.{}.convs1'.format(r))
            if paired:                                   # ResBlock1
                stage['res{}'.format(j)] = {
                    'd{}'.format(d): {
                        'conv1': _conv(sd, 'resblocks.{}.convs1.{}'.format(r, d)),
                        'conv2': _conv(sd, 'resblocks.{}.convs2.{}'.format(r, d))}
                    for d in range(paired)}
            else:                                        # ResBlock2
                n_dil = _dils('resblocks.{}.convs'.format(r))
                if not n_dil:
                    raise KeyError('no convs found for resblocks.{}'.format(r))
                stage['res{}'.format(j)] = {
                    'd{}'.format(d): {'conv1': _conv(sd, 'resblocks.{}.convs.{}'.format(r, d))}
                    for d in range(n_dil)}
        params['up{}'.format(i)] = stage
    return params


def load_hifigan(path_or_sd, ** kwargs):
    """An official HiFi-GAN generator checkpoint → the JAX package's params tree."""
    return convert_hifigan(remove_torch_weight_norm(_load_state_dict(path_or_sd)), ** kwargs)


def hifigan_config_from_state_dict(sd):
    """The `HParamsHiFiGAN` fields that an official generator's shapes
    give.  ``upsample_rates`` are taken as kernel // 2 and the dilations as
    the published ones ((1, 3, 5) a kernel for ResBlock1, ((1, 2), (2, 6),
    (3, 12)) for ResBlock2): no weight shape holds them."""
    sd = _strip_prefix(sd, r'^(module\.|generator\.)')
    shp = lambda k: tuple(np.shape(sd[k]))
    n_up = _count(sd, r'ups\.(\d+)\.')
    num_kernels = _count(sd, r'resblocks\.(\d+)\.') // n_up
    version = 1 if 'resblocks.0.convs1.0.weight' in sd else 2
    res_key = 'convs1' if version == 1 else 'convs'
    kernels = [shp('ups.{}.weight'.format(i))[2] for i in range(n_up)]
    n_dil = _count(sd, r'resblocks\.0\.{}\.(\d+)\.'.format(res_key))
    if version == 2:
        v3 = ((1, 2), (2, 6), (3, 12))
        dilations = tuple(v3[j % len(v3)][:n_dil] for j in range(num_kernels))
    else:
        dilations = tuple(tuple((1, 3, 5)[:n_dil]) for _ in range(num_kernels))
    return {
        'n_mel_channels': shp('conv_pre.weight')[1],
        'upsample_initial_channel': shp('conv_pre.weight')[0],
        'upsample_kernel_sizes': tuple(kernels),
        'upsample_rates': tuple(k // 2 for k in kernels),
        'resblock_version': version,
        'resblock_kernel_sizes': tuple(
            shp('resblocks.{}.{}.0.weight'.format(j, res_key))[2] for j in range(num_kernels)),
        'resblock_dilation_sizes': dilations,
    }


def convert_vocos(sd):
    """An official Vocos ``state_dict`` (``backbone.convnext`` layout) → the
    JAX package's params tree."""
    sd = _strip_prefix(sd, r'^(module\.|model\.)')

    def norm(prefix):
        return {'gamma': np.asarray(sd[prefix + '.weight']).reshape(-1),
                'beta': np.asarray(sd[prefix + '.bias']).reshape(-1)}

    params = {'embed': _conv(sd, 'backbone.embed'), 'norm_pre': norm('backbone.norm'),
              'norm_post': norm('backbone.final_layer_norm'), 'head': _dense(sd, 'head.out')}
    for i in range(_count(sd, r'backbone\.convnext\.(\d+)\.')):
        p = 'backbone.convnext.{}'.format(i)
        params['block_{}'.format(i)] = {
            'depthwise': _conv(sd, p + '.dwconv'), 'norm': norm(p + '.norm'),
            'pw1': _dense(sd, p + '.pwconv1'), 'pw2': _dense(sd, p + '.pwconv2'),
            'gamma': np.asarray(sd[p + '.gamma']).reshape(-1)}
    return params


def vocos_config_from_state_dict(sd):
    """The `HParamsVocos` fields that the shapes give; window = n_fft and
    hop = n_fft / 4, the published convention."""
    sd = _strip_prefix(sd, r'^(module\.|model\.)')
    shp = lambda k: tuple(np.shape(sd[k]))
    dim, n_mels, kernel = shp('backbone.embed.weight')
    n_fft = shp('head.out.weight')[0] - 2
    return {'dim': dim, 'n_mel_channels': n_mels, 'kernel_size': kernel,
            'n_layers': _count(sd, r'backbone\.convnext\.(\d+)\.'),
            'intermediate_dim': shp('backbone.convnext.0.pwconv1.weight')[0],
            'n_fft': n_fft, 'win_length': n_fft, 'hop_length': max(1, n_fft // 4)}


def load_vocos(path_or_sd):
    """An official Vocos checkpoint → the JAX package's params tree."""
    return convert_vocos(remove_torch_weight_norm(_load_state_dict(path_or_sd)))


def _dense1x1(sd, prefix):
    """A PyTorch Conv1d of width 1 (out, in, 1) → a dense kernel (in, out)."""
    out = {'kernel': _t(np.asarray(sd[prefix + '.weight'])[..., 0])}
    if prefix + '.bias' in sd:
        out['bias'] = np.asarray(sd[prefix + '.bias'])
    return out


def _norm_gb(sd, prefix):
    return {'gamma': np.asarray(sd[prefix + '.gamma']).reshape(-1),
            'beta': np.asarray(sd[prefix + '.beta']).reshape(-1)}


def _vits_wn(sd, prefix):
    """The official WN module (`in_layers`, `res_skip_layers`, optional
    `cond_layer`) → the wn subtree."""
    wn = {}
    for i in range(_count(sd, re.escape(prefix) + r'\.in_layers\.(\d+)\.')):
        wn['in_conv_{}'.format(i)] = _conv(sd, '{}.in_layers.{}'.format(prefix, i))
        wn['res_skip_conv_{}'.format(i)] = _conv(sd, '{}.res_skip_layers.{}'.format(prefix, i))
    if '{}.cond_layer.weight'.format(prefix) in sd:
        wn['cond'] = _dense1x1(sd, prefix + '.cond_layer')
    return wn


def _vits_dds(sd, prefix):
    """The official DDSConv (`convs_sep` depthwise, `convs_1x1`, two layer
    norms a layer) → the dds subtree."""
    dds = {}
    for i in range(_count(sd, re.escape(prefix) + r'\.convs_sep\.(\d+)\.')):
        dds['layer_{}'.format(i)] = {
            'depthwise': _conv(sd, '{}.convs_sep.{}'.format(prefix, i)),
            'pointwise': _dense_to_conv(_dense1x1(sd, '{}.convs_1x1.{}'.format(prefix, i))),
            'norm1': _norm_gb(sd, '{}.norms_1.{}'.format(prefix, i)),
            'norm2': _norm_gb(sd, '{}.norms_2.{}'.format(prefix, i)),
        }
    return dds


def _dense_to_conv(dense):
    """A dense (in, out) → a pointwise conv kernel (1, in, out)."""
    out = {'kernel': dense['kernel'][None]}
    if 'bias' in dense:
        out['bias'] = dense['bias']
    return out


def _vits_flow_stack(sd, prefix):
    """The official SDP flow list ([ElementwiseAffine] + [ConvFlow, Flip] ×
    n, the ConvFlows at odd indices) → the stack subtree."""
    stack = {'affine': {'m': np.asarray(sd[prefix + '.0.m']).reshape(-1),
                        'logs': np.asarray(sd[prefix + '.0.logs']).reshape(-1)}}
    n_items = _count(sd, re.escape(prefix) + r'\.(\d+)\.')
    conv_flows = [i for i in range(1, n_items) if '{}.{}.pre.weight'.format(prefix, i) in sd]
    for out_i, i in enumerate(sorted(conv_flows)):
        p = '{}.{}'.format(prefix, i)
        stack['conv_flow_{}'.format(out_i)] = {
            'pre': _conv(sd, p + '.pre'), 'dds': _vits_dds(sd, p + '.convs'),
            'proj': _conv(sd, p + '.proj')}
    return stack


def convert_vits(sd):
    """An official VITS ``SynthesizerTrn`` ``state_dict`` (weight norm
    folded) → the JAX package's params tree: the text encoder (`enc_p`),
    the posterior (`enc_q`), the couplings (`flow`, at even indices), the
    decoder (`dec`, by `convert_hifigan`), the duration predictor (`dp`:
    stochastic when ``dp.flows.0.m`` is there, the conv stack otherwise)
    and the speaker layers (`emb_g`, `dec.cond`, the cond layers)."""
    sd = _strip_prefix(sd, r'^(module\.|model\.)')
    params = {
        'embedding': {'embeddings': np.asarray(sd['enc_p.emb.weight'])},
        'text_proj': _conv(sd, 'enc_p.proj'),
        'posterior': {'pre': _conv(sd, 'enc_q.pre'), 'wn': _vits_wn(sd, 'enc_q.enc'),
                      'proj': _conv(sd, 'enc_q.proj')},
        'generator': convert_hifigan(
            {k[len('dec.'):]: sd[k] for k in list(sd)
             if k.startswith('dec.') and not k.startswith('dec.cond')}),
    }
    text = {}
    for i in range(_count(sd, r'enc_p\.encoder\.attn_layers\.(\d+)\.')):
        a = 'enc_p.encoder.attn_layers.{}'.format(i)
        blk = {
            'attention': {'query': _dense1x1(sd, a + '.conv_q'),
                          'key': _dense1x1(sd, a + '.conv_k'),
                          'value': _dense1x1(sd, a + '.conv_v'),
                          'output': _dense1x1(sd, a + '.conv_o')},
            'attention_norm': _norm_gb(sd, 'enc_p.encoder.norm_layers_1.{}'.format(i)),
            'conv1': _conv(sd, 'enc_p.encoder.ffn_layers.{}.conv_1'.format(i)),
            'conv2': _conv(sd, 'enc_p.encoder.ffn_layers.{}.conv_2'.format(i)),
            'ffn_norm': _norm_gb(sd, 'enc_p.encoder.norm_layers_2.{}'.format(i)),
        }
        if a + '.emb_rel_k' in sd:      # (1, 2w + 1, head_dim), shared by the heads
            blk['rel_k'] = np.asarray(sd[a + '.emb_rel_k'])[0]
            blk['rel_v'] = np.asarray(sd[a + '.emb_rel_v'])[0]
        text['layer_{}'.format(i)] = blk
    params['text_encoder'] = text

    couplings = sorted({int(m.group(1)) for k in sd
                        for m in [re.match(r'flow\.flows\.(\d+)\.pre\.', k)] if m})
    for out_k, k in enumerate(couplings):
        p = 'flow.flows.{}'.format(k)
        params['flow_{}'.format(out_k)] = {'pre': _conv(sd, p + '.pre'),
                                           'wn': _vits_wn(sd, p + '.enc'),
                                           'post': _conv(sd, p + '.post')}

    if 'dp.flows.0.m' in sd:
        dp = {'pre': _conv(sd, 'dp.pre'), 'dds': _vits_dds(sd, 'dp.convs'),
              'proj': _conv(sd, 'dp.proj'), 'flows': _vits_flow_stack(sd, 'dp.flows'),
              'post_pre': _conv(sd, 'dp.post_pre'), 'post_dds': _vits_dds(sd, 'dp.post_convs'),
              'post_proj': _conv(sd, 'dp.post_proj'),
              'post_flows': _vits_flow_stack(sd, 'dp.post_flows')}
        if 'dp.cond.weight' in sd:
            dp['cond'] = _dense1x1(sd, 'dp.cond')
        params['duration_predictor'] = dp
    else:
        params['duration_predictor'] = {
            'conv1': _conv(sd, 'dp.conv_1'), 'norm1': _norm_gb(sd, 'dp.norm_1'),
            'conv2': _conv(sd, 'dp.conv_2'), 'norm2': _norm_gb(sd, 'dp.norm_2'),
            'proj': _dense1x1(sd, 'dp.proj')}
        if 'dp.cond.weight' in sd:
            params['duration_cond'] = _dense1x1(sd, 'dp.cond')

    if 'emb_g.weight' in sd:
        params['speaker_embedding'] = {'embeddings': np.asarray(sd['emb_g.weight'])}
    if 'dec.cond.weight' in sd:
        params['generator_cond'] = _dense1x1(sd, 'dec.cond')
    return params


def load_vits(path_or_sd):
    """An official VITS checkpoint → the JAX package's params tree."""
    return convert_vits(remove_torch_weight_norm(_load_state_dict(path_or_sd)))


def vits_config_from_state_dict(sd):
    """The `HParamsVITS` fields that an official ``SynthesizerTrn``'s shapes
    give.  Not in the shapes (defaults kept): `n_heads` without relative
    tables, the upsample strides (kernel // 2), the dilations, the dropout
    rates and the pad token."""
    sd = _strip_prefix(sd, r'^(module\.|model\.)')
    shp = lambda k: tuple(np.shape(sd[k]))
    config = {}
    config['vocab_size'], config['hidden_channels'] = shp('enc_p.emb.weight')
    config['inter_channels'] = shp('enc_p.proj.weight')[0] // 2
    config['spec_channels'] = shp('enc_q.pre.weight')[1]
    config['n_text_layers'] = _count(sd, r'enc_p\.encoder\.attn_layers\.(\d+)\.')
    config['filter_channels'], _, config['text_kernel_size'] = \
        shp('enc_p.encoder.ffn_layers.0.conv_1.weight')
    rel = 'enc_p.encoder.attn_layers.0.emb_rel_k'
    if rel in sd:
        _, n_rel, head_dim = shp(rel)
        config['text_rel_window'] = (n_rel - 1) // 2
        config['n_heads'] = config['hidden_channels'] // head_dim
    else:
        config['text_rel_window'] = None
    config['posterior_layers'] = _count(sd, r'enc_q\.enc\.in_layers\.(\d+)\.')
    config['posterior_kernel_size'] = shp('enc_q.enc.in_layers.0.weight')[2]
    config['flow_layers'] = len({int(m.group(1)) for k in sd
                                 for m in [re.match(r'flow\.flows\.(\d+)\.pre\.', k)] if m})
    config['flow_wn_layers'] = _count(sd, r'flow\.flows\.0\.enc\.in_layers\.(\d+)\.')
    config['flow_kernel_size'] = shp('flow.flows.0.enc.in_layers.0.weight')[2]
    config['use_sdp'] = 'dp.flows.0.m' in sd
    if config['use_sdp']:
        config['sdp_filter_channels'] = shp('dp.pre.weight')[0]
        config['sdp_kernel_size'] = shp('dp.convs.convs_sep.0.weight')[2]
        config['sdp_dds_layers'] = _count(sd, r'dp\.convs\.convs_sep\.(\d+)\.')
        config['sdp_n_flows'] = sum(1 for k in sd if re.match(r'dp\.flows\.\d+\.pre\.weight$', k))
        # a ConvFlow's proj has half_channels (1) * (3 n_bins - 1) outputs
        first = min(int(m.group(1)) for k in sd
                    for m in [re.match(r'dp\.flows\.(\d+)\.proj\.weight$', k)] if m)
        config['sdp_n_bins'] = (shp('dp.flows.{}.proj.weight'.format(first))[0] + 1) // 3
    else:
        config['duration_filters'] = shp('dp.conv_1.weight')[0]
        config['duration_kernel_size'] = shp('dp.conv_1.weight')[2]
    if 'emb_g.weight' in sd:
        config['n_speakers'], config['gin_channels'] = shp('emb_g.weight')
    config['upsample_initial_channel'] = shp('dec.conv_pre.weight')[0]
    n_up = _count(sd, r'dec\.ups\.(\d+)\.')
    kernels = [shp('dec.ups.{}.weight'.format(i))[2] for i in range(n_up)]
    config['upsample_kernel_sizes'] = tuple(kernels)
    config['upsample_rates'] = tuple(k // 2 for k in kernels)
    num_kernels = _count(sd, r'dec\.resblocks\.(\d+)\.') // n_up
    config['resblock_version'] = 1 if 'dec.resblocks.0.convs1.0.weight' in sd else 2
    res_key = 'convs1' if config['resblock_version'] == 1 else 'convs'
    config['resblock_kernel_sizes'] = tuple(
        shp('dec.resblocks.{}.{}.0.weight'.format(j, res_key))[2] for j in range(num_kernels))
    n_dil = _count(sd, r'dec\.resblocks\.0\.{}\.(\d+)\.'.format(res_key))
    config['resblock_dilation_sizes'] = tuple(
        tuple((1, 3, 5)[:n_dil]) for _ in range(num_kernels))
    return config


def remove_torch_weight_norm(sd):
    """Fold PyTorch's weight norm (``weight_g`` / ``weight_v`` pairs) into
    plain weights, as NVIDIA's WaveGlow ships them; `sd` itself when
    nothing is weight-normed."""
    if not any(k.endswith('weight_g') for k in sd):
        return sd
    out = {}
    for key, value in sd.items():
        if key.endswith('weight_g'):
            continue
        if key.endswith('weight_v'):
            base = key[: -len('weight_v')]
            g = np.asarray(sd[base + 'weight_g'])
            v = np.asarray(value)
            norm = np.sqrt(np.sum(v ** 2, axis = tuple(range(1, v.ndim)), keepdims = True))
            out[base + 'weight'] = g * v / np.maximum(norm, 1e-12)
        else:
            out[key] = np.asarray(value)
    return out


def load_nvidia_tacotron2(path_or_sd):
    """An NVIDIA Tacotron-2 checkpoint (file or state dict) → the JAX
    package's (params, state) trees."""
    return convert_nvidia_tacotron2(_load_state_dict(path_or_sd))


def load_nvidia_waveglow(path_or_sd):
    """An NVIDIA WaveGlow checkpoint (file or state dict) → the JAX
    package's params tree."""
    return convert_nvidia_waveglow(remove_torch_weight_norm(_load_state_dict(path_or_sd)))


# safetensors dtype tags → numpy dtypes (BF16 goes through torch)
_SAFETENSORS_DTYPES = {
    'F64': np.float64, 'F32': np.float32, 'F16': np.float16,
    'I64': np.int64, 'I32': np.int32, 'I16': np.int16, 'I8': np.int8,
    'U64': np.uint64, 'U32': np.uint32, 'U16': np.uint16, 'U8': np.uint8,
    'BOOL': np.bool_,
}


def load_safetensors(path):
    """A ``.safetensors`` file → {name: numpy array}: an 8-byte
    little-endian header length, a JSON header of ``{name: {dtype, shape,
    data_offsets}}``, then one buffer.  F16 and BF16 tensors widen to
    float32."""
    with open(path, 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        header = json.loads(f.read(n).decode('utf-8'))
        buf = f.read()
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        lo, hi = info['data_offsets']
        tag = info['dtype']
        if tag == 'BF16':
            arr = torch.frombuffer(bytearray(buf[lo:hi]), dtype = torch.bfloat16).float().numpy()
        else:
            if tag not in _SAFETENSORS_DTYPES:
                raise ValueError('unsupported safetensors dtype {!r} for {!r}'.format(tag, name))
            arr = np.frombuffer(buf[lo:hi], dtype = _SAFETENSORS_DTYPES[tag])
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
        out[name] = np.array(arr.reshape(info['shape']))
    return out


def _load_state_dict(path_or_sd):
    """A state dict of numpy arrays from a dict, a ``.pt`` / ``.pth`` file
    (its top level, ``state_dict`` or ``model``) or a ``.safetensors``
    file."""
    if isinstance(path_or_sd, dict):
        if all(isinstance(v, np.ndarray) for v in path_or_sd.values()):
            return path_or_sd
        sd = path_or_sd
    elif isinstance(path_or_sd, (str, os.PathLike)) \
            and os.fspath(path_or_sd).endswith('.safetensors'):
        return load_safetensors(os.fspath(path_or_sd))
    else:
        ckpt = torch.load(path_or_sd, map_location = 'cpu', weights_only = False)
        sd = ckpt.get('state_dict', ckpt.get('model', ckpt)) \
            if isinstance(ckpt, dict) else ckpt.state_dict()
    return {k: (v.detach().cpu().numpy() if hasattr(v, 'detach') else np.asarray(v))
            for k, v in sd.items()}
