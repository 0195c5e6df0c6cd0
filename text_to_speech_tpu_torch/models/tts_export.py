"""Exporters to the published checkpoint layouts (the inverse of
``tts_checkpoints``): the JAX-layout parameter trees → the official torch
``state_dict`` naming and layout of each family, plus the reference's
Keras variable naming for Tacotron-2.

Counterpart of ``text_to_speech_tpu/models/tts_export.py``, numpy on the
same trees, exactly.  A port model reaches them through the weight
bridge's inverses (``weights.tacotron2_to_jax``, `waveglow_to_jax`,
`hifigan_to_jax`, `vits_to_jax`, `tree_to_jax` for Vocos), so that weights
trained in the port can go to users of the published implementations::

    sd = export_nvidia_tacotron2(* tacotron2_to_jax(params, state))

Layout inverses of ``tts_checkpoints``:
  - conv kernel (W, in, out)  → torch Conv1d weight (out, in, W)
  - dense kernel (in, out)    → torch Linear weight (out, in)
  - pointwise (in, out)       → torch Conv1d k=1 weight (out, in, 1)
  - conv-transpose (W, in, out), width-flipped → torch ConvTranspose1d
    (in, out, W)
  - LSTM kernel (in, 4H) → weight_ih (4H, in); the single bias becomes
    bias_ih (bias_hh zeros — torch keeps two, their SUM is the bias)
"""

import numpy as np

__all__ = [
    'export_nvidia_tacotron2', 'export_nvidia_waveglow', 'export_hifigan',
    'export_vits', 'export_vocos', 'export_keras_tacotron2',
]


def _np(x):
    return np.asarray(x)


def _conv_out(sd, prefix, p):
    sd[prefix + '.weight'] = _np(p['kernel']).transpose(2, 1, 0)
    if 'bias' in p:
        sd[prefix + '.bias'] = _np(p['bias'])


def _dense_out(sd, prefix, p):
    sd[prefix + '.weight'] = np.ascontiguousarray(_np(p['kernel']).T)
    if 'bias' in p:
        sd[prefix + '.bias'] = _np(p['bias'])


def _dense1x1_out(sd, prefix, p):
    sd[prefix + '.weight'] = np.ascontiguousarray(_np(p['kernel']).T)[..., None]
    if 'bias' in p:
        sd[prefix + '.bias'] = _np(p['bias'])


def _convt_out(sd, prefix, p):
    sd[prefix + '.weight'] = np.ascontiguousarray(
        _np(p['kernel'])[::-1].transpose(1, 2, 0))
    if 'bias' in p:
        sd[prefix + '.bias'] = _np(p['bias'])


def _lstm_out(sd, prefix, p, suffix = ''):
    sd['{}.weight_ih{}'.format(prefix, suffix)] = \
        np.ascontiguousarray(_np(p['kernel']).T)
    sd['{}.weight_hh{}'.format(prefix, suffix)] = \
        np.ascontiguousarray(_np(p['recurrent_kernel']).T)
    bias = _np(p['bias'])
    sd['{}.bias_ih{}'.format(prefix, suffix)] = bias
    sd['{}.bias_hh{}'.format(prefix, suffix)] = np.zeros_like(bias)


def _bn_out(sd, prefix, p, s):
    sd[prefix + '.weight'] = _np(p['gamma'])
    sd[prefix + '.bias'] = _np(p['beta'])
    sd[prefix + '.running_mean'] = _np(s['moving_mean'])
    sd[prefix + '.running_var'] = _np(s['moving_var'])


def _indexed(tree, stem):
    i = 0
    while '{}{}'.format(stem, i) in tree:
        yield i, tree['{}{}'.format(stem, i)]
        i += 1


def export_nvidia_tacotron2(params, state):
    """(params, state) trees of ``models.tacotron2_arch.Tacotron2`` → the
    NVIDIA/torch-hub ``state_dict`` layout (inverse of
    ``tts_checkpoints.convert_nvidia_tacotron2``)."""
    sd = {}
    enc, dec, post = params['encoder'], params['decoder'], params['postnet']

    sd['embedding.weight'] = _np(enc['embedding']['embeddings'])
    for i, p in _indexed(enc, 'conv_'):
        _conv_out(sd, 'encoder.convolutions.{}.0.conv'.format(i), p['conv'])
        _bn_out(sd, 'encoder.convolutions.{}.1'.format(i), p['bn'],
                state['encoder']['conv_{}'.format(i)]['bn'])
    _lstm_out(sd, 'encoder.lstm', enc['bilstm']['forward'], '_l0')
    _lstm_out(sd, 'encoder.lstm', enc['bilstm']['backward'], '_l0_reverse')

    for i, p in _indexed(dec['prenet'], 'layer_'):
        _dense_out(sd, 'decoder.prenet.layers.{}.linear_layer'.format(i), p)
    _lstm_out(sd, 'decoder.attention_rnn', dec['attention_rnn'])
    att = dec['attention']
    _dense_out(sd, 'decoder.attention_layer.query_layer.linear_layer',
               att['query'])
    _dense_out(sd, 'decoder.attention_layer.memory_layer.linear_layer',
               att['memory'])
    _dense_out(sd, 'decoder.attention_layer.v.linear_layer', att['value'])
    _conv_out(sd, 'decoder.attention_layer.location_layer.location_conv.conv',
              att['location_conv'])
    _dense_out(sd,
               'decoder.attention_layer.location_layer.location_dense'
               '.linear_layer', att['location_dense'])
    for i, p in _indexed(dec['decoder_rnn'], 'cell_'):
        # the NVIDIA layout has a single decoder LSTM
        _lstm_out(sd, 'decoder.decoder_rnn', p)
    _dense_out(sd, 'decoder.linear_projection.linear_layer',
               dec['linear_projection'])
    _dense_out(sd, 'decoder.gate_layer.linear_layer', dec['gate_layer'])

    for i, p in _indexed(post, 'conv_'):
        _conv_out(sd, 'postnet.convolutions.{}.0.conv'.format(i), p['conv'])
        _bn_out(sd, 'postnet.convolutions.{}.1'.format(i), p['bn'],
                state['postnet']['conv_{}'.format(i)]['bn'])
    return sd


def export_nvidia_waveglow(params):
    """``models.waveglow_arch.WaveGlow`` params (``wn_fused`` layout — the
    NVIDIA blocks use one fused cond conv) → the NVIDIA ``state_dict``
    (plain weights; the importer's weight-norm fold passes them through)."""
    sd = {}
    _convt_out(sd, 'upsample', params['upsample'])
    for k, flow in _indexed(params, 'flow_'):
        block = flow['block']
        if 'cond_layer' not in block:
            raise ValueError(
                'export_nvidia_waveglow needs the wn_fused layout '
                '(one fused cond conv per block); flow_%d has per-layer '
                'cond convs' % k)
        sd['convinv.{}.conv.weight'.format(k)] = np.ascontiguousarray(
            _np(flow['convinv']['kernel']).T)[..., None]
        _conv_out(sd, 'WN.{}.start'.format(k), block['start'])
        _conv_out(sd, 'WN.{}.end'.format(k), block['end'])
        _conv_out(sd, 'WN.{}.cond_layer'.format(k), block['cond_layer'])
        for i, p in _indexed(block, 'in_conv_'):
            _conv_out(sd, 'WN.{}.in_layers.{}'.format(k, i), p)
        for i, p in _indexed(block, 'res_skip_conv_'):
            _conv_out(sd, 'WN.{}.res_skip_layers.{}'.format(k, i), p)
    return sd


def export_hifigan(params, *, prefix = ''):
    """``models.hifigan_arch.HiFiGAN`` generator params → the official
    release layout (`conv_pre`, `ups.N`, `resblocks.*`, `conv_post`).
    Handles both resblock variants (v1/v2 paired convs1/convs2; v3 single
    convs list)."""
    sd = {}
    _conv_out(sd, prefix + 'conv_pre', params['conv_pre'])
    _conv_out(sd, prefix + 'conv_post', params['conv_post'])
    stages = [p for _, p in _indexed(params, 'up')]
    if not stages:
        raise ValueError('no up<i> stages in the generator tree')
    num_kernels = sum(1 for k in stages[0] if k.startswith('res'))
    for i, stage in enumerate(stages):
        _convt_out(sd, '{}ups.{}'.format(prefix, i), stage['up'])
        for j in range(num_kernels):
            res = stage['res{}'.format(j)]
            r = i * num_kernels + j
            for d, unit in _indexed(res, 'd'):
                if 'conv2' in unit:                     # ResBlock1 (v1/v2)
                    _conv_out(sd, '{}resblocks.{}.convs1.{}'.format(
                        prefix, r, d), unit['conv1'])
                    _conv_out(sd, '{}resblocks.{}.convs2.{}'.format(
                        prefix, r, d), unit['conv2'])
                else:                                   # ResBlock2 (v3)
                    _conv_out(sd, '{}resblocks.{}.convs.{}'.format(
                        prefix, r, d), unit['conv1'])
    return sd


def _wn_out(sd, prefix, p):
    for name, leaf in p.items():
        if name == 'cond':
            _dense1x1_out(sd, prefix + '.cond_layer', leaf)
        elif name.startswith('in_conv_'):
            _conv_out(sd, '{}.in_layers.{}'.format(prefix, name[8:]), leaf)
        elif name.startswith('res_skip_conv_'):
            _conv_out(sd, '{}.res_skip_layers.{}'.format(
                prefix, name[len('res_skip_conv_'):]), leaf)
        else:
            raise KeyError('unexpected wn entry: ' + name)


def _norm_out(sd, prefix, p):
    sd[prefix + '.gamma'] = _np(p['gamma']).reshape(-1, 1)
    sd[prefix + '.beta'] = _np(p['beta']).reshape(-1, 1)


def _dds_out(sd, prefix, p):
    for i, lp in _indexed(p, 'layer_'):
        _conv_out(sd, '{}.convs_sep.{}'.format(prefix, i), lp['depthwise'])
        sd['{}.convs_1x1.{}.weight'.format(prefix, i)] = \
            np.ascontiguousarray(_np(lp['pointwise']['kernel'][0]).T)[..., None]
        if 'bias' in lp['pointwise']:
            sd['{}.convs_1x1.{}.bias'.format(prefix, i)] = \
                _np(lp['pointwise']['bias'])
        _norm_out(sd, '{}.norms_1.{}'.format(prefix, i), lp['norm1'])
        _norm_out(sd, '{}.norms_2.{}'.format(prefix, i), lp['norm2'])


def _flow_stack_out(sd, prefix, p):
    sd[prefix + '.0.m'] = _np(p['affine']['m']).reshape(-1, 1)
    sd[prefix + '.0.logs'] = _np(p['affine']['logs']).reshape(-1, 1)
    for i, cf in _indexed(p, 'conv_flow_'):
        t = '{}.{}'.format(prefix, 1 + 2 * i)           # ConvFlows at odd idx
        _conv_out(sd, t + '.pre', cf['pre'])
        _dds_out(sd, t + '.convs', cf['dds'])
        _conv_out(sd, t + '.proj', cf['proj'])


def export_vits(params):
    """``models.vits_arch.VITS`` params → the official ``SynthesizerTrn``
    ``state_dict`` layout (inverse of ``tts_checkpoints.convert_vits``)."""
    sd = {}
    sd['enc_p.emb.weight'] = _np(params['embedding']['embeddings'])
    for i, blk in _indexed(params['text_encoder'], 'layer_'):
        a = 'enc_p.encoder.attn_layers.{}'.format(i)
        _dense1x1_out(sd, a + '.conv_q', blk['attention']['query'])
        _dense1x1_out(sd, a + '.conv_k', blk['attention']['key'])
        _dense1x1_out(sd, a + '.conv_v', blk['attention']['value'])
        _dense1x1_out(sd, a + '.conv_o', blk['attention']['output'])
        if 'rel_k' in blk:
            sd[a + '.emb_rel_k'] = _np(blk['rel_k'])[None]
            sd[a + '.emb_rel_v'] = _np(blk['rel_v'])[None]
        _norm_out(sd, 'enc_p.encoder.norm_layers_1.{}'.format(i),
                  blk['attention_norm'])
        _conv_out(sd, 'enc_p.encoder.ffn_layers.{}.conv_1'.format(i),
                  blk['conv1'])
        _conv_out(sd, 'enc_p.encoder.ffn_layers.{}.conv_2'.format(i),
                  blk['conv2'])
        _norm_out(sd, 'enc_p.encoder.norm_layers_2.{}'.format(i),
                  blk['ffn_norm'])
    _conv_out(sd, 'enc_p.proj', params['text_proj'])

    _conv_out(sd, 'enc_q.pre', params['posterior']['pre'])
    _wn_out(sd, 'enc_q.enc', params['posterior']['wn'])
    _conv_out(sd, 'enc_q.proj', params['posterior']['proj'])

    for k, fp in _indexed(params, 'flow_'):
        t = 'flow.flows.{}'.format(2 * k)               # flips at odd idx
        _conv_out(sd, t + '.pre', fp['pre'])
        _wn_out(sd, t + '.enc', fp['wn'])
        _conv_out(sd, t + '.post', fp['post'])

    sd.update(export_hifigan(params['generator'], prefix = 'dec.'))

    dp = params['duration_predictor']
    if 'flows' in dp:                                   # stochastic
        _conv_out(sd, 'dp.pre', dp['pre'])
        _dds_out(sd, 'dp.convs', dp['dds'])
        _conv_out(sd, 'dp.proj', dp['proj'])
        _flow_stack_out(sd, 'dp.flows', dp['flows'])
        _conv_out(sd, 'dp.post_pre', dp['post_pre'])
        _dds_out(sd, 'dp.post_convs', dp['post_dds'])
        _conv_out(sd, 'dp.post_proj', dp['post_proj'])
        _flow_stack_out(sd, 'dp.post_flows', dp['post_flows'])
        if 'cond' in dp:
            _dense1x1_out(sd, 'dp.cond', dp['cond'])
    else:
        _conv_out(sd, 'dp.conv_1', dp['conv1'])
        _norm_out(sd, 'dp.norm_1', dp['norm1'])
        _conv_out(sd, 'dp.conv_2', dp['conv2'])
        _norm_out(sd, 'dp.norm_2', dp['norm2'])
        _dense1x1_out(sd, 'dp.proj', dp['proj'])
        if 'duration_cond' in params:
            _dense1x1_out(sd, 'dp.cond', params['duration_cond'])

    if 'speaker_embedding' in params:
        sd['emb_g.weight'] = _np(params['speaker_embedding']['embeddings'])
    if 'generator_cond' in params:
        _dense1x1_out(sd, 'dec.cond', params['generator_cond'])
    return sd


def export_vocos(params):
    """``models.vocos_arch.Vocos`` params → the official
    ``backbone.convnext`` ``state_dict`` layout."""
    sd = {}

    def norm(prefix, p):
        sd[prefix + '.weight'] = _np(p['gamma']).reshape(-1)
        sd[prefix + '.bias'] = _np(p['beta']).reshape(-1)

    _conv_out(sd, 'backbone.embed', params['embed'])
    norm('backbone.norm', params['norm_pre'])
    norm('backbone.final_layer_norm', params['norm_post'])
    _dense_out(sd, 'head.out', params['head'])
    for i, blk in _indexed(params, 'block_'):
        p = 'backbone.convnext.{}'.format(i)
        _conv_out(sd, p + '.dwconv', blk['depthwise'])
        norm(p + '.norm', blk['norm'])
        _dense_out(sd, p + '.pwconv1', blk['pw1'])
        _dense_out(sd, p + '.pwconv2', blk['pw2'])
        sd[p + '.gamma'] = _np(blk['gamma']).reshape(-1)
    return sd


# -- Keras / reference naming ---------------------------------------------------

#: canonical framework path fragments → the reference's Keras variable paths
#: (the reference architecture's layer names in ``tacotron2_arch.py``; conv
#: stacks from simple_models.simple_cnn are 1-indexed).  Inverse of
#: ``weights_converter.KERAS_TACOTRON2_PATTERNS``.
def _keras_name(path):
    import re
    m = re.match(r'^encoder/embedding/embeddings$', path)
    if m: return 'tacotron2/encoder_embeddings/embeddings'
    m = re.match(r'^encoder/speaker_projection/(kernel|bias)$', path)
    if m: return 'encoder/embedding_projection/' + m.group(1)
    m = re.match(r'^encoder/conv_(\d+)/conv/(kernel|bias)$', path)
    if m: return 'encoder/conv_{}/{}'.format(int(m.group(1)) + 1, m.group(2))
    m = re.match(r'^encoder/conv_(\d+)/bn/(gamma|beta|moving_mean|moving_var)$',
                 path)
    if m:
        stat = 'moving_variance' if m.group(2) == 'moving_var' else m.group(2)
        return 'encoder/norm_{}/{}'.format(int(m.group(1)) + 1, stat)
    m = re.match(r'^encoder/bilstm/(forward|backward)/'
                 r'(kernel|recurrent_kernel|bias)$', path)
    if m: return 'encoder/bidirectional/{}_lstm/lstm_cell/{}'.format(
        m.group(1), m.group(2))
    m = re.match(r'^decoder/attention_rnn/(kernel|recurrent_kernel|bias)$', path)
    if m: return 'decoder/attention_rnn/lstm_cell/' + m.group(1)
    m = re.match(r'^decoder/decoder_rnn/cell_(\d+)/'
                 r'(kernel|recurrent_kernel|bias)$', path)
    if m: return ('decoder/decoder_rnn/stacked_rnn_cells/cell_{}/lstm_cell/{}'
                  .format(m.group(1), m.group(2)))
    m = re.match(r'^decoder/attention/(query|memory|value)/kernel$', path)
    if m: return 'decoder/lsa/{}_layer/kernel'.format(m.group(1))
    m = re.match(r'^decoder/attention/location_(conv|dense)/kernel$', path)
    if m: return 'decoder/lsa/location_layer/location_{}/kernel'.format(
        m.group(1))
    m = re.match(r'^decoder/gate_layer/(kernel|bias)$', path)
    if m: return 'decoder/gate_output/' + m.group(1)
    m = re.match(r'^postnet/conv_(\d+)/conv/(kernel|bias)$', path)
    if m: return 'postnet/conv_{}/{}'.format(int(m.group(1)) + 1, m.group(2))
    m = re.match(r'^postnet/conv_(\d+)/bn/(gamma|beta|moving_mean|moving_var)$',
                 path)
    if m:
        stat = 'moving_variance' if m.group(2) == 'moving_var' else m.group(2)
        return 'postnet/norm_{}/{}'.format(int(m.group(1)) + 1, stat)
    # prenet / linear_projection and anything else: the canonical path is
    # itself a valid (pass-through) name for `apply_keras_patterns`
    return path


def export_keras_tacotron2(params, state):
    """(params, state) trees → a flat ``{keras_variable_path: array}`` dict
    using the reference architecture's variable names (what its
    ``ckpt.weights.h5`` checkpoints contain) — the round-trip partner of
    ``weights_converter.convert_keras_variables``.  Keras layouts already
    match ``nn``'s, so this is purely a renaming."""
    from ..weights import flatten_tree

    flat = dict(flatten_tree(params))
    flat.update(flatten_tree(state))
    return {_keras_name(path): _np(value) for path, value in flat.items()}
