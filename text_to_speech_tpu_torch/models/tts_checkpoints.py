"""Importers for NVIDIA's published Tacotron-2 and WaveGlow checkpoints.

The port's copy of the NVIDIA part of ``text_to_speech_tpu/models/tts_checkpoints.py``.
The converters rebuild the JAX package's numpy parameter trees from the
PyTorch ``state_dict`` layouts; `weights.tacotron2_from_jax` /
`weights.waveglow_from_jax` then turn those trees into the port's, so that
both packages share one definition of every layout:

  - Linear (out, in) → kernel (in, out): ``.T``
  - Conv1d (out, in, k) → kernel (k, in, out): ``transpose(2, 1, 0)``
  - ConvTranspose1d (in, out, k) → kernel (k, in, out) with the width
    flipped: ``transpose(2, 0, 1)[::-1]``
  - LSTM / LSTMCell ``weight_ih`` (4H, in) → kernel (in, 4H): ``.T``; the two
    biases sum into one; the gate order i, f, g, o is kept.

`_load_state_dict` reads a dict, a ``.pt`` / ``.pth`` file holding a state
dict (at its top level, under ``state_dict`` or under ``model``), or a
``.safetensors`` file (`load_safetensors`).  The HiFi-GAN, VITS and Vocos
converters are not ported.
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
