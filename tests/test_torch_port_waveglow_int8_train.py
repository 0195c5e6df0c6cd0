"""The XLA-level int8 WaveGlow path (`quantize_params`, `_conv_int8`, the
per-layer chain on int8 convs): the port against the JAX package.

A tiny WaveGlow (4 flows, 2 WN layers of 16 channels, 8 mels) in both WN
conditioning layouts (one cond conv per layer, and NVIDIA's fused
``cond_layer``), random weights from a numpy seed handed to both packages:

  - `quantize_params`: every int8 weight, scale and bias equal;
  - `_conv_int8` on one activation, dilations 1 and 4: the quantized
    activation and the int32 products (against ``lax.conv_general_dilated``
    with int32 accumulation) equal, and the scaled float32 result equal;
  - `infer(quantize_params(params), mel, z=...)` at a fixed z: within 1e-5
    of the JAX waveform's scale.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp
from jax import lax

from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow

from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow, int8_conv1d
from text_to_speech_tpu_torch.weights import waveglow_from_jax

CONFIG = dict(n_mel_channels = 8, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 2, wn_channels = 16, upsample_width = 1024,
              upsample_stride = 256)
FRAMES = 6


def _fuse_cond(params, layers):
    """The per-layer cond convs of each block as one ``cond_layer`` (JAX
    layout (1, S, L 2C)), as NVIDIA's checkpoints hold them."""
    out = {}
    for name, value in params.items():
        if not name.startswith('flow_'):
            out[name] = value
            continue
        block = dict(value['block'])
        convs = [block.pop('cond_conv_{}'.format(i)) for i in range(layers)]
        block['cond_layer'] = {'kernel': np.concatenate([c['kernel'] for c in convs], axis = -1),
                               'bias': np.concatenate([c['bias'] for c in convs])}
        out[name] = {'convinv': value['convinv'], 'block': block}
    return out


@pytest.fixture(scope = 'module', params = ['per_layer', 'fused_cond'])
def setup(request):
    fused = request.param == 'fused_cond'
    port = WaveGlow(** CONFIG, wn_fused = fused)
    params = init_waveglow(port.hp, port.flow_channels, seed = 0, end_scale = 0.3)
    if fused:
        params = _fuse_cond(params, CONFIG['wn_layers'])
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((2, FRAMES, 8)) - 4.).astype(np.float32)
    z = rng.standard_normal((2, FRAMES * 256 // 8, 8)).astype(np.float32)
    jarch = JaxWaveGlow(** CONFIG, wn_fused = fused)
    return port, jarch, params, mel, z


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_quantize_params_equal_jax(setup):
    port, jarch, params, _, _ = setup
    ref = jarch.quantize_params(params)
    out = port.quantize_params(waveglow_from_jax(params))
    for flow in (k for k in ref if k.startswith('flow_')):
        for key, conv in ref[flow]['block'].items():
            if 'kernel_q' not in conv:
                continue
            q = out[flow]['block'][key]
            assert q['weight_q'].dtype == torch.int8
            np.testing.assert_array_equal(q['weight_q'].numpy().transpose(2, 1, 0),
                                          conv['kernel_q'])
            np.testing.assert_array_equal(q['scale'].numpy(), conv['scale'])
            np.testing.assert_array_equal(q['bias'].numpy(), conv['bias'])


@pytest.mark.parametrize('dilation', [1, 4])
def test_conv_int8_equal_jax(setup, dilation):
    port, jarch, params, _, _ = setup
    q_ref = jarch.quantize_params(params)['flow_1']['block']['in_conv_1']
    q = port.quantize_params(waveglow_from_jax(params))['flow_1']['block']['in_conv_1']
    x = (2. * np.random.default_rng(2).standard_normal((2, 20, 16))).astype(np.float32)
    a_scale = max(np.abs(x).max() / np.float32(127.), np.float32(1e-8))
    x_q = np.clip(np.round(x / a_scale), -127, 127).astype(np.int8)
    ref_int = lax.conv_general_dilated(jnp.asarray(x_q), jnp.asarray(q_ref['kernel_q']), (1,),
                                       'SAME', rhs_dilation = (dilation,),
                                       dimension_numbers = ('NWC', 'WIO', 'NWC'),
                                       preferred_element_type = jnp.int32)
    out_int = int8_conv1d(torch.from_numpy(x_q), q['weight_q'], dilation = dilation)
    assert out_int.dtype == torch.int32
    np.testing.assert_array_equal(out_int.numpy(), np.asarray(ref_int))
    ref = JaxWaveGlow._conv_int8(_jax(q_ref), jnp.asarray(x), dilation = dilation)
    out = WaveGlow._conv_int8(q, torch.from_numpy(x), dilation = dilation)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_int8_infer_matches_jax(setup):
    port, jarch, params, mel, z = setup
    ref = np.asarray(jax.jit(lambda p, m, zz: jarch.infer(p, m, z = zz))(
        _jax(jarch.quantize_params(params)), jnp.asarray(mel), jnp.asarray(z)))
    with torch.no_grad():
        out = port.infer(port.quantize_params(waveglow_from_jax(params)), torch.from_numpy(mel),
                         z = torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (2, FRAMES * 256)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # the int8 chain is not the float32 one
    with torch.no_grad():
        f32 = port.infer(waveglow_from_jax(params), torch.from_numpy(mel),
                         z = torch.from_numpy(z)).numpy()
    assert np.abs(f32 - out).max() > 1e-5 * np.abs(ref).max()
