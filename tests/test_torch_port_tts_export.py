"""The port's exporters to the published checkpoint layouts
(`models/tts_export.py`) and its model description (`models/describe.py`)
against the JAX package's.

Each exporter runs on the same JAX-layout numpy tree in both packages and
gives the same state dict, exactly (names, shapes, values); the port's
importers (`models/tts_checkpoints.py`, `models/weights_converter.py`) read
it back to the tree, exactly; and a port model's weights reach the
exporters through the weight bridge's inverses (`weights.*_to_jax`),
`tacotron2_to_jax` among them, with the same result.  `describe_model`,
`summarize_tree` and `count_params` give the JAX package's strings and
counts for the same model.
"""

import types

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models import describe as jax_describe
from text_to_speech_tpu.models import tts_export as jax_export
from text_to_speech_tpu_torch import init, weights
from text_to_speech_tpu_torch.models import describe, tts_checkpoints, tts_export
from text_to_speech_tpu_torch.models.hifigan_arch import HiFiGAN
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
from text_to_speech_tpu_torch.models.vits_arch import VITS
from text_to_speech_tpu_torch.models.vocos_arch import Vocos
from text_to_speech_tpu_torch.models.weights_converter import convert_keras_variables

TACOTRON = dict(vocab_size = 40, encoder_embedding_dim = 16, encoder_n_conv = 3,
                encoder_kernel_size = 3, prenet_sizes = (8, 8), lsa_attention_dim = 8,
                lsa_attention_filters = 4, lsa_attention_kernel_size = 7, attention_rnn_dim = 12,
                decoder_rnn_dim = 12, postnet_n_conv = 5, postnet_filters = 8,
                postnet_kernel_size = 3)
HIFIGAN = dict(upsample_initial_channel = 16, upsample_rates = (2, 2),
               upsample_kernel_sizes = (4, 4), resblock_kernel_sizes = (3, 5),
               resblock_dilation_sizes = ((1, 3), (1, 3)))
VITS_CONFIG = dict(vocab_size = 40, spec_channels = 33, inter_channels = 8, hidden_channels = 16,
                   filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
                   flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
                   upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
                   upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
                   resblock_dilation_sizes = ((1, 2),), max_frames = 64, use_sdp = True,
                   sdp_filter_channels = 16, sdp_n_flows = 2, sdp_dds_layers = 2,
                   sdp_n_bins = 4, n_speakers = 3, gin_channels = 8)


def _perturb(tree, rng):
    """Every leaf redrawn (the zero-initialised ones too), so that a
    transposed or swapped leaf cannot pass."""
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in tree.items()}


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        got_value = np.asarray(got[key])
        assert got_value.shape == np.shape(value) and got_value.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got_value, np.asarray(value), err_msg = key)


def _assert_same_tree(got, want):
    _assert_same_dict(weights.flatten_tree(got), weights.flatten_tree(want))


def _tacotron2():
    arch = Tacotron2(** TACOTRON)
    params, state = init.init_tacotron2(arch.hp, seed = 0)
    rng = np.random.default_rng(1)
    return arch, _perturb(params, rng), _perturb(state, rng)


def _waveglow():
    sd = init.nvidia_waveglow_state_dict(2, n_flows = 6, n_group = 8, n_early_every = 2,
                                         n_early_size = 2, wn_layers = 2, wn_channels = 8,
                                         n_mel = 8, upsample_width = 16, upsample_stride = 8)
    sd = tts_checkpoints.remove_torch_weight_norm(sd)
    return _perturb(tts_checkpoints.convert_nvidia_waveglow(sd), np.random.default_rng(2))


FAMILIES = {
    'nvidia_tacotron2': lambda: _tacotron2()[1:],
    'nvidia_waveglow': lambda: (_waveglow(),),
    'hifigan': lambda: (init.init_hifigan(HiFiGAN(** HIFIGAN).hp, seed = 3),),
    'hifigan_v3': lambda: (init.init_hifigan(HiFiGAN(** dict(
        HIFIGAN, resblock_kernel_sizes = (3,), resblock_dilation_sizes = ((1, 3),),
        resblock_version = 2)).hp, seed = 4),),
    'vits': lambda: (_perturb(init.init_vits(VITS(** VITS_CONFIG).hp, seed = 5),
                              np.random.default_rng(5)),),
    'vocos': lambda: (init.init_vocos(Vocos(dim = 16, n_layers = 2, intermediate_dim = 32,
                                            n_fft = 64, hop_length = 16,
                                            win_length = 64).hp, seed = 6),),
    'keras_tacotron2': lambda: _tacotron2()[1:],
}

EXPORTER = {'hifigan_v3': 'hifigan'}

IMPORTER = {
    'nvidia_tacotron2': tts_checkpoints.convert_nvidia_tacotron2,
    'nvidia_waveglow': tts_checkpoints.convert_nvidia_waveglow,
    'hifigan': tts_checkpoints.convert_hifigan,
    'hifigan_v3': tts_checkpoints.convert_hifigan,
    'vits': tts_checkpoints.convert_vits,
    'vocos': tts_checkpoints.convert_vocos,
    'keras_tacotron2': convert_keras_variables,
}

# a port model's weights (the layouts `nn.layers` takes) and back to the JAX layout
BRIDGE = {
    'nvidia_tacotron2': lambda p, s: weights.tacotron2_to_jax(* weights.tacotron2_from_jax(p, s)),
    'keras_tacotron2': lambda p, s: weights.tacotron2_to_jax(* weights.tacotron2_from_jax(p, s)),
    'nvidia_waveglow': lambda p: (weights.waveglow_to_jax(weights.waveglow_from_jax(p)),),
    'hifigan': lambda p: (weights.hifigan_to_jax(weights.hifigan_from_jax(p)),),
    'hifigan_v3': lambda p: (weights.hifigan_to_jax(weights.hifigan_from_jax(p)),),
    'vits': lambda p: (weights.vits_to_jax(weights.vits_from_jax(p)),),
    'vocos': lambda p: (weights.hifigan_to_jax(weights.hifigan_from_jax(p)),),
}


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_exporter_matches_jax_and_round_trips(family):
    trees = FAMILIES[family]()
    name = 'export_' + EXPORTER.get(family, family)
    sd = getattr(tts_export, name)(* trees)
    _assert_same_dict(sd, getattr(jax_export, name)(* trees))
    # the port's importer reads it back to the tree
    _assert_same_tree(* _pairs(IMPORTER[family](sd), trees))
    # from a port model's weights through the bridge's inverse
    _assert_same_dict(getattr(tts_export, name)(* BRIDGE[family](* trees)), sd)


def _pairs(back, trees):
    """(imported, original) as two trees of the same structure."""
    back = back if isinstance(back, tuple) else (back,)
    return dict(enumerate(back)), dict(enumerate(trees[:len(back)]))


def test_describe_matches_jax():
    arch, params, state = _tacotron2()
    port_params, _ = weights.tacotron2_from_jax(params, state)
    jax_model = types.SimpleNamespace(params = params, name = 'tiny', arch = arch, epochs = 3)
    port_model = types.SimpleNamespace(params = port_params, name = 'tiny', arch = arch,
                                       epochs = 3)
    assert describe.describe_model(port_model) == jax_describe.describe_model(jax_model)
    for depth in (1, 2):        # deeper, the two layouts' leaf names differ
        assert describe.describe_model(port_params, max_depth = depth) \
            == jax_describe.describe_model(params, max_depth = depth)
        assert describe.summarize_tree(port_params, depth) \
            == jax_describe.summarize_tree(params, depth)
    assert describe.count_params(port_params) == jax_describe.count_params(params) > 0
    strides = [2, (4,), [2, 1]]
    assert describe.infer_downsampling_factor(strides) \
        == jax_describe.infer_downsampling_factor(strides) == 16
    assert describe.infer_upsampling_factor((8, 8, 2, 2)) == 256
    assert isinstance(next(iter(weights.flatten_tree(port_params).values())), torch.Tensor)
