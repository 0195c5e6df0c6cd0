"""The HiFi-GAN, Vocos and VITS importers and saved models: the port against
the JAX package, on the CPU.

  - `convert_hifigan` (ResBlock1 and ResBlock2 layouts), `convert_vocos`
    and `convert_vits` (the stochastic duration predictor with a speaker
    table, and the conv one), and the three ``*_config_from_state_dict``,
    equal the JAX functions to the bit on state dicts exported from seeded
    JAX params in the published layouts (the export helpers of
    ``tests/test_vits.py`` and ``tests/test_vocos.py``, copied), and give
    back the params they were exported from;
  - `init.init_hifigan` / `init_vocos` / `init_vits` make the JAX
    ``init`` trees (every key and shape);
  - `from_torch_pretrained` of `HiFiGAN`, `Vocos` and `VITS` on the seeded
    published-layout dicts of `init` (weight norm folded), then `save`,
    then `get_pretrained` by name under a temporary root: the same class
    and hparams, the same output to the bit; the JAX package loads the
    HiFi-GAN directory by name and its output agrees within 1e-5 of scale
    (the Vocos task saves through the same code; the VITS family's
    directory is loaded by the JAX package below);
  - `SV2TTSVITS.create`, saved and loaded by name in both packages, cloned
    from an external embedding at ``noise_scale = noise_scale_w = 0``.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
from text_to_speech_tpu.models import get_pretrained as jax_get_pretrained, saving
from text_to_speech_tpu.models import tts_checkpoints as jax_checkpoints
from text_to_speech_tpu.models.hifigan_arch import HiFiGAN as JaxHiFiGAN
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.vits_arch import VITS as JaxVITS
from text_to_speech_tpu.models.vocos_arch import Vocos as JaxVocos
from text_to_speech_tpu_torch import init
from text_to_speech_tpu_torch.models import get_pretrained, tts_checkpoints
from text_to_speech_tpu_torch.models.hifigan_arch import HiFiGAN as HiFiGANArch
from text_to_speech_tpu_torch.models.tts import HiFiGAN, SV2TTSVITS, VITS, Vocos
from text_to_speech_tpu_torch.models.vits_arch import VITS as VITSArch
from text_to_speech_tpu_torch.models.vocos_arch import Vocos as VocosArch

HIFIGAN = dict(n_mel_channels = 8, upsample_rates = (4, 2, 2), upsample_kernel_sizes = (8, 4, 4),
               upsample_initial_channel = 32, resblock_kernel_sizes = (3, 7),
               resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5)))
HIFIGAN_V3 = dict(HIFIGAN, upsample_initial_channel = 16, resblock_kernel_sizes = (3, 5, 7),
                  resblock_dilation_sizes = ((1, 2), (2, 6), (3, 12)), resblock_version = 2)
VOCOS = dict(n_mel_channels = 9, dim = 16, intermediate_dim = 32, n_layers = 2, kernel_size = 3,
             n_fft = 16, hop_length = 4, win_length = 16)
VITS_BASE = dict(vocab_size = 40, spec_channels = 33, inter_channels = 8, hidden_channels = 16,
                 filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
                 flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
                 upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
                 upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
                 resblock_dilation_sizes = ((1, 3, 5),), max_frames = 64)
VITS_SDP = dict(VITS_BASE, use_sdp = True, sdp_filter_channels = 16, sdp_n_flows = 2,
                sdp_dds_layers = 2, sdp_n_bins = 4, n_speakers = 3, gin_channels = 8)


def _assert_trees_equal(got, want, path = ''):
    """Keys, types, dtypes, shapes and values: to the bit."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], path + '/' + str(k))
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg = path)


# -- the export helpers (the published layouts) ---------------------------------------

def _conv(sd, prefix, p):                       # (W, in, out) → (out, in, W)
    sd[prefix + '.weight'] = np.asarray(p['kernel']).transpose(2, 1, 0)
    if 'bias' in p: sd[prefix + '.bias'] = np.asarray(p['bias'])


def _dense(sd, prefix, p):                      # (in, out) → (out, in)
    sd[prefix + '.weight'] = np.asarray(p['kernel']).T
    if 'bias' in p: sd[prefix + '.bias'] = np.asarray(p['bias'])


def _dense1x1(sd, prefix, p):                   # (in, out) → (out, in, 1)
    sd[prefix + '.weight'] = np.asarray(p['kernel']).T[..., None]
    if 'bias' in p: sd[prefix + '.bias'] = np.asarray(p['bias'])


def _norm_gb(sd, prefix, p):
    sd[prefix + '.gamma'] = np.asarray(p['gamma'])
    sd[prefix + '.beta'] = np.asarray(p['beta'])


def _export_hifigan(sd, params, n_kernels, prefix = ''):
    _conv(sd, prefix + 'conv_pre', params['conv_pre'])
    _conv(sd, prefix + 'conv_post', params['conv_post'])
    i = 0
    while 'up{}'.format(i) in params:
        stage = params['up{}'.format(i)]
        up = stage['up']                        # (W, in, out), flipped ← (in, out, W)
        sd['{}ups.{}.weight'.format(prefix, i)] = np.asarray(up['kernel'])[::-1].transpose(1, 2, 0)
        sd['{}ups.{}.bias'.format(prefix, i)] = np.asarray(up['bias'])
        for j in range(n_kernels):
            r = i * n_kernels + j
            res = stage['res{}'.format(j)]
            for di in range(len(res)):
                unit = res['d{}'.format(di)]
                if 'conv2' in unit:
                    _conv(sd, '{}resblocks.{}.convs1.{}'.format(prefix, r, di), unit['conv1'])
                    _conv(sd, '{}resblocks.{}.convs2.{}'.format(prefix, r, di), unit['conv2'])
                else:
                    _conv(sd, '{}resblocks.{}.convs.{}'.format(prefix, r, di), unit['conv1'])
        i += 1
    return sd


def _export_vocos(params):
    sd = {}

    def norm(prefix, p):
        sd[prefix + '.weight'] = np.asarray(p['gamma'])
        sd[prefix + '.bias'] = np.asarray(p['beta'])

    _conv(sd, 'backbone.embed', params['embed'])
    norm('backbone.norm', params['norm_pre'])
    norm('backbone.final_layer_norm', params['norm_post'])
    _dense(sd, 'head.out', params['head'])
    i = 0
    while 'block_{}'.format(i) in params:
        b, p = params['block_{}'.format(i)], 'backbone.convnext.{}'.format(i)
        _conv(sd, p + '.dwconv', b['depthwise'])
        norm(p + '.norm', b['norm'])
        _dense(sd, p + '.pwconv1', b['pw1'])
        _dense(sd, p + '.pwconv2', b['pw2'])
        sd[p + '.gamma'] = np.asarray(b['gamma'])
        i += 1
    return sd


def _export_vits(arch, params):
    sd = {}

    def wn(prefix, p):
        for name, leaf in p.items():
            if name == 'cond':
                _dense1x1(sd, prefix + '.cond_layer', leaf)
            elif name.startswith('in_conv_'):
                _conv(sd, '{}.in_layers.{}'.format(prefix, name[8:]), leaf)
            else:
                _conv(sd, '{}.res_skip_layers.{}'.format(prefix, name[len('res_skip_conv_'):]),
                      leaf)

    def dds(prefix, p):
        for i in range(len(p)):
            lp = p['layer_{}'.format(i)]
            _conv(sd, '{}.convs_sep.{}'.format(prefix, i), lp['depthwise'])
            sd['{}.convs_1x1.{}.weight'.format(prefix, i)] = \
                np.asarray(lp['pointwise']['kernel'][0]).T[..., None]
            sd['{}.convs_1x1.{}.bias'.format(prefix, i)] = np.asarray(lp['pointwise']['bias'])
            _norm_gb(sd, '{}.norms_1.{}'.format(prefix, i), lp['norm1'])
            _norm_gb(sd, '{}.norms_2.{}'.format(prefix, i), lp['norm2'])

    def flow_stack(prefix, p):
        sd[prefix + '.0.m'] = np.asarray(p['affine']['m'])[:, None]
        sd[prefix + '.0.logs'] = np.asarray(p['affine']['logs'])[:, None]
        i = 0
        while 'conv_flow_{}'.format(i) in p:
            cf, t = p['conv_flow_{}'.format(i)], '{}.{}'.format(prefix, 1 + 2 * i)
            _conv(sd, t + '.pre', cf['pre'])
            dds(t + '.convs', cf['dds'])
            _conv(sd, t + '.proj', cf['proj'])
            i += 1

    sd['enc_p.emb.weight'] = np.asarray(params['embedding']['embeddings'])
    for i, blk in params['text_encoder'].items():
        n = i[len('layer_'):]
        a = 'enc_p.encoder.attn_layers.' + n
        for name, key in (('conv_q', 'query'), ('conv_k', 'key'), ('conv_v', 'value'),
                          ('conv_o', 'output')):
            _dense1x1(sd, '{}.{}'.format(a, name), blk['attention'][key])
        sd[a + '.emb_rel_k'] = np.asarray(blk['rel_k'])[None]
        sd[a + '.emb_rel_v'] = np.asarray(blk['rel_v'])[None]
        _norm_gb(sd, 'enc_p.encoder.norm_layers_1.' + n, blk['attention_norm'])
        _conv(sd, 'enc_p.encoder.ffn_layers.{}.conv_1'.format(n), blk['conv1'])
        _conv(sd, 'enc_p.encoder.ffn_layers.{}.conv_2'.format(n), blk['conv2'])
        _norm_gb(sd, 'enc_p.encoder.norm_layers_2.' + n, blk['ffn_norm'])
    _conv(sd, 'enc_p.proj', params['text_proj'])
    _conv(sd, 'enc_q.pre', params['posterior']['pre'])
    wn('enc_q.enc', params['posterior']['wn'])
    _conv(sd, 'enc_q.proj', params['posterior']['proj'])
    k = 0
    while 'flow_{}'.format(k) in params:
        fp, t = params['flow_{}'.format(k)], 'flow.flows.{}'.format(2 * k)
        _conv(sd, t + '.pre', fp['pre'])
        wn(t + '.enc', fp['wn'])
        _conv(sd, t + '.post', fp['post'])
        k += 1
    _export_hifigan(sd, params['generator'], len(arch.hp.resblock_kernel_sizes), 'dec.')
    dp = params['duration_predictor']
    if 'flows' in dp:
        _conv(sd, 'dp.pre', dp['pre'])
        dds('dp.convs', dp['dds'])
        _conv(sd, 'dp.proj', dp['proj'])
        flow_stack('dp.flows', dp['flows'])
        _conv(sd, 'dp.post_pre', dp['post_pre'])
        dds('dp.post_convs', dp['post_dds'])
        _conv(sd, 'dp.post_proj', dp['post_proj'])
        flow_stack('dp.post_flows', dp['post_flows'])
        if 'cond' in dp: _dense1x1(sd, 'dp.cond', dp['cond'])
    else:
        _conv(sd, 'dp.conv_1', dp['conv1'])
        _norm_gb(sd, 'dp.norm_1', dp['norm1'])
        _conv(sd, 'dp.conv_2', dp['conv2'])
        _norm_gb(sd, 'dp.norm_2', dp['norm2'])
        _dense1x1(sd, 'dp.proj', dp['proj'])
    if 'speaker_embedding' in params:
        sd['emb_g.weight'] = np.asarray(params['speaker_embedding']['embeddings'])
    if 'generator_cond' in params:
        _dense1x1(sd, 'dec.cond', params['generator_cond'])
    return sd


# -- the converters ----------------------------------------------------------------------

# the seeded params in the JAX trees come from `init` (`test_init_trees_match_jax`
# holds them to the JAX ``init`` trees)

def _hifigan_case(config):
    params = init.init_hifigan(HiFiGANArch(** config).hp, seed = 0)
    sd = _export_hifigan({}, params, len(config['resblock_kernel_sizes']))
    return sd, params, 'convert_hifigan', 'hifigan_config_from_state_dict', config


def _vocos_case(config):
    params = init.init_vocos(VocosArch(** config).hp, seed = 2)
    return _export_vocos(params), params, 'convert_vocos', 'vocos_config_from_state_dict', config


def _vits_case(config):
    arch = VITSArch(** config)
    params = init.init_vits(arch.hp, seed = 1)
    return _export_vits(arch, params), params, 'convert_vits', 'vits_config_from_state_dict', \
        config


CASES = {
    'hifigan_v1': lambda: _hifigan_case(HIFIGAN),
    'hifigan_v3': lambda: _hifigan_case(HIFIGAN_V3),
    'vocos': lambda: _vocos_case(VOCOS),
    'vits_sdp_speakers': lambda: _vits_case(VITS_SDP),
    'vits_conv_dp': lambda: _vits_case(VITS_BASE),
}


@pytest.mark.parametrize('name', list(CASES))
def test_converters_match_jax(name):
    sd, params, convert, config_fn, config = CASES[name]()
    got = getattr(tts_checkpoints, convert)(sd)
    _assert_trees_equal(got, getattr(jax_checkpoints, convert)(sd))
    _assert_trees_equal(got, params)
    inferred = getattr(tts_checkpoints, config_fn)(sd)
    assert inferred == getattr(jax_checkpoints, config_fn)(sd)
    for key, value in inferred.items():
        if key in config and key not in ('hop_length', 'win_length'):
            assert value == config[key], key


@pytest.mark.parametrize('name', ['hifigan', 'vocos', 'vits_sdp', 'vits_conv'])
def test_init_trees_match_jax(name):
    """The port's numpy inits make the JAX ``init`` trees (keys, shapes)."""
    arch, port_arch, init_fn = {
        'hifigan': (JaxHiFiGAN(** HIFIGAN_V3), HiFiGANArch(** HIFIGAN_V3), init.init_hifigan),
        'vocos': (JaxVocos(** VOCOS), VocosArch(** VOCOS), init.init_vocos),
        'vits_sdp': (JaxVITS(** VITS_SDP), VITSArch(** VITS_SDP), init.init_vits),
        'vits_conv': (JaxVITS(** dict(VITS_BASE, speaker_embedding_dim = 6, gin_channels = 8)),
                      VITSArch(** dict(VITS_BASE, speaker_embedding_dim = 6, gin_channels = 8)),
                      init.init_vits),
    }[name]
    shapes = jax.eval_shape(arch.init, jax.random.PRNGKey(0))
    if name.startswith('vits'): shapes = shapes[0]
    ours = init_fn(port_arch.hp, seed = 0)
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ours)
    want = jax.tree_util.tree_map(lambda a: (a.shape, np.dtype(a.dtype)), shapes)
    assert got == want


@pytest.mark.parametrize('name', ['hifigan', 'vocos', 'vits', 'HiFiGAN', 'tacotron2',
                                  'sv2tts_tacotron2', 'waveglow', 'fastspeech2',
                                  'audio_encoder'])
def test_architecture_names_resolve_as_in_jax(name):
    """`models.registry.get_architecture`: the JAX package's names (case
    blind), each to the port's class of the same name and hparams."""
    from text_to_speech_tpu.models.registry import get_architecture as jax_get_architecture
    from text_to_speech_tpu_torch.models.registry import get_architecture
    ours, ref = get_architecture(name), jax_get_architecture(name)
    assert type(ours).__name__ == type(ref).__name__
    assert json.loads(json.dumps(ours.get_config())) == json.loads(json.dumps(ref.get_config()))
    with pytest.raises(ValueError, match = 'Unknown architecture'):
        get_architecture('no_such_architecture')


# -- from_torch_pretrained, save, by name ---------------------------------------------------

TOKENS = np.array([[3, 5, 7, 9, 11, 2, 0, 0]], np.int32)
TINY_SD = {
    'hifigan': lambda: init.hifigan_state_dict(
        1, n_mel = 8, upsample_rates = (4, 2, 2), upsample_kernel_sizes = (8, 4, 4),
        upsample_initial_channel = 16, resblock_kernel_sizes = (3, 5),
        resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5)), scale = 0.2),
    'vocos': lambda: init.vocos_state_dict(1, n_mel = 9, dim = 16, intermediate_dim = 32,
                                           n_layers = 2, kernel_size = 3, n_fft = 16),
    'vits': lambda: init.vits_state_dict(
        1, vocab_size = 148, spec_channels = 9, inter_channels = 8, hidden_channels = 16,
        filter_channels = 32, n_layers = 1, posterior_layers = 2, flow_layers = 2,
        flow_wn_layers = 2, sdp_n_flows = 2, sdp_dds_layers = 2, sdp_n_bins = 4,
        upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4), upsample_initial_channel = 16,
        resblock_kernel_sizes = (3,), resblock_dilation_sizes = ((1, 3, 5),), scale = 0.2),
}


def _run(model, jax_model = None):
    """The model's output on a fixed input: a vocoder's waveform of a mel,
    VITS's waveform of `TOKENS` without noise."""
    if isinstance(model, HiFiGAN):
        mel = np.random.default_rng(0).standard_normal(
            (1, 20, model.arch.hp.n_mel_channels)).astype(np.float32)
        return np.asarray((jax_model or model).infer(mel))
    kw = dict(max_length = 64, noise_scale = 0., noise_scale_w = 0.)
    if jax_model is not None:
        return np.asarray(jax_model.compiled_infer(TOKENS, ** kw).audio)
    return model.compiled_infer(TOKENS, ** kw).audio.numpy()


@pytest.mark.parametrize('family', ['hifigan', 'vocos', 'vits'])
def test_from_torch_pretrained_then_by_name(family, tmp_path):
    cls = {'hifigan': HiFiGAN, 'vocos': Vocos, 'vits': VITS}[family]
    root = str(tmp_path)
    sd = TINY_SD[family]()
    checkpoint = str(tmp_path / 'checkpoint.pt')
    torch.save({'model': {k: torch.from_numpy(v) for k, v in sd.items()}}, checkpoint)
    model = cls.from_torch_pretrained(checkpoint, name = 'imported_' + family, root = root,
                                      device = 'cpu')
    reloaded = get_pretrained('imported_' + family, root = root, device = 'cpu')
    assert type(reloaded) is cls and reloaded.name == 'imported_' + family
    as_saved = lambda config: json.loads(json.dumps(config))
    assert as_saved(reloaded.arch.get_config()) == as_saved(model.arch.get_config())
    out = _run(model)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    np.testing.assert_array_equal(_run(reloaded), out)
    # the imported weights are the state dict's, weight norm folded
    convert = getattr(tts_checkpoints, 'convert_' + family)
    _assert_trees_equal(model.jax_trees()['params'],
                        convert(tts_checkpoints.remove_torch_weight_norm(sd)))
    if family != 'hifigan':
        return          # the VITS family's directory: `test_sv2tts_vits_by_name_matches_jax`
    # the JAX package loads the directory by name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        try:
            jax_model = jax_get_pretrained('imported_' + family)
            assert type(jax_model).__name__ == cls.__name__
            want = _run(model, jax_model)
        finally:
            reset_instances()
    assert want.shape == out.shape
    np.testing.assert_allclose(out, want, atol = 1e-5 * np.abs(want).max(), rtol = 0)


def test_sv2tts_vits_by_name_matches_jax(tmp_path):
    """`SV2TTSVITS.create` (a 6-wide embedding projected to the global
    conditioning), saved, loaded by name in both packages, one sentence
    cloned from an embedding."""
    root = str(tmp_path)
    config = dict(VITS_BASE, use_sdp = True, sdp_filter_channels = 16, sdp_n_flows = 2,
                  sdp_dds_layers = 2, sdp_n_bins = 4, gin_channels = 8)
    for key in ('vocab_size', 'spec_channels'):
        config.pop(key)
    from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
    model = SV2TTSVITS.create(name = 'clone', root = root, device = 'cpu', seed = 3,
                              embedding_dim = 6, mel_fn = TacotronSTFT(
                                  sampling_rate = 8000, hop_length = 8, filter_length = 16,
                                  win_length = 16), ** config)
    assert model.arch.hp.speaker_embedding_dim == 6 and model.arch.hp.spec_channels == 9
    reloaded = get_pretrained('clone', root = root, device = 'cpu')
    assert type(reloaded) is SV2TTSVITS and reloaded.embedding_dim == 6
    emb = np.random.default_rng(0).standard_normal(6).astype(np.float32)
    kw = dict(noise_scale = 0., noise_scale_w = 0., max_trial = 1)
    out = reloaded.infer('hello world', embeddings = emb, ** kw)
    other = reloaded.infer('hello world', embeddings = -emb, ** kw)
    assert out['audio'].size > 0 and np.isfinite(out['audio']).all()
    assert not np.array_equal(out['audio'][:other['audio'].size],
                              other['audio'][:out['audio'].size])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        try:
            jax_model = jax_get_pretrained('clone')
            assert type(jax_model).__name__ == 'SV2TTSVITS' and jax_model.embedding_dim == 6
            ref = jax_model.infer('hello world', embeddings = emb, ** kw)
        finally:
            reset_instances()
    assert out['audio'].shape == np.asarray(ref['audio']).shape
    ref_audio = np.asarray(ref['audio'])
    np.testing.assert_allclose(out['audio'], ref_audio, atol = 1e-5 * np.abs(ref_audio).max(),
                               rtol = 0)
