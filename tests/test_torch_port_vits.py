"""VITS and SV2TTS-VITS inference: the port against the JAX package, on the CPU.

The same seeded parameters go to both packages (the JAX tree through
`weights.vits_from_jax`), with the couplings' `post`, the ConvFlows'
`proj` and the affine flows drawn away from their zero init, so that no
flow is the identity:

  - `nn.flows.rational_quadratic_spline`, forward and inverse, inside and
    beyond the tails: the output within 1e-5, the log-determinant within
    1e-5 of its scale (both packages' float32 values sit up to 1.2e-5 from
    its float64 value);
  - `encode_text` with the windowed relative attention and with the plain
    MHA branch (``text_rel_window=None``);
  - `predict_log_durations`, and `sdp_sample` at ``noise_scale_w=0`` and
    with the JAX package's own noise draw given to the port;
  - `flow` in reverse and `decode_frames` on a given latent;
  - the whole `infer` at ``noise_scale = noise_scale_w = 0``: the conv
    duration predictor, the stochastic one with a speaker table, and an
    external (SV2TTS) embedding;
  - `tts(text, model = vits)` and `predict` with ``batch_size=2`` on the
    JAX package's VITS task model loaded by name, `get_models` resolving
    the vocoder to the model.

Durations are ``ceil(exp(logw) * d_control)``, which is discontinuous:
they are compared exactly, a difference must sit within 1e-5 of an
integer, and the rest is compared on the rows whose durations all agree
(as `_check` in ``test_torch_port_fastspeech2.py``).  No case here meets
such a tie.  The noise of both packages differs by design (``jax.random``
against a `torch.Generator`): only runs without noise, or with the noise
given, are compared.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import VITS as JaxVITSModel, tts as jax_tts
from text_to_speech_tpu.models.vits_arch import VITS as JaxVITS
from text_to_speech_tpu.nn.flows import rational_quadratic_spline as jax_spline
from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
from text_to_speech_tpu_torch import get_models, tts
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.tts import VITS as VITSModel
from text_to_speech_tpu_torch.models.vits_arch import VITS
from text_to_speech_tpu_torch.nn.flows import rational_quadratic_spline
from text_to_speech_tpu_torch.weights import vits_from_jax

#: the JAX package's tiny architecture (``tests/test_vits.py`` `make_arch`)
BASE = dict(vocab_size = 40, spec_channels = 33, inter_channels = 8, hidden_channels = 16,
            filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
            flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
            upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
            upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
            resblock_dilation_sizes = ((1, 2),), max_frames = 64)
SDP = dict(use_sdp = True, sdp_filter_channels = 16, sdp_n_flows = 2, sdp_dds_layers = 2,
           sdp_n_bins = 4)
CONFIGS = {
    'conv_dp': {},
    'sdp_speaker_table': dict(SDP, n_speakers = 3, gin_channels = 8),
    'external_embedding': dict(SDP, text_rel_window = None, speaker_embedding_dim = 6,
                               gin_channels = 8),
}
TOKENS = np.array([[3, 5, 7, 9, 11, 2, 0, 0], [4, 6, 8, 0, 0, 0, 0, 0]], np.int32)
TIE = 1e-5


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _scale_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max())


def _draw_zero_inits(tree, rng, path = ''):
    """The zero-initialised flow leaves (`post`, ConvFlow `proj`, the affine
    `m` / `logs`) redrawn at 0.1 N(0, 1)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw_zero_inits(v, rng, path + '/' + k)
        elif not np.any(v) and ('post' in path or 'proj' in path or k in ('m', 'logs')) \
                and 'posterior' not in path:
            tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)


@pytest.fixture(scope = 'module')
def archs():
    """{name: (JAX arch, port arch, JAX params, port params)}."""
    out = {}
    for i, (name, extra) in enumerate(CONFIGS.items()):
        config = dict(BASE, ** extra)
        jax_arch = JaxVITS(** config)
        params = _np(jax_arch.init(jax.random.PRNGKey(i))[0])
        _draw_zero_inits(params, np.random.default_rng(i))
        out[name] = (jax_arch, VITS(** config), _jax(params), vits_from_jax(params))
    return out


def _speakers(name):
    rng = np.random.default_rng(7)
    ids = np.array([0, 2]) if name == 'sdp_speaker_table' else None
    emb = rng.standard_normal((2, 6)).astype(np.float32) if name == 'external_embedding' \
        else None
    return ids, emb


def _g(jax_arch, arch, jparams, params, name):
    ids, emb = _speakers(name)
    ref = jax_arch.global_cond(jparams, speaker_ids = None if ids is None else jnp.asarray(ids),
                               speaker_embedding = None if emb is None else jnp.asarray(emb))
    out = arch.global_cond(params, speaker_ids = None if ids is None else torch.from_numpy(ids),
                           speaker_embedding = None if emb is None else torch.from_numpy(emb))
    return ref, out


# -- the spline ----------------------------------------------------------------------------

@pytest.mark.parametrize('inverse', [False, True], ids = ['forward', 'inverse'])
def test_spline_matches_jax(inverse):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4.9, 4.9, 60), [-7., -5., 5., 6.5]]).astype(np.float32)
    w, h = (rng.standard_normal((64, 10)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal((64, 9)).astype(np.float32)
    y, ld = rational_quadratic_spline(* map(torch.from_numpy, (x, w, h, d)), inverse = inverse)
    ref_y, ref_ld = jax.jit(lambda * a: jax_spline(* a, inverse = inverse))(
        * map(jnp.asarray, (x, w, h, d)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol = 1e-5, rtol = 0)
    # the log-determinant within 1e-5 of its scale: a sum of float32 logs of
    # products, which both packages compute up to 1.2e-5 off its float64
    # value on these inputs (up to 3.7 in magnitude)
    assert _scale_err(ld, ref_ld) <= 1e-5
    # the tails are the identity
    np.testing.assert_array_equal(y.numpy()[[60, 63]], x[[60, 63]])
    assert (ld.numpy()[[60, 63]] == 0).all()
    # and the inverse undoes the forward
    back, back_ld = rational_quadratic_spline(y, * map(torch.from_numpy, (w, h, d)),
                                              inverse = not inverse)
    np.testing.assert_allclose(back.numpy(), x, atol = 1e-4, rtol = 0)
    np.testing.assert_allclose(back_ld.numpy(), -ld.numpy(), atol = 1e-4, rtol = 0)


# -- the pieces ----------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['conv_dp', 'external_embedding'],
                         ids = ['relative_window', 'plain_mha'])
def test_encode_text_matches_jax(archs, name):
    jax_arch, arch, jparams, params = archs[name]
    ref = jax.jit(jax_arch.encode_text)(jparams, jnp.asarray(TOKENS))
    with torch.no_grad():
        out = arch.encode_text(params, torch.from_numpy(TOKENS).long())
    for o, r in zip(out[:3], ref[:3]):
        assert _scale_err(o, r) <= 1e-5
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    # padded rows are zero
    assert float(out[0][1, 3:].abs().max()) == 0.


def test_durations_match_jax(archs):
    """The conv predictor, and the SDP sampled in reverse at
    ``noise_scale_w = 0`` and from the JAX package's noise draw."""
    jax_arch, arch, jparams, params = archs['conv_dp']
    h, _, _, valid = jax.jit(jax_arch.encode_text)(jparams, jnp.asarray(TOKENS))
    mask = valid.astype(h.dtype)
    ref = jax.jit(jax_arch.predict_log_durations)(jparams, h, mask)
    with torch.no_grad():
        out = arch.predict_log_durations(params, torch.tensor(np.asarray(h)),
                                         torch.tensor(np.asarray(mask)))
    assert _scale_err(out, ref) <= 1e-5
    for name in ('sdp_speaker_table', 'external_embedding'):
        jax_arch, arch, jparams, params = archs[name]
        ref_g, g = _g(jax_arch, arch, jparams, params, name)
        h, _, _, valid = jax.jit(jax_arch.encode_text)(jparams, jnp.asarray(TOKENS))
        h_t, valid_t = torch.tensor(np.asarray(h)), torch.tensor(np.asarray(valid))
        key = jax.random.PRNGKey(3)
        noise = np.array(jax.random.normal(key, valid.shape + (2,)))
        sample = jax.jit(lambda p, h, v, g, w: jax_arch.sdp_sample(p, h, v, g = g,
                                                                   noise_scale_w = w, rng = key))
        for scale in (0., 0.8):
            ref = sample(jparams, h, valid, ref_g, scale)
            with torch.no_grad():
                out = arch.sdp_sample(params, h_t, valid_t, g = g, noise_scale_w = scale,
                                      noise = torch.from_numpy(noise))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = 1e-5, rtol = 0)


def test_flow_and_decode_frames_match_jax(archs):
    jax_arch, arch, jparams, params = archs['sdp_speaker_table']
    ref_g, g = _g(jax_arch, arch, jparams, params, 'sdp_speaker_table')
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 24, 8)).astype(np.float32)
    frame_mask = np.arange(24)[None] < np.array([[24], [17]])
    ref = jax.jit(lambda p, z, m, g: jax_arch.flow(p, z, m, g = g, reverse = True))(
        jparams, jnp.asarray(z), jnp.asarray(frame_mask), ref_g)
    with torch.no_grad():
        out = arch.flow(params, torch.from_numpy(z), torch.from_numpy(frame_mask), g = g,
                        reverse = True)
        forward = arch.flow(params, out, torch.from_numpy(frame_mask), g = g)
    assert _scale_err(out, ref) <= 1e-5
    # the couplings invert each other on the valid frames
    np.testing.assert_allclose((forward.numpy() * frame_mask[..., None]),
                               z * frame_mask[..., None], atol = 1e-5, rtol = 0)
    cond = rng.standard_normal((2, 16)).astype(np.float32)
    ref = jax.jit(jax_arch.decode_frames)(jparams, jnp.asarray(z), jnp.asarray(cond))
    with torch.no_grad():
        out = arch.decode_frames(params, torch.from_numpy(z), torch.from_numpy(cond))
    assert out.shape == ref.shape == (2, 24 * 8)
    assert _scale_err(out, ref) <= 1e-5


def _check(out, ref, pre):
    """Durations equal up to ties at integers; lengths, alignment and audio
    on the rows where every duration agrees.  Returns those rows."""
    durations, ref_durations = out.durations.numpy(), np.asarray(ref.durations)
    moved = durations != ref_durations
    if moved.any():
        assert (np.abs(pre[moved] - np.round(pre[moved])) <= TIE).all(), pre[moved]
        assert (np.abs(durations - ref_durations) <= 1).all()
    rows = ~moved.any(axis = 1)
    np.testing.assert_array_equal(out.lengths.numpy()[rows], np.asarray(ref.lengths)[rows])
    np.testing.assert_array_equal(out.attention_weights.numpy()[rows],
                                  np.asarray(ref.attention_weights)[rows])
    assert out.audio.shape == ref.audio.shape
    assert _scale_err(out.audio.numpy()[rows], np.asarray(ref.audio)[rows]) <= 1e-5
    return rows


@pytest.mark.parametrize('name', list(CONFIGS))
def test_infer_matches_jax(archs, name):
    jax_arch, arch, jparams, params = archs[name]
    ids, emb = _speakers(name)
    controls = dict(noise_scale = 0., noise_scale_w = 0., d_control = 1.7, max_frames = 64)
    ref = jax.jit(lambda p, t, i, e: jax_arch.infer(
        p, {}, t, speaker_ids = i, speaker_embedding = e, ** controls))(
        jparams, jnp.asarray(TOKENS), None if ids is None else jnp.asarray(ids),
        None if emb is None else jnp.asarray(emb))
    tokens = torch.from_numpy(TOKENS).long()
    spk = dict(speaker_ids = None if ids is None else torch.from_numpy(ids),
               speaker_embedding = None if emb is None else torch.from_numpy(emb))
    with torch.no_grad():
        out = arch.infer(params, {}, tokens, ** spk, ** controls)
        # the durations before rounding, ceil(exp(logw) * d_control)
        g = arch.global_cond(params, ** spk)
        h, _, _, valid = arch.encode_text(params, tokens)
        logw = arch.sdp_sample(params, h, valid, g = g, noise_scale_w = 0.) \
            if arch.hp.use_sdp else arch.predict_log_durations(params, h, valid.float(), g = g)
    pre = (torch.exp(logw) * valid * 1.7).numpy()
    rows = _check(out, ref, pre)
    assert rows.all() and int(out.lengths.min()) > 0
    assert out.stop_tokens is None and out.decoder_output is None


# -- the task model ------------------------------------------------------------------------

@pytest.fixture(scope = 'module')
def task(tmp_path_factory):
    """(root, JAX VITS task model, the port's, loaded by name from the JAX
    package's save)."""
    root = str(tmp_path_factory.mktemp('models'))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        config = dict(BASE, ** CONFIGS['sdp_speaker_table'])
        for key in ('vocab_size', 'n_speakers', 'gin_channels'):
            config.pop(key)
        mel_fn = JaxTacotronSTFT(sampling_rate = 8000, hop_length = 8, filter_length = 16,
                                 win_length = 16)
        jax_model = JaxVITSModel(lang = 'en', name = 'tiny_vits', mel_fn = mel_fn, ** config)
        params = _np(jax_model.params)
        _draw_zero_inits(params, np.random.default_rng(9))
        jax_model.set_weights(_jax(params))
        jax_model.save()
        yield root, jax_model, get_pretrained('tiny_vits', root = root, device = 'cpu')
        reset_instances()


def test_tts_matches_jax(task):
    root, jax_model, model = task
    assert type(model) is VITSModel and model.is_end_to_end
    for key in ('vocab_size', 'pad_token', 'spec_channels', 'use_sdp', 'sdp_n_bins'):
        assert model.arch.hp[key] == jax_model.arch.hp[key], key
    resolved, vocoder = get_models(model = model)
    assert resolved is model and vocoder is model
    kw = dict(noise_scale = 0., noise_scale_w = 0., d_control = 1.5, save = False,
              display = False)
    texts = ['hello world', 'goodbye']
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        refs = [jax_tts(texts[0], model = jax_model, ** kw),
                jax_tts(texts, model = jax_model, batch_size = 2, ** kw)]
    outs = [tts(texts[0], model = model, ** kw), tts(texts, model = model, batch_size = 2, ** kw)]
    for out, ref in zip(outs, refs):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            assert o['cleaned'] == r['cleaned'] and o['rate'] == r['rate'] == 8000
            assert o['mel'] == [None]
            assert o['audio'].shape == np.asarray(r['audio']).shape and o['audio'].size > 0
            assert _scale_err(o['audio'], r['audio']) <= 1e-5
    assert set(model.last_timings) == {'decode_s', 'vocode_s'}
