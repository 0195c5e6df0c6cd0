"""The training of VITS and SV2TTS-VITS: the port against the JAX package,
on the CPU.

The same seeded numpy trees (`init.init_vits`, with the flows' zero inits
drawn away from 0 so that no flow is the identity, and the discriminators'
`init_mpd` / `init_msd`) go to both packages.  The JAX package draws its
noise from ``jax.random`` and the port from a `torch.Generator`, so the
port is given the JAX draws: the posterior's ``eps``, the SDP's ``e_q``
and the windows' ``starts``, split from the step's key as `train_forward`
splits it.  Dropout is off in the comparisons (rate 0, in training mode);
its own case checks the draw.

  - `neg_cross_entropy` within 1e-5 of scale;
  - `maximum_path` equal to the bit on a given `neg_cent`: rows of
    different (T_b, L_b), and one built of ties;
  - `posterior`, `sdp_nll` and the whole `train_forward` (``train=False``)
    of an SDP model with an external speaker embedding: the durations equal,
    the rest within 1e-5 of scale;
  - two `make_vits_train_step` steps of a conv-predictor model and of the
    SDP model with the embedding in the batch's speaker slot: the losses
    within 1e-4 relative, the updated trees within 1e-4 of each tree's
    scale; a ``mixed_bfloat16`` step of the SDP model against the JAX
    mixed step: the losses, float32, within 5e-3 (the KL 3e-2), and every
    layer and the training forward's outputs at the JAX step's shapes and
    dtypes (each JAX step compiled once for the file, `jax_steps`);
  - `fit` on VITS and SV2TTS-VITS in a temporary root, the discriminators
    narrowed (`narrow_discriminators`): 2 epochs, 1 resumed (for VITS equal
    to 3 uninterrupted), their data pipelines, and `fit` reaching
    `train.gan.fit_gan`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import (  # noqa: F401  (narrow_discriminators: a fixture)
    compile_fast, jax_tree, layer_records, narrow_discriminators)

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models.vits_arch import (
    VITS as JaxVITS, maximum_path as jax_maximum_path, neg_cross_entropy as jax_nce)
from text_to_speech_tpu.nn import layers as jax_layers
from text_to_speech_tpu.ops.audio_io import load_audio as jax_load_audio
from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
from text_to_speech_tpu.train import gan as jax_gan
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from text_to_speech_tpu_torch.init import init_mpd, init_msd, init_vits
from text_to_speech_tpu_torch.models.tts import SV2TTSVITS, VITS as VITSModel
from text_to_speech_tpu_torch.models.tts.tacotron2 import _Clock
from text_to_speech_tpu_torch.models.vits_arch import VITS, maximum_path, neg_cross_entropy
from text_to_speech_tpu_torch.nn import layers
from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
from text_to_speech_tpu_torch.train import gan
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import convert_tree, tree_to_jax, vits_from_jax, vits_to_jax

#: ``tests/test_vits.py`` `make_arch`, one period and one scale, no dropout
BASE = dict(vocab_size = 40, spec_channels = 33, inter_channels = 8, hidden_channels = 16,
            filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
            flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
            upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
            upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
            resblock_dilation_sizes = ((1, 2),), mpd_periods = (2,), msd_scales = 1,
            segment_frames = 8, max_frames = 64, drop_rate = 0., duration_drop_rate = 0.,
            sdp_drop_rate = 0.)
CONFIGS = {
    'conv_dp': {},
    # one ConvFlow and one DDS layer a stack: the JAX step compiles in about
    # half the time of the JAX tests' two and two, and each part still runs
    'sdp_embedding': dict(use_sdp = True, sdp_filter_channels = 16, sdp_n_flows = 1,
                          sdp_dds_layers = 1, sdp_n_bins = 4, speaker_embedding_dim = 6,
                          gin_channels = 8),
}
BETAS = dict(b1 = 0.8, b2 = 0.99)
LR = 2e-4


def _t(array):
    array = np.asarray(array)
    return torch.from_numpy(array.astype(np.int64 if array.dtype.kind in 'iu' else np.float32))


def _scale_err(out, ref):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out.detach() if torch.is_tensor(out) else out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _flat(tree, prefix = ''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + '/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


#: leaves whose gradient is 0 by construction (a softmax does not see a bias
#: added to every key): Adam turns the float noise in it into steps of up
#: to lr, so they are held by that bound, not by the tolerance
ZERO_GRADIENT = ('attention/key/bias',)


def _same_tree(port, ref, tol, steps = 2, lr = LR):
    """The port's tree (the JAX layout) within `tol` of the scale of `ref`
    (a leaf that starts at 0 moves by ±lr on float noise in its gradient,
    so the tree's scale, not the leaf's); the `ZERO_GRADIENT` leaves within
    2 `steps` lr."""
    port, ref = _flat(port), _flat(ref)
    assert set(port) == set(ref)
    scale = max(np.abs(v).max() for v in ref.values())
    err = {k: np.abs(port[k].astype(np.float64) - ref[k]).max() for k in ref}
    noise = [k for k in ref if k.endswith(ZERO_GRADIENT)]
    assert all(err[k] <= 2 * steps * lr for k in noise), {k: err[k] for k in noise}
    worst = max(v for k, v in err.items() if k not in noise) / scale
    assert worst <= tol, worst


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
def setup():
    """{name: (JAX arch, port arch, params, discriminators)} (numpy trees in
    the JAX layout), and one batch."""
    out = {}
    for i, (name, extra) in enumerate(CONFIGS.items()):
        arch = VITS(** BASE, ** extra)
        params = init_vits(arch.hp, seed = i)
        _draw_zero_inits(params, np.random.default_rng(i))
        disc = {'mpd': init_mpd(arch.generator.hp, seed = 10 + i),
                'msd': init_msd(arch.generator.hp, seed = 20 + i)}
        out[name] = (JaxVITS(** BASE, ** extra), arch, params, disc)
    rng = np.random.default_rng(0)
    B, L, T, hop = 2, 5, 16, 8
    tokens = np.zeros((B, L), np.int32)
    tokens[0], tokens[1, :4] = rng.integers(3, 30, L), rng.integers(3, 30, 4)
    spec = (rng.standard_normal((B, T, 33)) ** 2).astype(np.float32)
    lengths = np.array([T, T - 4], np.int32)
    audio = (0.1 * rng.standard_normal((B, T * hop))).astype(np.float32)
    speaker = rng.standard_normal((B, 6)).astype(np.float32)
    out['batch'] = (tokens, spec, lengths, audio, speaker)
    out['mel_fns'] = (JaxTacotronSTFT(** STFT_8K), TacotronSTFT(** STFT_8K))
    return out


#: ``tests/test_vits.py``'s mel front end (hop 8, the generator's upsampling)
STFT_8K = dict(sampling_rate = 8000, n_mel_channels = 8, hop_length = 8, filter_length = 16,
               win_length = 16, mel_fmax = 4000.)


def _draws(key, batch, arch, dtype = jnp.float32):
    """The draws `train_forward` makes from `key`, as the port takes them."""
    tokens, spec, lengths = batch[:3]
    k_post, k_seg, _, k_dur = jax.random.split(key, 4)
    B, T = spec.shape[:2]
    eps = jax.random.normal(k_post, (B, T, arch.hp.inter_channels), dtype)
    max_start = np.maximum(lengths - arch.hp.segment_frames, 0)
    starts = np.floor(np.asarray(jax.random.uniform(k_seg, (B,))) * (max_start + 1))
    out = {'eps': _t(np.asarray(eps, np.float32)), 'starts': _t(starts.astype(np.int64))}
    if arch.hp.use_sdp:
        k_noise, _ = jax.random.split(k_dur)
        out['e_q'] = _t(np.asarray(jax.random.normal(k_noise, tokens.shape + (2,))))
    return out


# -- the alignment -------------------------------------------------------------------

def test_neg_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    z_p, m_p, logs_p = (rng.standard_normal(s).astype(np.float32)
                        for s in ((2, 9, 4), (2, 5, 4), (2, 5, 4)))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    ref = jax.jit(jax_nce)(* map(jnp.asarray, (z_p, m_p, logs_p, mask)))
    out = neg_cross_entropy(_t(z_p), _t(m_p), _t(logs_p), torch.from_numpy(mask))
    valid = np.broadcast_to(mask[:, None, :], out.shape)
    assert _scale_err(out.numpy()[valid], np.asarray(ref)[valid]) <= 1e-5
    assert (out.numpy()[~valid] == np.asarray(ref)[~valid]).all()


def _mas_case(kind):
    rng = np.random.default_rng(4)
    B, T, L = 3, 9, 5
    frames, tokens = np.array([9, 7, 5]), np.array([5, 3, 5])
    if kind == 'ties':
        # integers: many paths score the same, so the rule `down >= stay` decides
        nc = rng.integers(-2, 1, (B, T, L)).astype(np.float32)
    else:
        nc = rng.standard_normal((B, T, L)).astype(np.float32)
    return nc, np.arange(T)[None] < frames[:, None], np.arange(L)[None] < tokens[:, None]


@pytest.mark.parametrize('kind', ['rows_of_different_lengths', 'ties'])
def test_maximum_path_equals_jax_to_the_bit(kind):
    nc, fmask, tmask = _mas_case(kind)
    ref = np.asarray(compile_fast(jax_maximum_path, * map(jnp.asarray, (nc, fmask, tmask)))(
        * map(jnp.asarray, (nc, fmask, tmask))))
    out = maximum_path(_t(nc), torch.from_numpy(fmask), torch.from_numpy(tmask)).numpy()
    np.testing.assert_array_equal(out, ref)
    # each row's path: one token a valid frame, monotonic, every token used
    for b in range(nc.shape[0]):
        T_b, L_b = fmask[b].sum(), tmask[b].sum()
        idx = out[b, :T_b].argmax(axis = 1)
        assert (out[b, :T_b].sum(axis = 1) == 1).all() and out[b, T_b:].sum() == 0
        assert idx[0] == 0 and idx[-1] == L_b - 1 and (np.diff(idx) >= 0).all()
        assert (np.diff(idx) <= 1).all()


# -- the training forward ----------------------------------------------------------------

def test_posterior_sdp_nll_and_train_forward_match_jax(setup):
    jax_arch, arch, params, _ = setup['sdp_embedding']
    tokens, spec, lengths, audio, speaker = setup['batch']
    key = jax.random.PRNGKey(5)
    k_post, _, _, k_dur = jax.random.split(key, 4)
    w = np.array([[4., 3., 2., 4., 3.], [3., 4., 2., 3., 0.]], np.float32)
    h = np.random.default_rng(6).standard_normal((2, 5, 16)).astype(np.float32)

    def reference(p, tok, sp, ln, au, spk, h, w):
        g = jax_arch.global_cond(p, speaker_embedding = spk)
        fmask = jnp.arange(sp.shape[1])[None, :] < ln[:, None]
        post = jax_arch.posterior(p, sp, fmask, g = g, rng = k_post)
        nll = jax_arch.sdp_nll(p, h, w, tok != 0, g = g, train = False, rng = k_dur)
        out = jax_arch.train_forward(p, tok, sp, ln, au, key, speaker_embedding = spk,
                                     train = False)
        return post, nll, out
    args = (jax_tree(params), * map(jnp.asarray, (tokens, spec, lengths, audio, speaker, h, w)))
    post, nll, ref = compile_fast(reference, * args)(* args)

    p = vits_from_jax(params)
    draws = _draws(key, setup['batch'], arch)
    with torch.no_grad():
        g = arch.global_cond(p, speaker_embedding = _t(speaker))
        fmask = torch.arange(spec.shape[1])[None, :] < _t(lengths)[:, None]
        ours = arch.posterior(p, _t(spec), fmask, g = g, eps = draws['eps'])
        for o, r in zip(ours, post):
            assert _scale_err(o, r) <= 1e-5
        ours = arch.sdp_nll(p, _t(h), _t(w), _t(tokens) != 0, g = g, train = False,
                            e_q = draws['e_q'])
        assert _scale_err(ours, nll) <= 1e-5
        out = arch.train_forward(p, _t(tokens), _t(spec), _t(lengths), _t(audio),
                                 speaker_embedding = _t(speaker), train = False, ** draws)
    np.testing.assert_array_equal(out['durations'].numpy(), np.asarray(ref['durations']))
    np.testing.assert_array_equal(out['starts'].numpy(), np.asarray(ref['starts']))
    assert out['log_durations_hat'] is None and ref['log_durations_hat'] is None
    for k in ('z_p', 'm_p', 'logs_p', 'logs_q', 'duration_nll', 'audio_hat', 'audio_seg'):
        assert _scale_err(out[k], ref[k]) <= 1e-5, k
    np.testing.assert_array_equal(out['token_mask'].numpy(), np.asarray(ref['token_mask']))
    np.testing.assert_array_equal(out['frame_mask'].numpy(), np.asarray(ref['frame_mask']))


def test_dropout_in_training_mode():
    """Training mode drops at the JAX package's rates, from the generator:
    the same seed, the same draw; the keep rate within 3 sigma; inference
    unchanged."""
    arch = VITS(** dict(BASE, drop_rate = 0.25, duration_drop_rate = 0.5))
    p = vits_from_jax(init_vits(arch.hp, seed = 0))
    tokens = torch.from_numpy(np.tile(np.arange(3, 35), (4, 1)))
    run = lambda seed: arch.encode_text(p, tokens, train = True,
                                        generator = torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)
        assert not torch.equal(a[0], c[0])
        plain = arch.encode_text(p, tokens)
        assert torch.equal(arch.encode_text(p, tokens, train = False)[0], plain[0])
        assert not torch.equal(a[0], plain[0])
        h = torch.ones(64, 32, 16)
        kept = arch._dropout(h, 0.5, True, torch.Generator().manual_seed(3))
        rate = float((kept != 0).float().mean())
        assert abs(rate - 0.5) <= 3 * (0.25 / h.numel()) ** 0.5
        assert set(torch.unique(kept).tolist()) == {0., 2.}
        logw = arch.predict_log_durations(p, a[0], (tokens != 0).float(), train = True,
                                          generator = torch.Generator().manual_seed(4))
        assert not torch.equal(logw, arch.predict_log_durations(p, a[0], (tokens != 0).float()))


# -- the train step --------------------------------------------------------------------

def _methods(arch):
    """The training forward and the discriminators, for `layer_records`."""
    return [(arch, 'train_forward'), (arch.generator, 'apply_mpd'),
            (arch.generator, 'apply_msd')]


def _batch(setup, arch):
    return setup['batch'] if arch.hp.speaker_embedding_dim else setup['batch'][:4]


@pytest.fixture(scope = 'module')
def jax_steps(setup):
    """``get(name, precision) → (metrics of each step, final state, layer
    records)``: two JAX steps in float32 (keys 7 and 8), one mixed (key 7),
    each program compiled once for the file."""
    cache = {}

    def get(name, precision = None):
        if (name, precision) not in cache:
            jax_arch, _, params, disc = setup[name]
            batch = tuple(map(jnp.asarray, _batch(setup, jax_arch)))
            tx = jax_get_optimizer('adam', lr = LR, ** BETAS)
            init = jax.jit(tx.init)                    # one program, not one a leaf
            state = {'gen': jax_tree(params), 'disc': jax_tree(disc),
                     'gen_opt': init(jax_tree(params)), 'disc_opt': init(jax_tree(disc))}
            step = jax_gan.make_vits_train_step(
                jax_arch, tx, tx, jax_gan.mel_fn_from_stft(setup['mel_fns'][0]), donate = False,
                precision = precision)
            keys = [jax.random.PRNGKey(7 + i) for i in range(1 if precision else 2)]
            with layer_records(jax_layers, _methods(jax_arch)) as records:
                step = compile_fast(step, state, batch, keys[0])
            metrics = []
            for key in keys:
                state, out = step(state, batch, key)
                metrics.append({k: float(v) for k, v in out.items()})
            cache[name, precision] = metrics, state, records
        return cache[name, precision]
    return get


def _port_steps(setup, name, precision = None, n = 2):
    """`n` steps of the port from the JAX step's trees, batch and draws (in
    the compute dtype, as the JAX step draws them) → (metrics of each step
    as tensors, final state, layer records)."""
    _, arch, params, disc = setup[name]
    batch = _batch(setup, arch)
    tx_g, tx_d = (get_optimizer('adam', lr = LR, ** BETAS) for _ in range(2))
    state = {'gen': gan._trainable(vits_from_jax(params)),
             'disc': gan._trainable(convert_tree(disc))}
    state['gen_opt'], state['disc_opt'] = tx_g.init(state['gen']), tx_d.init(state['disc'])
    step = gan.make_vits_train_step(arch, tx_g, tx_d, gan.mel_fn_from_stft(setup['mel_fns'][1]),
                                    precision = precision)
    dtype = jnp.bfloat16 if precision else jnp.float32
    metrics, clock = [], _Clock(torch.device('cpu'))
    with layer_records(layers, _methods(arch)) as records:
        for i in range(n):
            state, out = step(state, tuple(map(_t, batch)), clock = clock,
                              draws = _draws(jax.random.PRNGKey(7 + i), batch, arch, dtype))
            metrics.append(out)
    # the step's parts: before, after the forward, the discriminators, the generator
    assert len(clock.marks) == 4 * n and all(s > 0 for s in clock.seconds())
    return metrics, state, records


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize('name', list(CONFIGS))
def test_train_steps_match_jax(setup, jax_steps, name):
    ref, jax_state, _ = jax_steps(name)
    ours, state, _ = _port_steps(setup, name)
    for r, o in zip(ref, map(_floats, ours)):
        for k, v in r.items():
            assert abs(o[k] - v) <= 1e-4 * abs(v), (k, o[k], v)
    _same_tree(vits_to_jax(state['gen']), jax_state['gen'], 1e-4)
    _same_tree(tree_to_jax(state['disc']), jax_state['disc'], 1e-4)


#: the mixed step's losses against the JAX mixed step's: readings 4.8e-7
#: (disc_loss) to 9.7e-4 (fm), the KL 9.3e-3 (a difference of bfloat16
#: logs and squares, rounded op by op in the port and fused in XLA)
MIXED_BOUNDS = dict(disc_loss = 5e-3, gen_loss = 5e-3, adv = 5e-3, fm = 5e-3, mel = 5e-3,
                    kl = 3e-2, duration = 5e-3)


def test_mixed_bfloat16_step_keeps_the_float32_losses(setup, jax_steps):
    """A ``mixed_bfloat16`` step of the SDP model with the embedding
    against the JAX mixed step on its draws (the posterior's drawn in
    bfloat16): float32 losses within `MIXED_BOUNDS`, which the JAX float32
    step (its own float32 draws) misses on the generator's loss, fm, mel,
    the KL and the durations; and the layer records: every conv, transposed
    conv and dense layer (the SDP's float32 island among them), each
    discriminator's scores and each output of the training forward (the
    float32 path products m_p, logs_p) at the JAX mixed step's shapes and
    dtypes, which a step that casts nothing, or casts the SDP, misses."""
    (ref,), _, jax_records = jax_steps('sdp_embedding', 'mixed_bfloat16')
    f32 = jax_steps('sdp_embedding')[0][0]
    (ours,), _, records = _port_steps(setup, 'sdp_embedding', 'mixed_bfloat16', n = 1)
    assert {v.dtype for v in ours.values()} == {torch.float32}
    ours = _floats(ours)
    for k, bound in MIXED_BOUNDS.items():
        assert abs(ours[k] - ref[k]) <= bound * abs(ref[k]), (k, ours[k], ref[k])
    for k in ('gen_loss', 'fm', 'mel', 'kl', 'duration'):
        assert abs(f32[k] - ref[k]) > MIXED_BOUNDS[k] * abs(ref[k]), (k, f32[k], ref[k])
    assert jax_records <= records, sorted(jax_records - records)


# -- the task models and `fit` ------------------------------------------------------------

TINY_TASK = {k: v for k, v in BASE.items() if k not in ('vocab_size', 'spec_channels')}
FIT = dict(batch_size = 2, token_multiple = 8, frame_multiple = 8, device = 'cpu',
           verbose = False)


def _fit_model(cls, root, name, ** extra):
    return cls.create('en', name = name, root = root, device = 'cpu',
                      mel_fn = TacotronSTFT(** STFT_8K), ** TINY_TASK, ** extra)


def _rows(n = 2, speaker = False):
    rng = np.random.default_rng(12)
    texts = ('hello world', 'one two three', 'goodbye now', 'four five six')
    rows = [{'text': texts[i], 'audio': (0.1 * rng.standard_normal(480)).astype(np.float32),
             'rate': 8000} for i in range(n)]
    if speaker:
        for row in rows:
            row['embedding'] = rng.standard_normal(6).astype(np.float32)
    return rows


@pytest.mark.parametrize('cls', [VITSModel, SV2TTSVITS], ids = ['vits', 'sv2tts_vits'])
def test_fit_trains_adversarially_and_resumes(tmp_path, narrow_discriminators, cls):
    """2 epochs, then 1 resumed; for VITS the continuation equals 3
    uninterrupted epochs (each epoch's generator is seeded by its number)."""
    sv2tts = cls is SV2TTSVITS
    extra = {'embedding_dim': 6} if sv2tts else {}
    rows = _rows(speaker = sv2tts)
    model = _fit_model(cls, str(tmp_path), 'interrupted', ** extra)
    history = model.fit(rows, epochs = 2, ** FIT)
    assert model.epochs == 2
    config = history.trainings[-1]['config']
    assert config['optimizer'] == 'gan-adam' and config['loss'] == 'vits_gan'
    last = history.epoch_logs[-1]['metrics']
    for key in ('loss', 'disc_loss', 'kl', 'duration', 'mel', 'adv', 'fm'):
        assert np.isfinite(last[key]), (key, last)
    gan_path = os.path.join(model.folder, 'saving', 'gan_state.npz')
    assert os.path.exists(gan_path)
    model.fit(rows, epochs = 1, ** FIT)
    assert model.epochs == 3 and model.ckpt_manager.latest_epoch == 3
    if not sv2tts:
        straight = _fit_model(cls, str(tmp_path), 'uninterrupted')
        straight.fit(rows, epochs = 3, ** FIT)
        ours, ref = _flat(model.jax_trees()['params']), _flat(straight.jax_trees()['params'])
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


def test_data_pipelines(tmp_path):
    """`prepare_data` as the JAX task model's (the tokens, the linear
    magnitude of the JAX package's `load_audio` through the JAX front end's
    STFT, both cut to whole frames); `filter_data` (MAS needs T >= L);
    `collate`; SV2TTS-VITS's embedding in the speaker slot."""
    model = _fit_model(SV2TTSVITS, str(tmp_path), 'data', embedding_dim = 6)
    rows = _rows(2, speaker = True)
    items = [model.prepare_data(row) for row in rows]
    stft = JaxTacotronSTFT(** STFT_8K).stft_fn
    for row, (tokens, spec, n, audio, emb) in zip(rows, items):
        np.testing.assert_array_equal(tokens, model.encode_text(row['text']))
        ref_audio = np.asarray(jax_load_audio(row, 8000), np.float32)
        ref = np.asarray(stft.transform(ref_audio[None])[0])[0]
        assert n == min(ref.shape[0], len(ref_audio) // 8) and spec.shape == (n, 9)
        np.testing.assert_allclose(spec, ref[:n], rtol = 0, atol = 1e-5 * np.abs(ref).max())
        np.testing.assert_array_equal(audio, ref_audio[: n * 8])
        np.testing.assert_array_equal(emb, row['embedding'])
        assert model.filter_data(* items[0])
    assert not model.filter_data(np.arange(70), items[0][1][:60], 60, items[0][3])
    tokens, spec, lengths, audio, emb = model.collate(items)
    assert tokens.shape[0] == spec.shape[0] == audio.shape[0] == 2 and emb.shape == (2, 6)
    np.testing.assert_array_equal(lengths, [item[2] for item in items])
    assert audio.shape[1] == spec.shape[1] * 8


@pytest.mark.parametrize('cls', [VITSModel, SV2TTSVITS], ids = ['vits', 'sv2tts_vits'])
def test_fit_reaches_the_adversarial_loop(tmp_path, monkeypatch, cls):
    """`fit` runs `train.gan.fit_gan`, not the likelihood trainer (VITS is
    a Tacotron2 task, whose `fit` teacher-forces)."""
    extra = {'embedding_dim': 6} if cls is SV2TTSVITS else {}
    model = _fit_model(cls, str(tmp_path), 'route', ** extra)
    calls = []
    monkeypatch.setattr(gan, 'fit_gan', lambda m, data, ** kw: calls.append((m, kw)) or 'gan')
    assert model.fit(_rows(), epochs = 1) == 'gan'
    assert calls == [(model, {'epochs': 1})]
