"""The adversarial training of HiFi-GAN and Vocos: the port against the JAX
package, on the CPU.

The same seeded numpy trees (`init.init_hifigan`, `init_vocos`, `init_mpd`,
`init_msd`; one set of discriminators for both generators) go to both
packages (the port's through `weights.hifigan_from_jax` and
`convert_tree`).  The discriminators keep their published channels even in
the tiny architecture, so each JAX program is compiled once for the file
(`jax_steps` holds the steps):

  - `apply_mpd` / `apply_msd` scores and every feature within 1e-5 of
    scale, at a length where the period's pad reflects, one where it takes
    the edge, and an odd one for the multi-scale pool;
  - the three LSGAN losses within 1e-6;
  - `generator_loss` (with and without the mel term) and
    `discriminator_step_loss` and their gradients within 1e-4 relative;
  - two `make_hifigan_train_step` steps (Adam, b1 0.8, b2 0.99, the mel
    term on a `TacotronSTFT`) on HiFi-GAN and on Vocos: the losses within
    1e-4 relative, the updated generator and discriminators within 1e-4 of
    each tree's scale (a leaf that starts at 0 moves by ±lr on float
    noise in its gradient); one ``mixed_bfloat16`` step of HiFi-GAN
    against the JAX mixed step: each loss within 5e-3, and every conv of
    the generator and the discriminators at the JAX step's shapes and
    dtypes;
  - `fit` on both task models in a temporary root, the discriminators
    narrowed (`narrow_discriminators`): 2 epochs, 1 resumed,
    `gan_state.npz`, a file that does not fit warned about, the data
    pipeline against the JAX package's audio and mel; `fit` reaches `train.gan.fit_gan` (a History with
    ``disc_loss``), not the likelihood trainer; a mesh without a process
    group raises.
"""

import logging
import os

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import (  # noqa: F401  (narrow_discriminators: a fixture)
    compile_fast, jax_tree, layer_records, narrow_discriminators)

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models.hifigan_arch import HiFiGAN as JaxHiFiGAN
from text_to_speech_tpu.models.vocos_arch import Vocos as JaxVocos
from text_to_speech_tpu.nn import layers as jax_layers
from text_to_speech_tpu.ops.audio_io import load_audio as jax_load_audio
from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
from text_to_speech_tpu.train import gan as jax_gan
from text_to_speech_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from text_to_speech_tpu_torch.init import init_hifigan, init_mpd, init_msd, init_vocos
from text_to_speech_tpu_torch.models.hifigan_arch import HiFiGAN, _pool
from text_to_speech_tpu_torch.models.tts import HiFiGAN as HiFiGANModel, Vocos as VocosModel
from text_to_speech_tpu_torch.models.vocos_arch import Vocos
from text_to_speech_tpu_torch.nn import layers
from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
from text_to_speech_tpu_torch.train import gan
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import (
    convert_tree, hifigan_from_jax, hifigan_to_jax, tree_to_jax)

#: ``tests/test_hifigan.py``'s tiny generator, one period and one scale
TINY = dict(n_mel_channels = 8, upsample_rates = (4, 2, 2), upsample_kernel_sizes = (8, 4, 4),
            upsample_initial_channel = 32, resblock_kernel_sizes = (3, 7),
            resblock_dilation_sizes = ((1, 3), (1, 3)), mpd_periods = (2,), msd_scales = 1)
#: ``tests/test_vocos.py``'s tiny Vocos
TINY_VOCOS = dict(n_mel_channels = 8, dim = 16, intermediate_dim = 32, n_layers = 2,
                  kernel_size = 3, n_fft = 16, hop_length = 4, win_length = 16,
                  mpd_periods = (2,), msd_scales = 1)
#: the discriminators' forward: a second period and the ×2 scale
DISC = dict(TINY, mpd_periods = (2, 5), msd_scales = 2)
STFT = dict(filter_length = 64, hop_length = 16, win_length = 64, n_mel_channels = 8)
BETAS = dict(b1 = 0.8, b2 = 0.99)
LR = 2e-4


def _scale_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _t(array):
    return torch.from_numpy(np.asarray(array, np.float32))


def _flat(tree, prefix = ''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + '/'))
        else:
            out[prefix + k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


def _same_tree(port, ref, tol, per_leaf = True):
    """The port's tree (the JAX layout) within `tol` of `ref`'s scale: of
    each leaf's, or with `per_leaf` False of the whole tree's.  Returns the
    largest error."""
    port, ref = _flat(port), _flat(ref)
    assert set(port) == set(ref)
    if per_leaf:
        worst = max(_scale_err(port[k], ref[k]) for k in ref)
    else:
        scale = max(np.abs(v).max() for v in ref.values())
        worst = max(np.abs(np.asarray(port[k], np.float64) - ref[k]).max() for k in ref) / scale
    assert worst <= tol, worst
    return worst


def _disc_trees(hp, seed):
    return {'mpd': init_mpd(hp, seed = seed), 'msd': init_msd(hp, seed = seed + 1)}


@pytest.fixture(scope = 'module')
def setup():
    """The tiny HiFi-GAN and Vocos, in both packages, with one set of
    seeded numpy trees each."""
    arch, voc = HiFiGAN(** TINY), Vocos(** TINY_VOCOS)
    disc = _disc_trees(arch.hp, 1)          # one period and one scale, as Vocos's
    out = {'hifigan': (JaxHiFiGAN(** TINY), arch, init_hifigan(arch.hp, seed = 0), disc),
           'vocos': (JaxVocos(** TINY_VOCOS), voc, init_vocos(voc.hp, seed = 3), disc)}
    rng = np.random.default_rng(5)
    out['mel'] = rng.standard_normal((2, 12, 8)).astype(np.float32)
    out['audio'] = (0.1 * rng.standard_normal((2, 12 * 16))).astype(np.float32)
    out['mel_fns'] = (JaxTacotronSTFT(** STFT), TacotronSTFT(** STFT))
    return out


# -- the discriminators -------------------------------------------------------------

@pytest.mark.parametrize('length', [37, 1], ids = ['reflect_odd_pool', 'edge'])
def test_discriminators_match_jax(length):
    jax_arch, arch = JaxHiFiGAN(** DISC), HiFiGAN(** DISC)
    trees = _disc_trees(arch.hp, 7)
    audio = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    args = (jax_tree(trees), jnp.asarray(audio))
    ref = compile_fast(lambda d, a: (jax_arch.apply_mpd(d['mpd'], a),
                                     jax_arch.apply_msd(d['msd'], a)), * args)(* args)
    disc = convert_tree(trees)
    with torch.no_grad():
        ours = (arch.apply_mpd(disc['mpd'], _t(audio)), arch.apply_msd(disc['msd'], _t(audio)))
    for ref_outs, outs in zip(ref, ours):
        for (ref_score, ref_feats), (score, feats) in zip(ref_outs, outs):
            assert score.shape == ref_score.shape
            assert _scale_err(score, ref_score) <= 1e-5
            assert len(feats) == len(ref_feats)
            for f, r in zip(feats, ref_feats):
                assert f.shape == r.shape and _scale_err(f, r) <= 1e-5


@pytest.mark.parametrize('length', [7, 8])
def test_pool_is_xla_same_reduce_window(length):
    x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    ref = jax.lax.reduce_window(jnp.asarray(x), 0., jax.lax.add, (1, 4), (1, 2), 'SAME') / 4.
    np.testing.assert_allclose(_pool(_t(x)).numpy(), np.asarray(ref), rtol = 0, atol = 1e-7)


def test_lsgan_losses_match_jax():
    rng = np.random.default_rng(9)
    outs = lambda: [(rng.standard_normal((2, 5)).astype(np.float32),
                     [rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(3)])
                    for _ in range(2)]
    real, fake = outs(), outs()
    to_jax = lambda o: [(jnp.asarray(s), [jnp.asarray(f) for f in fs]) for s, fs in o]
    to_port = lambda o: [(_t(s), [_t(f) for f in fs]) for s, fs in o]
    pairs = ((HiFiGAN.discriminator_loss(to_port(real), to_port(fake)),
              JaxHiFiGAN.discriminator_loss(to_jax(real), to_jax(fake))),
             (HiFiGAN.generator_adversarial_loss(to_port(fake)),
              JaxHiFiGAN.generator_adversarial_loss(to_jax(fake))),
             (HiFiGAN.feature_matching_loss(to_port(real), to_port(fake)),
              JaxHiFiGAN.feature_matching_loss(to_jax(real), to_jax(fake))))
    for ours, ref in pairs:
        assert abs(float(ours) - float(ref)) <= 1e-6 * abs(float(ref))


# -- the losses and their gradients -----------------------------------------------------

def test_losses_and_gradients_match_jax(setup):
    """`generator_loss` with the mel term and without it, and
    `discriminator_step_loss`, with their gradients (one JAX program)."""
    jax_arch, arch, gen, disc = setup['hifigan']
    jax_mel, mel_fn = setup['mel_fns']
    mel, audio = setup['mel'], setup['audio'][:, :150]        # the generator's audio is cut

    def reference(g, d, m, a):
        with_mel = jax.value_and_grad(lambda g: jax_arch.generator_loss(
            g, d, jax_mel.mel_spectrogram, m, a), has_aux = True)(g)
        without = jax.value_and_grad(lambda g: jax_arch.generator_loss(
            g, d, None, m, a)[0])(g)
        disc_step = jax.value_and_grad(lambda d: jax_arch.discriminator_step_loss(
            d, g, m, a))(d)
        return with_mel, without, disc_step
    args = (jax_tree(gen), jax_tree(disc), jnp.asarray(mel), jnp.asarray(audio))
    ((ref_loss, ref_terms), ref_grads), (ref_plain, ref_plain_grads), (ref_disc, ref_disc_grads) \
        = compile_fast(reference, * args)(* args)

    for mel_term, lref, gref in ((mel_fn.mel_spectrogram, ref_loss, ref_grads),
                                 (None, ref_plain, ref_plain_grads)):
        params = gan._trainable(hifigan_from_jax(gen))
        loss, terms = arch.generator_loss(params, convert_tree(disc), mel_term, _t(mel),
                                          _t(audio))
        loss.backward()
        assert abs(float(loss) - float(lref)) <= 1e-4 * abs(float(lref))
        if mel_term is not None:
            for k in ('adv', 'fm', 'mel'):
                assert abs(float(terms[k]) - float(ref_terms[k])) <= 1e-4 * abs(float(ref_terms[k]))
        _same_tree(hifigan_to_jax(_grad_tree(params)), gref, 1e-4)
    disc_params = gan._trainable(convert_tree(disc))
    loss = arch.discriminator_step_loss(disc_params, hifigan_from_jax(gen), _t(mel), _t(audio))
    loss.backward()
    assert abs(float(loss) - float(ref_disc)) <= 1e-4 * abs(float(ref_disc))
    _same_tree(tree_to_jax(_grad_tree(disc_params)), ref_disc_grads, 1e-4)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad


# -- the train step ----------------------------------------------------------------

def _step_inputs(setup, family):
    if family == 'hifigan':
        return setup['mel'], setup['audio']
    rng = np.random.default_rng(6)
    return (rng.standard_normal((2, 24, 8)).astype(np.float32),
            (0.1 * rng.standard_normal((2, 24 * 4))).astype(np.float32))


@pytest.fixture(scope = 'module')
def jax_steps(setup):
    """``get(family, precision) → (metrics of each step, final state, layer
    records)``: two JAX steps in float32, one mixed, each program compiled
    once for the file."""
    cache = {}

    def get(family, precision = None):
        if (family, precision) not in cache:
            jax_arch, _, gen, disc = setup[family]
            mel, audio = map(jnp.asarray, _step_inputs(setup, family))
            tx = jax_get_optimizer('adam', lr = LR, ** BETAS)
            init = jax.jit(tx.init)                    # one program, not one a leaf
            state = {'gen': jax_tree(gen), 'disc': jax_tree(disc), 'gen_opt': init(jax_tree(gen)),
                     'disc_opt': init(jax_tree(disc))}
            step = jax_gan.make_hifigan_train_step(
                jax_arch, tx, tx, jax_gan.mel_fn_from_stft(setup['mel_fns'][0]), donate = False,
                precision = precision)
            with layer_records(jax_layers, [(jax_arch, 'apply_mpd'), (jax_arch, 'apply_msd')]) \
                    as records:
                step = compile_fast(step, state, mel, audio)
            metrics = []
            for _ in range(1 if precision else 2):
                state, out = step(state, mel, audio)
                metrics.append({k: float(v) for k, v in out.items()})
            cache[family, precision] = metrics, state, records
        return cache[family, precision]
    return get


def _port_steps(setup, family, precision = None, n = 2):
    """`n` steps of the port from the JAX step's trees and batch → (metrics
    of each step, final state, layer records)."""
    _, arch, gen, disc = setup[family]
    mel, audio = map(_t, _step_inputs(setup, family))
    tx_g = get_optimizer('adam', lr = LR, ** BETAS)
    tx_d = get_optimizer('adam', lr = LR, ** BETAS)
    from_jax = hifigan_from_jax if family == 'hifigan' else convert_tree
    state = {'gen': gan._trainable(from_jax(gen)), 'disc': gan._trainable(convert_tree(disc))}
    state['gen_opt'], state['disc_opt'] = tx_g.init(state['gen']), tx_d.init(state['disc'])
    step = gan.make_hifigan_train_step(arch, tx_g, tx_d,
                                       gan.mel_fn_from_stft(setup['mel_fns'][1]),
                                       precision = precision)
    metrics = []
    with layer_records(layers, [(arch, 'apply_mpd'), (arch, 'apply_msd')]) as records:
        for _ in range(n):
            state, out = step(state, mel, audio)
            metrics.append({k: float(v) for k, v in out.items()})
    return metrics, state, records


@pytest.mark.parametrize('family', ['hifigan', 'vocos'])
def test_train_steps_match_jax(setup, jax_steps, family):
    ref, jax_state, _ = jax_steps(family)
    ours, state, _ = _port_steps(setup, family)
    for r, o in zip(ref, ours):
        for k, v in r.items():
            assert abs(o[k] - v) <= 1e-4 * abs(v), (k, o[k], v)
    # within the tree's scale: Adam's first steps turn float noise in a
    # gradient near 0 into up to ±lr, and the biases start at 0
    to_jax = hifigan_to_jax if family == 'hifigan' else tree_to_jax
    _same_tree(to_jax(state['gen']), jax_state['gen'], 1e-4, per_leaf = False)
    _same_tree(tree_to_jax(state['disc']), jax_state['disc'], 1e-4, per_leaf = False)


def test_mixed_bfloat16_step_matches_jax(setup, jax_steps):
    """One ``mixed_bfloat16`` step against the JAX mixed step.  Each loss
    within 5e-3 (bfloat16 keeps 8 bits: 2^-8 is 3.9e-3): the readings are
    1.5e-3 at most (``mel``), and the JAX float32 step sits 2.1e-6 to
    2.8e-3 from the mixed one, so these losses cannot tell a step that
    casts nothing from one that casts.  The layer records can: every conv
    and transposed conv of the generator and the discriminators, and each
    discriminator's scores, at the JAX mixed step's shapes and dtypes."""
    (ref,), _, jax_records = jax_steps('hifigan', 'mixed_bfloat16')
    (ours,), _, records = _port_steps(setup, 'hifigan', 'mixed_bfloat16', n = 1)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 5e-3 * abs(v), (k, ours[k], v)
    assert jax_records <= records, sorted(jax_records - records)
    assert {r[-1] for r in records} == {'bfloat16'}


# -- the task models and `fit` -------------------------------------------------------

def _fit_model(family, root, name):
    """A tiny task model of `family` under `root` (the mel front end at 8
    kHz, its hop the generator's upsampling)."""
    if family == 'hifigan':
        mel_fn = TacotronSTFT(sampling_rate = 8000, n_mel_channels = 8, hop_length = 16,
                              filter_length = 64, win_length = 64, mel_fmax = 4000.)
        return HiFiGANModel.create(name = name, root = root, device = 'cpu', mel_fn = mel_fn,
                                   ** TINY)
    mel_fn = TacotronSTFT(sampling_rate = 8000, n_mel_channels = 8, hop_length = 4,
                          filter_length = 16, win_length = 16, mel_fmax = 4000.)
    return VocosModel.create(name = name, root = root, device = 'cpu', mel_fn = mel_fn,
                             ** TINY_VOCOS)


def _rows(n = 2, samples = 512):
    rng = np.random.default_rng(11)
    return [{'audio': (0.1 * rng.standard_normal(samples)).astype(np.float32), 'rate': 8000}
            for _ in range(n)]


FIT = dict(batch_size = 2, frame_multiple = 8, device = 'cpu', verbose = False)


@pytest.mark.parametrize('family', ['hifigan', 'vocos'])
def test_fit_trains_adversarially_and_resumes(tmp_path, narrow_discriminators, family):
    """2 epochs, then 1 resumed from the checkpoint and `gan_state.npz`
    (``test_torch_port_vits_train.py`` holds a continuation to the
    uninterrupted run)."""
    model = _fit_model(family, str(tmp_path), 'interrupted')
    history = model.fit(_rows(), epochs = 2, ** FIT)
    assert model.epochs == 2 and len(history.epoch_logs) == 2
    config = history.trainings[-1]['config']
    assert config['optimizer'] == 'gan-adam' and config['loss'] == 'hifigan_gan'
    last = history.epoch_logs[-1]['metrics']
    for key in ('loss', 'disc_loss', 'gen_loss', 'adv', 'fm', 'mel'):
        assert np.isfinite(last[key]), (key, last)
    gan_path = os.path.join(model.folder, 'saving', 'gan_state.npz')
    assert os.path.exists(gan_path)
    assert model.ckpt_manager.latest_epoch == 2
    model.fit(_rows(), epochs = 1, ** FIT)
    assert model.epochs == 3 and model.ckpt_manager.latest_epoch == 3
    assert len(model.history.trainings) == 2


def test_a_gan_state_that_does_not_fit_starts_fresh(tmp_path, caplog, narrow_discriminators):
    model = _fit_model('hifigan', str(tmp_path), 'mismatch')
    gan_path = os.path.join(model.folder, 'saving', 'gan_state.npz')
    os.makedirs(os.path.dirname(gan_path), exist_ok = True)
    np.savez(gan_path, leaf_00000 = np.zeros(3, np.float32))
    with caplog.at_level(logging.WARNING, logger = gan.__name__):
        history = model.fit(_rows(), epochs = 1, ** FIT)
    assert any('does not match' in r.getMessage() for r in caplog.records)
    assert model.epochs == 1 and np.isfinite(history.epoch_logs[-1]['metrics']['disc_loss'])
    with np.load(gan_path) as data:
        assert 'leaf_00000' not in data.files and 'disc_opt/count' in data.files


def test_prepare_data_matches_jax(tmp_path):
    """`prepare_data` as the JAX task model's: the row's audio read by the
    JAX package's `load_audio`, its mel by the JAX front end, both cut to
    whole frames; `filter_data` and `collate`."""
    model = _fit_model('hifigan', str(tmp_path), 'data')
    rows = _rows(2, 300) + _rows(1, 100)
    items = [model.prepare_data(row) for row in rows]
    ref_fn = JaxTacotronSTFT(sampling_rate = 8000, n_mel_channels = 8, hop_length = 16,
                             filter_length = 64, win_length = 64, mel_fmax = 4000.)
    for row, (mel, audio) in zip(rows, items):
        ref_audio = np.asarray(jax_load_audio(row, 8000), np.float32)
        ref = np.asarray(ref_fn(ref_audio))[0]
        n = min(ref.shape[0], len(ref_audio) // 16)
        assert mel.shape == (n, 8) and audio.shape == (n * 16,)
        np.testing.assert_allclose(mel, ref[:n], rtol = 0, atol = 1e-4)
        np.testing.assert_array_equal(audio, ref_audio[: n * 16])
    assert [model.filter_data(* item) for item in items] == [True, True, False]
    mels, audios = model.collate(items[:2])
    assert mels.shape == (2, 18, 8) and audios.shape == (2, 18 * 16)


@pytest.mark.parametrize('family', ['hifigan', 'vocos'])
def test_fit_reaches_the_adversarial_loop(tmp_path, monkeypatch, family):
    """`fit` runs `train.gan.fit_gan`, not the likelihood trainer."""
    model = _fit_model(family, str(tmp_path), 'route')
    calls = []
    monkeypatch.setattr(gan, 'fit_gan', lambda m, data, ** kw: calls.append((m, kw)) or 'gan')
    assert model.fit(_rows(), epochs = 1) == 'gan'
    assert calls == [(model, {'epochs': 1})]


def test_mesh_raises(tmp_path):
    model = _fit_model('hifigan', str(tmp_path), 'mesh')
    # a mesh trains only across the ranks of a process group (parallel.spawn)
    from text_to_speech_tpu_torch.parallel import create_mesh
    with pytest.raises(RuntimeError, match = 'process group'):
        model.fit(_rows(), mesh = create_mesh({'dp': 2}, devices = [0, 1], platform = 'cpu'),
                  device = 'cpu')
