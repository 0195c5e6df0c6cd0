"""Data-parallel training on the port's mesh (`train.trainer.fit`,
`train.gan`), against the JAX package and the port's one-process steps on
the CPU.

One job of two gloo ranks (`parallel.spawn`, one module fixture;
`torch_port_mesh_workers.dp_training_cases`) runs every case while the test
process computes the references, four threads at once.  The
discriminators are narrowed (`torch_port_gan_util.narrow_discriminators`'
widths) on both sides.

  - WaveGlow `fit` (2 Adam steps of 4 rows, lr 1e-4) on ``{'dp': 2}`` and
    on ``{'dcn': 2} × {'dp': 1}``: the weights within 1e-5 of two steps of
    the JAX package's and the port's train step on the whole batches,
    bit-equal on both ranks, the losses within 1e-5 relative, the mesh in
    the history, checkpoints written by the first rank only;
  - a Tacotron-2 train step on ``{'dp': 2}`` whose two ranks hold rows of
    very different lengths: the masked batch-norm statistics and losses
    over the whole batch, so the loss, the gradient norm, the updated
    weights and the moved running statistics equal the JAX package's and
    the port's one-process step (1e-5 relative; the weights within 1e-4 of
    their scale, conv biases before a batch norm within 3 × lr, as
    ``test_torch_port_tacotron2_train.py`` holds them).  The loss of the
    ranks' local statistics, averaged, is far off: the case fails if the
    statistics are local;
  - a VITS step on ``{'dp': 2}``, spec lengths 16, 16 | 8, 6, given the
    draws the JAX step makes for the whole batch from its key: the masked
    KL and duration means over the whole batch, so every metric within
    1e-4 relative and both trees within 1e-4 of their scale of the JAX
    package's step and of the port's one-process step on the whole batch
    (a leaf whose gradient is 0 by construction within 2 lr of JAX's, as
    ``test_torch_port_vits_train.py`` holds it); the ranks' local KL
    averaged is far off;
  - HiFi-GAN `fit_gan` on ``{'dp': 2}``: one step, the losses within 1e-4
    relative (both sides' gradient norms too, against the one-process
    run: Adam's step would hide a summed reduce) and the generator within
    1e-4 of its scale of the JAX
    package's train step on the batch and trees that the one-process
    `fit_gan` starts its step from, and of that one-process `fit_gan`
    (Adam moves a leaf whose gradient is float noise by ±lr, as
    ``test_torch_port_gan.py`` holds it).
"""

import collections
import concurrent.futures
import threading

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import compile_fast, jax_tree
import torch_port_mesh_workers as workers

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.hifigan_arch import HiFiGAN as JaxHiFiGAN
from text_to_speech_tpu.models.tts import Tacotron2 as JaxTacotron
from text_to_speech_tpu.models.vits_arch import VITS as JaxVITS
from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
from text_to_speech_tpu.train import gan as jax_gan
from text_to_speech_tpu.train import losses as jax_losses
from text_to_speech_tpu.train import optimizers as jax_optimizers
from text_to_speech_tpu.train import trainer as jax_trainer
from text_to_speech_tpu_torch import parallel
from text_to_speech_tpu_torch.init import init_vits, init_waveglow
from text_to_speech_tpu_torch.models import hifigan_arch
from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow as WaveGlowTask
from text_to_speech_tpu_torch.models.vits_arch import VITS
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.train import gan, trainer
from text_to_speech_tpu_torch.train.datasets import prepare_dataset
from text_to_speech_tpu_torch.train.losses import TacotronLoss, get_loss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import (
    flatten_tree, hifigan_to_jax, tree_to_jax, vits_from_jax, vits_to_jax, waveglow_to_jax)

WG_FIT = dict(n_mel_channels = 8, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 2, wn_channels = 16, upsample_width = 1024,
              upsample_stride = 256)
TACOTRON = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
                prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
                lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                max_decoder_steps = 16, encoder_drop_rate = 0., prenet_drop_rate = 0.,
                postnet_drop_rate = 0.)
VITS_HP = dict(vocab_size = 40, spec_channels = 33, inter_channels = 8, hidden_channels = 16,
               filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
               flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
               upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
               upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
               resblock_dilation_sizes = ((1, 2),), mpd_periods = (2,), msd_scales = 1,
               segment_frames = 8, max_frames = 64, drop_rate = 0., duration_drop_rate = 0.,
               sdp_drop_rate = 0.)
HIFIGAN = dict(n_mel_channels = 8, upsample_rates = (4, 2, 2), upsample_kernel_sizes = (8, 4, 4),
               upsample_initial_channel = 32, resblock_kernel_sizes = (3, 7),
               resblock_dilation_sizes = ((1, 3), (1, 3)), mpd_periods = (2,), msd_scales = 1)
HIFIGAN_STFT = dict(sampling_rate = 8000, n_mel_channels = 8, hop_length = 16,
                    filter_length = 64, win_length = 64, mel_fmax = 4000.)
#: `torch_port_gan_util.narrow_discriminators`' widths
MPD = (4, 8, 16, 16)
MSD = ((15, 1, 1, 16), (41, 2, 4, 16), (41, 2, 16, 16), (41, 4, 16, 16), (41, 4, 16, 32),
       (41, 1, 16, 32), (5, 1, 1, 32))


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-6), '{}: {}'.format(what, err)


def _rel(out, ref, tol, what = ''):
    assert abs(out - ref) <= tol * max(abs(ref), 1e-6), '{}: {} vs {}'.format(what, out, ref)


def _wg_rows():
    rng = np.random.default_rng(3)
    return [{'audio': (0.3 * rng.standard_normal(4096 + 256 * (i % 3))).astype(np.float32),
             'rate': 22050} for i in range(8)]


def _taco_rows():
    """Two long rows for the first rank, two short ones for the second."""
    rng = np.random.RandomState(0)
    texts = ['this is a much longer sentence', 'another long sentence here', 'hi', 'ok']
    return [{'text': t, 'audio': (rng.randn(n) * 0.1).astype(np.float32), 'rate': 22050}
            for t, n in zip(texts, (6000, 5600, 1300, 1100))]


#: the key of the JAX VITS step, whose draws the port's steps are given
VITS_KEY = 7
#: the learning rate of the GAN steps
GAN_LR = 2e-4


def _vits_batch():
    """The batch, and the draws that `train_forward` makes from
    `VITS_KEY` in the JAX step (``test_torch_port_vits_train._draws``)."""
    rng = np.random.default_rng(0)
    B, L, T, hop = 4, 5, 16, 8
    tokens = np.zeros((B, L), np.int32)
    for b, n in enumerate((5, 5, 3, 2)):
        tokens[b, :n] = rng.integers(3, 30, n)
    spec = (rng.standard_normal((B, T, 33)) ** 2).astype(np.float32)
    lengths = np.array([16, 16, 8, 6], np.int32)
    audio = (0.1 * rng.standard_normal((B, T * hop))).astype(np.float32)
    hp = VITS(** VITS_HP).hp
    k_post, k_seg, _, _ = jax.random.split(jax.random.PRNGKey(VITS_KEY), 4)
    eps = np.array(jax.random.normal(k_post, (B, T, hp.inter_channels)), np.float32)
    max_start = np.maximum(lengths - hp.segment_frames, 0)
    starts = np.floor(np.asarray(jax.random.uniform(k_seg, (B,))) * (max_start + 1))
    return (tokens, spec, lengths, audio), {'eps': eps, 'starts': starts.astype(np.int64)}


@pytest.fixture(scope = 'module')
def job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dp_models'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    old_widths = hifigan_arch.MPD_CHANNELS, hifigan_arch.MSD_SPECS
    hifigan_arch.MPD_CHANNELS, hifigan_arch.MSD_SPECS = MPD, MSD
    try:
        yield _job(tmp_path_factory, root)
    finally:
        hifigan_arch.MPD_CHANNELS, hifigan_arch.MSD_SPECS = old_widths
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def _job(tmp_path_factory, root):
    wg_arch = WaveGlow(** WG_FIT)
    wg_params = init_waveglow(wg_arch.hp, wg_arch.flow_channels, seed = 1)
    vits_jax_params = init_vits(VITS(** VITS_HP).hp, seed = 0)
    vits_params = vits_from_jax(vits_jax_params)
    vits_batch, vits_draws = _vits_batch()
    hifigan = {'config': HIFIGAN, 'stft': HIFIGAN_STFT, 'root': str(tmp_path_factory.mktemp(
        'dp_gan')), 'rows': [{'audio': (0.1 * np.random.default_rng(11 + i).standard_normal(
            512)).astype(np.float32), 'rate': 8000} for i in range(4)]}
    box = {}
    # the references in threads, each mostly one JAX compile: three start
    # while the JAX Tacotron-2 the ranks load is made, the fourth with the
    # ranks
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        refs = {'waveglow': pool.submit(_wg_references, wg_params,
                                        tmp_path_factory.mktemp('dp_ref')),
                'vits': pool.submit(_vits_references, vits_params, vits_jax_params,
                                    vits_batch, vits_draws),
                'hifigan': pool.submit(_hifigan_references, hifigan,
                                       str(tmp_path_factory.mktemp('gan_ref')))}
        jtaco = JaxTacotron(lang = 'en', name = 'dp_taco', ** TACOTRON)
        items = [jtaco.prepare_data(row) for row in _taco_rows()]
        taco_batch = jax_trainer.bucket_pad(jtaco.collate(items), jtaco, token_multiple = 8,
                                            frame_multiple = 16)
        case = {
            'mpd': MPD, 'msd': MSD,
            'waveglow': {'config': WG_FIT, 'params': wg_params, 'rows': _wg_rows(),
                         'root': str(tmp_path_factory.mktemp('dp_fit'))},
            'tacotron': {'name': 'dp_taco', 'root': root, 'batch': taco_batch},
            'vits': {'config': VITS_HP, 'params': vits_params, 'batch': vits_batch,
                     'draws': vits_draws},
            'hifigan': hifigan,
        }

        def run():
            try:
                box['ranks'] = parallel.spawn(workers.dp_training_cases, 2, backend = 'gloo',
                                              device = 'cpu', args = (case,))
            except BaseException as e:
                box['error'] = e

        thread = threading.Thread(target = run)
        thread.start()
        try:
            refs['tacotron'] = pool.submit(_taco_references, jtaco, root, taco_batch)
            refs = {k: v.result() for k, v in refs.items()}
        finally:
            thread.join()
    if 'error' in box:
        raise box['error']
    return box['ranks'], refs


def _wg_references(params, root):
    """Two steps of the JAX package's and of the port's train step on the
    batches `fit` makes."""
    task = WaveGlowTask.from_jax(params, device = 'cpu', name = 'wg_ref', root = str(root),
                                 ** WG_FIT)
    ds = prepare_dataset(_wg_rows(), prepare_fn = task.prepare_data,
                         filter_fn = getattr(task, 'filter_data', None),
                         collate_fn = task.collate, batch_size = 4, shuffle = False,
                         length_bucket_fn = trainer._item_length, seed = 0)
    batches = [trainer.bucket_pad(b, task) for b in ds]
    assert len(batches) == 2
    loss_fn = get_loss(task._default_loss)
    tx = get_optimizer('adam', lr = 1e-4)
    leaves = trainer._trainable(task.params)
    opt = tx.init(leaves)
    step = trainer.make_train_step(task, loss_fn, tx)
    losses = []
    for inputs, targets in batches:
        leaves, _, opt, metrics = step(leaves, task.state, opt, torch.Generator(),
                                       trainer._to_device(inputs, 'cpu'),
                                       trainer._to_device(targets, 'cpu'))
        losses.append(float(metrics['loss']))
    from text_to_speech_tpu.models.tts.waveglow import WaveGlow as JaxTask
    jtask = object.__new__(JaxTask)
    jtask.arch = JaxWaveGlow(** WG_FIT)
    jtx = jax_optimizers.get_optimizer('adam', lr = 1e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jtx.init(jparams)
    jstep = jax_trainer.make_train_step(jtask, jax_losses.WaveGlowLoss(sigma = loss_fn.sigma),
                                        jtx)
    jlosses = []
    for inputs, targets in batches:
        jparams, _, jopt, jmetrics = jstep(jparams, {}, jopt, jax.random.PRNGKey(0), inputs,
                                           targets)
        jlosses.append(float(jmetrics['loss']))
    return {'port': workers.to_numpy(leaves), 'losses': losses,
            'jax': jax.tree_util.tree_map(np.asarray, jparams), 'jax_losses': jlosses}


def _taco_references(jtaco, root, batch):
    """One Adam step of the JAX package's and the port's train step on the
    whole batch."""
    model = Tacotron2.from_pretrained('dp_taco', root = root, device = 'cpu')
    params = trainer._trainable(model.params)
    tx = get_optimizer('adam', lr = 1e-3)
    step = trainer.make_train_step(model, TacotronLoss(), tx)
    params, state, _, metrics = step(params, model.state, tx.init(params),
                                     torch.Generator().manual_seed(0),
                                     trainer._to_device(batch[0], 'cpu'),
                                     trainer._to_device(batch[1], 'cpu'))
    jtx = jax_optimizers.get_optimizer('adam', lr = 1e-3)
    jparams, jstate = (jax.tree_util.tree_map(jnp.array, t) for t in (jtaco.params, jtaco.state))
    jstep = jax_trainer.make_train_step(jtaco, jax_losses.TacotronLoss(), jtx)
    jstep = compile_fast(jstep, jparams, jstate, jtx.init(jparams), jax.random.PRNGKey(0),
                         * batch)
    jparams, jstate, _, jmetrics = jstep(jparams, jstate, jtx.init(jparams),
                                         jax.random.PRNGKey(0), * batch)
    return {'port': {'loss': float(metrics['loss']), 'grad_norm': float(metrics['grad_norm']),
                     'params': workers.to_numpy(params), 'state': workers.to_numpy(state)},
            'jax': {'loss': float(jmetrics['loss']), 'grad_norm': float(jmetrics['grad_norm']),
                    'params': jax.tree_util.tree_map(np.asarray, jparams),
                    'state': jax.tree_util.tree_map(np.asarray, jstate)},
            'start': jax.tree_util.tree_map(np.asarray, jtaco.params)}


def _jax_adam():
    return jax_optimizers.get_optimizer('adam', lr = GAN_LR, b1 = 0.8, b2 = 0.99)


def _jax_gan_state(gen, disc):
    """The JAX step's state from numpy trees in the JAX layout."""
    tx = _jax_adam()
    init = jax.jit(tx.init)                     # one program, not one a leaf
    return {'gen': jax_tree(gen), 'disc': jax_tree(disc), 'gen_opt': init(jax_tree(gen)),
            'disc_opt': init(jax_tree(disc))}


def _vits_references(params, jax_params, batch, draws):
    """One step of the port's VITS step on the whole batch and of the JAX
    package's (its key's draws are `draws`), from the same trees."""
    arch = VITS(** VITS_HP)
    tx_g = get_optimizer('adam', lr = GAN_LR, b1 = 0.8, b2 = 0.99)
    tx_d = get_optimizer('adam', lr = GAN_LR, b1 = 0.8, b2 = 0.99)
    state = gan.init_vits_train_state(arch, workers.trainable(params), tx_g, tx_d, seed = 0)
    disc = tree_to_jax(state['disc'])
    step = gan.make_vits_train_step(arch, tx_g, tx_d)
    _, metrics = step(state, trainer._to_device(batch, 'cpu'),
                      draws = {k: torch.from_numpy(v) for k, v in draws.items()})
    jstate = _jax_gan_state(jax_params, disc)
    jbatch = tuple(map(jnp.asarray, batch))
    key = jax.random.PRNGKey(VITS_KEY)
    jstep = jax_gan.make_vits_train_step(JaxVITS(** VITS_HP), _jax_adam(), _jax_adam(),
                                         donate = False)
    jstate, jmetrics = compile_fast(jstep, jstate, jbatch, key)(jstate, jbatch, key)
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'gen': workers.to_numpy(state['gen']), 'disc': workers.to_numpy(state['disc']),
            'jax': {'metrics': {k: float(v) for k, v in jmetrics.items()},
                    'gen': jax.tree_util.tree_map(np.asarray, jstate['gen']),
                    'disc': jax.tree_util.tree_map(np.asarray, jstate['disc'])}}


def _hifigan_references(case, root):
    """The one-process `fit_gan`, and the JAX package's train step on the
    batch and trees that `fit_gan` starts its step from."""
    start = {}
    make_step = gan.make_hifigan_train_step

    def recording(* args, ** kwargs):
        step = make_step(* args, ** kwargs)

        def recorded(state, mel, audio):
            if not start:
                start.update(gen = hifigan_to_jax(state['gen']), disc = tree_to_jax(state['disc']),
                             mel = mel.numpy().copy(), audio = audio.numpy().copy())
            return step(state, mel, audio)
        return recorded
    gan.make_hifigan_train_step = recording
    try:
        out = workers.hifigan_fit(case, None, root)
    finally:
        gan.make_hifigan_train_step = make_step
    jstate = _jax_gan_state(start['gen'], start['disc'])
    mel, audio = jnp.asarray(start['mel']), jnp.asarray(start['audio'])
    jstep = jax_gan.make_hifigan_train_step(
        JaxHiFiGAN(** HIFIGAN), _jax_adam(), _jax_adam(),
        jax_gan.mel_fn_from_stft(JaxTacotronSTFT(** case['stft'])), donate = False)
    jstate, jmetrics = compile_fast(jstep, jstate, mel, audio)(jstate, mel, audio)
    out['jax'] = {'metrics': {k: float(v) for k, v in jmetrics.items()},
                  'gen': jax.tree_util.tree_map(np.asarray, jstate['gen'])}
    return out


#: VITS leaves whose gradient is 0 by construction (a softmax does not see a
#: bias added to every key): Adam turns float noise in it into a step of up
#: to lr (``test_torch_port_vits_train.ZERO_GRADIENT``)
ZERO_GRADIENT = ('attention/key/bias',)


def _within_tree_scale(tree, ref, tol, noise = (), noise_bound = 0.):
    """Every leaf of `tree` within `tol` of the largest magnitude in
    `ref`, the leaves ending in `noise` within `noise_bound`."""
    flat, flat_ref = flatten_tree(tree), flatten_tree(ref)
    assert sorted(flat) == sorted(flat_ref)
    scale = max(float(np.abs(v).max()) for v in flat_ref.values())
    for key, value in flat.items():
        err = float(np.abs(np.asarray(value, np.float64) - flat_ref[key]).max())
        assert err <= (noise_bound if key.endswith(noise) else tol * scale), (key, err)


def test_no_rank_loads_jax(job):
    ranks, _ = job
    assert [r['rank'] for r in ranks] == [0, 1]
    assert all(r['modules'] == [] for r in ranks)
    assert ranks[0]['hybrid_axes'] == ('dcn', 'dp')


@pytest.mark.parametrize('mesh', ['fit_dp', 'fit_dcn'])
def test_waveglow_fit_matches_jax_and_one_process(job, mesh):
    ranks, refs = job
    ref = refs['waveglow']
    axes = [('dp', 2)] if mesh == 'fit_dp' else [('dcn', 2), ('dp', 1)]
    for r in ranks:
        got = r[mesh]
        assert got['mesh'] == str(collections.OrderedDict(axes))
        # the history holds the epoch's mean loss
        _rel(got['loss'][0], float(np.mean(ref['jax_losses'])), 1e-5, 'loss against JAX')
        _rel(got['loss'][0], float(np.mean(ref['losses'])), 1e-5, 'loss against one process')
        for key, value in flatten_tree(got['params']).items():
            np.testing.assert_array_equal(value, flatten_tree(ranks[0][mesh]['params'])[key])
    port = flatten_tree(ref['port'])
    jax_flat = flatten_tree(ref['jax'])
    got = ranks[0][mesh]['params']
    got_jax = flatten_tree(waveglow_to_jax(jax.tree_util.tree_map(torch.from_numpy, got)))
    for key, value in flatten_tree(got).items():
        np.testing.assert_allclose(value, port[key], atol = 1e-5, rtol = 0, err_msg = key)
    for key, value in got_jax.items():
        np.testing.assert_allclose(value, jax_flat[key], atol = 1e-5, rtol = 0, err_msg = key)
    assert [r[mesh]['wrote'] for r in ranks] == [True, False]


def test_tacotron_step_counts_the_whole_batch(job):
    ranks, refs = job
    ref = refs['tacotron']
    for r in ranks:
        got = r['taco']
        for side in ('jax', 'port'):
            _rel(got['loss'], ref[side]['loss'], 1e-5, 'loss ' + side)
            _rel(got['grad_norm'], ref[side]['grad_norm'], 1e-5, 'grad norm ' + side)
        # the ranks' local batch-norm statistics give another loss
        assert abs(got['local_loss'] - got['loss']) > 100 * 1e-5 * abs(got['loss'])
    got = flatten_tree(tree_to_jax(jax.tree_util.tree_map(torch.from_numpy,
                                                          ranks[0]['taco']['params'])))
    got_state = flatten_tree(tree_to_jax(jax.tree_util.tree_map(torch.from_numpy,
                                                                ranks[0]['taco']['state'])))
    jax_params, start = flatten_tree(ref['jax']['params']), flatten_tree(ref['start'])
    assert sorted(got) == sorted(jax_params)
    for key, value in got.items():
        if key.endswith('/conv/bias'):
            assert np.abs(value - start[key]).max() <= 1e-3 * (1 + 1e-4), key
        else:
            _close(value, jax_params[key], 1e-4, key)
    for key, value in flatten_tree(ref['jax']['state']).items():
        _close(got_state[key], value, 1e-5, key)
    port = flatten_tree(ref['port']['params'])
    for key, value in flatten_tree(ranks[0]['taco']['params']).items():
        if key.endswith('/conv/bias'):      # float-noise gradients: Adam's ±lr
            assert np.abs(value - port[key]).max() <= 2e-3 * (1 + 1e-4), key
        else:
            _close(value, port[key], 1e-5, key)
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for v in flatten_tree(ranks[0]['taco']['params']).values()]),
        np.concatenate([v.ravel() for v in flatten_tree(ranks[1]['taco']['params']).values()]))


def _jax_layout(tree, to_jax):
    """A numpy tree in the port's layout → numpy in the JAX package's."""
    return to_jax(jax.tree_util.tree_map(torch.from_numpy, tree))


def test_vits_step_takes_masked_means_over_the_whole_batch(job):
    ranks, refs = job
    ref = refs['vits']
    for r in ranks:
        got = r['vits']
        assert sorted(got['metrics']) == sorted(ref['metrics'])
        # the port adds each side's gradient norm to the JAX step's metrics
        assert set(ref['jax']['metrics']) <= set(got['metrics'])
        for key, value in got['metrics'].items():
            _rel(value, ref['metrics'][key], 1e-4, key)
        for key, value in ref['jax']['metrics'].items():
            _rel(got['metrics'][key], value, 1e-4, key + ' against JAX')
        assert abs(got['kl_local'] - got['kl_global']) > 1e-2 * abs(got['kl_global'])
        for tree in ('gen', 'disc'):
            _within_tree_scale(got[tree], ref[tree], 1e-4)
        _within_tree_scale(_jax_layout(got['gen'], vits_to_jax), ref['jax']['gen'], 1e-4,
                           ZERO_GRADIENT, 2 * GAN_LR)
        _within_tree_scale(_jax_layout(got['disc'], tree_to_jax), ref['jax']['disc'], 1e-4)


def test_fit_gan_on_dp_matches_one_process(job):
    ranks, refs = job
    ref = refs['hifigan']
    for r in ranks:
        got = r['fit_gan']
        assert got['mesh'] == str(collections.OrderedDict([('dp', 2)]))
        for side, disc_loss, gen_loss in (
                ('one process', ref['disc_loss'][0], ref['gen_loss'][0]),
                ('JAX', ref['jax']['metrics']['disc_loss'], ref['jax']['metrics']['gen_loss'])):
            _rel(got['disc_loss'][0], disc_loss, 1e-4, 'disc loss against ' + side)
            _rel(got['gen_loss'][0], gen_loss, 1e-4, 'gen loss against ' + side)
        # Adam's step hides the gradients' scale: their norms, after the
        # reduce, show it (a summed reduce gives twice the one process's)
        for got_norm, ref_norm in zip(got['grad_norms'], ref['grad_norms']):
            _rel(got_norm, ref_norm, 1e-4, 'gradient norm')
        _within_tree_scale(got['params'], ref['params'], 1e-4)
        _within_tree_scale(_jax_layout(got['params'], hifigan_to_jax), ref['jax']['gen'], 1e-4)
        for key, value in flatten_tree(got['params']).items():
            np.testing.assert_array_equal(value, flatten_tree(ranks[0]['fit_gan']['params'])[key])
