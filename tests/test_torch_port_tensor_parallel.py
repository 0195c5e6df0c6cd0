"""The tensor and sequence axes of the port's mesh (``tp``, ``sp``), against
the JAX package's one-device results on the CPU.

The spec trees' coverage runs as plain cases: the JAX package's asserts
(``tests/test_parallel.py``) on the port's trees, and the same number of
sharded leaves, split on dimensions of the same sizes, as the JAX spec of
the JAX tree.  The rest runs once, in one job of four gloo ranks
(`parallel.spawn`, one module fixture; `torch_port_mesh_workers.
tensor_parallel_cases`), while the test process computes the references
(each JAX function compiled once, `compile_fast`).  Tolerances are
``tests/test_parallel.py``'s:

  - WaveGlow over ``{'dp': 2, 'tp': 2}``: the deterministic waveform within
    1e-5 and the NLL within 1e-5 relative; ``use_kernel`` raises;
  - WaveGlow over ``{'sp': 4}`` (four flows with early outputs): the
    deterministic waveform within 1e-5 of the JAX package's; against the
    port's one device, with noise from a generator and with a given `z`,
    1e-5, and on K1's and K2's plain versions (``use_kernel``) 1e-5 of
    their one-device routes; over ``{'dp': 2, 'sp': 2}`` with noise, 1e-5
    of the port's one device;
  - the halo exchange on ``{'sp': 4}``: each shard with its neighbours'
    edge rows and zeros past the ends, and each halo row's gradient added
    to its owner's;
  - one SGD step on ``{'dcn': 2} × {'tp': 2}``: the loss within 1e-5
    relative, every weight within 1e-5 of the JAX step's, the four ranks'
    trees equal to the bit (the replicated leaves too);
  - FastSpeech-2 over ``{'dp': 2, 'tp': 2}``: the mel within 1e-5, the
    teacher-forced loss within 1e-5 relative;
  - VITS over ``{'dp': 2, 'tp': 2}``: the audio within 1e-4 and the
    lengths equal, at noise 0 against JAX, with noise against the port's
    one process (the ranks' rows of the whole batch's draw); the text
    encoder in train mode within 1e-5 of one process (the dropout masks of
    the whole batch and, between the FFN's convs, the rank's slice);
  - Tacotron-2's teacher-forced loss over ``{'dp': 2, 'tp': 2}`` (batch
    norms on the whole batch): within 1e-5 relative of JAX's; its decodes
    raise;
  - the exit: `tp_exit`'s gradient is the local one, `all_reduce_sum`'s
    tp × it;
  - the MoE combine over ``{'dp': 2, 'ep': 2}``: every gradient of a rank's
    rows within 1e-5 of its scale of the one-process gradient (its expert
    slice for the experts).
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import compile_fast, jax_tree
import torch_port_mesh_workers as workers

import jax
import jax.numpy as jnp
from text_to_speech_tpu import parallel as jax_parallel
from text_to_speech_tpu.models.fastspeech2_arch import FastSpeech2 as JaxFastSpeech2
from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
from text_to_speech_tpu.models.transformers import transformer_arch as jax_transformer
from text_to_speech_tpu.models.vits_arch import VITS as JaxVITS
from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
from text_to_speech_tpu.train import losses as jlosses
from text_to_speech_tpu_torch import parallel
from text_to_speech_tpu_torch.init import init_fastspeech2, init_tacotron2, init_waveglow
from text_to_speech_tpu_torch.models.fastspeech2_arch import HParamsFastSpeech2
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
from text_to_speech_tpu_torch.models.transformers import Transformer
from text_to_speech_tpu_torch.models.vits_arch import VITS
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.parallel import P
from text_to_speech_tpu_torch.weights import (
    convert_tree, flatten_tree, tacotron2_from_jax, transformer_from_jax, vits_from_jax,
    waveglow_from_jax, waveglow_to_jax)

#: ``tests/test_parallel.py``'s WaveGlow, FastSpeech-2, VITS and Tacotron-2
WG_TINY = dict(n_flows = 2, n_group = 4, wn_layers = 2, wn_channels = 32,
               upsample_width = 16, upsample_stride = 8)
#: with early outputs, so that the sp noise covers every draw of `infer`
WG_SP = dict(n_flows = 4, n_early_every = 2, n_early_size = 1, n_group = 4, wn_layers = 2,
             wn_channels = 16, upsample_width = 16, upsample_stride = 8)
FS2_TINY = dict(vocab_size = 32, n_mel_channels = 8, dim = 16, n_heads = 2, encoder_layers = 1,
                decoder_layers = 1, ffn_dim = 32, variance_filters = 8, postnet_n_conv = 2,
                postnet_filters = 8, max_position = 64, max_frames = 32)
VITS_TINY = dict(vocab_size = 32, spec_channels = 9, inter_channels = 8, hidden_channels = 16,
                 filter_channels = 32, n_heads = 2, n_text_layers = 1, posterior_layers = 2,
                 flow_layers = 2, flow_wn_layers = 2, duration_filters = 16,
                 upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
                 upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
                 resblock_dilation_sizes = ((1, 2),), mpd_periods = (2,), msd_scales = 1,
                 segment_frames = 8, max_frames = 64, max_position = 128)
TACO_TINY = dict(vocab_size = 24, n_mel_channels = 8, encoder_embedding_dim = 8,
                 encoder_n_conv = 1, encoder_kernel_size = 3, prenet_sizes = (4, 4),
                 lsa_attention_dim = 4, lsa_attention_filters = 2,
                 lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                 postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                 max_decoder_steps = 16, encoder_drop_rate = 0., prenet_drop_rate = 0.,
                 postnet_drop_rate = 0.)
MOE = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 4, n_kv_heads = 2, ffn_dim = 64,
           max_position = 40, positional = 'rope', norm = 'rms', gated_ffn = True,
           ffn_activation = 'silu', use_bias = False, tie_embeddings = False, n_experts = 4,
           n_experts_per_token = 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol = 0, atol = tol * max(np.abs(ref).max(), 1.),
                               err_msg = what)


def _rel(a, b):
    return abs(a - b) / max(1., abs(b))


def _draw_biases(tree, rng):
    """Every bias leaf (zeros at init) redrawn at 0.1 N(0, 1), so that each
    split layer's bias counts; the tree itself returned."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw_biases(v, rng)
        elif k == 'bias':
            tree[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return tree


def _inputs():
    rng = np.random.default_rng(0)
    wg_params = _draw_biases(init_waveglow(WaveGlow(** WG_TINY).hp,
                                           WaveGlow(** WG_TINY).flow_channels, seed = 0), rng)
    sp_arch = WaveGlow(** WG_SP)
    sp_params = init_waveglow(sp_arch.hp, sp_arch.flow_channels, seed = 1, end_scale = 0.3)
    fs_params, fs_state = init_fastspeech2(HParamsFastSpeech2(** FS2_TINY), seed = 4)
    _draw_biases(fs_params, rng)
    t_params, t_state = init_tacotron2(Tacotron2(** TACO_TINY).hp, seed = 1)
    _draw_biases(t_params, rng)
    tokens = rng.integers(1, 24, (4, 8))
    tokens[1, 5:] = tokens[3, 6:] = 0
    mel_in = rng.standard_normal((4, 6, 8)).astype(np.float32)
    mel_in[1, 4:] = mel_in[3, 5:] = 0.
    gate = np.zeros((4, 6), np.float32)
    gate[[0, 2], -1] = 1.
    gate[1, 3:] = gate[3, 4:] = 1.
    return {
        'wg': wg_params, 'wg_mel': (rng.standard_normal((4, 16, 80)) * 2. - 6.).astype(np.float32),
        'wg_audio': rng.standard_normal((4, 16 * 8)).astype(np.float32),
        'sp': sp_params, 'sp_mel': (rng.standard_normal((2, 16, 80)) * 2. - 6.).astype(np.float32),
        'sp_z': rng.standard_normal((2, 32, 4)).astype(np.float32),
        'fs': (fs_params, fs_state), 'fs_tokens': np.tile(np.arange(1, 9, dtype = np.int32), (4, 1)),
        'fs_batch': (np.tile(np.arange(1, 9, dtype = np.int64), (4, 1)),
                     np.full((4, 8), 4, np.int64), np.zeros((4, 8), np.float32),
                     np.zeros((4, 8), np.float32), np.zeros((4, 32, 8), np.float32)),
        'vits': _draw_biases(_np(JaxVITS(** VITS_TINY).init(jax.random.PRNGKey(0))[0]), rng),
        'vits_tokens': np.tile(np.arange(1, 7, dtype = np.int64), (4, 1)),
        'taco': (t_params, t_state),
        'taco_batch': (tokens, mel_in, np.array([6, 4, 6, 5], np.int64),
                       rng.standard_normal((4, 6, 8)).astype(np.float32), gate),
        'moe': _np(jax_transformer.Transformer(** MOE).init(jax.random.PRNGKey(3))),
        'moe_tokens': rng.integers(1, 64, (4, 6)),
        'moe_weights': rng.standard_normal((4, 6, 64)).astype(np.float32),
    }


VITS_KW = dict(max_frames = 16, min_duration = 2)


@pytest.fixture(scope = 'module')
def job():
    """The four ranks' results and the references, computed meanwhile."""
    x = _inputs()
    case = {
        'waveglow': {'config': WG_TINY, 'params': waveglow_from_jax(x['wg']),
                     'mel': x['wg_mel'], 'audio': x['wg_audio']},
        'waveglow_sp': {'config': WG_SP, 'params': waveglow_from_jax(x['sp']),
                        'mel': x['sp_mel'], 'z': x['sp_z']},
        'fastspeech2': {'config': FS2_TINY, 'params': convert_tree(x['fs'][0]),
                        'state': convert_tree(x['fs'][1]), 'tokens': x['fs_tokens'],
                        'batch': x['fs_batch']},
        'vits': {'config': VITS_TINY, 'params': vits_from_jax(x['vits']),
                 'tokens': x['vits_tokens'], 'kw': VITS_KW},
        'tacotron2': {'config': TACO_TINY, 'params': tacotron2_from_jax(* x['taco'])[0],
                      'state': tacotron2_from_jax(* x['taco'])[1], 'batch': x['taco_batch']},
        'moe': {'config': MOE, 'params': transformer_from_jax(x['moe']),
                'tokens': x['moe_tokens'], 'weights': x['moe_weights']},
    }
    box = {}

    def run():
        try:
            box['ranks'] = parallel.spawn(workers.tensor_parallel_cases, 4, backend = 'gloo',
                                          device = 'cpu', args = (case,))
        except BaseException as e:                   # raised in the test below
            box['error'] = e

    thread = threading.Thread(target = run)
    thread.start()
    try:
        refs = _references(x, case)
    finally:
        thread.join()
    if 'error' in box:
        raise box['error']
    return box['ranks'], refs


def _references(x, case):
    refs = {}
    # WaveGlow: JAX's infer, loss and SGD step
    jarch = JaxWaveGlow(** WG_TINY)
    jparams = jax_tree(x['wg'])
    mel, audio = jnp.asarray(x['wg_mel']), jnp.asarray(x['wg_audio'])
    infer = lambda p, m: jarch.infer(p, m, deterministic = True)
    refs['wg_audio'] = np.asarray(compile_fast(infer, jparams, mel)(jparams, mel))
    loss_and_grad = compile_fast(jax.value_and_grad(jarch.loss), jparams, mel, audio)
    loss, grads = loss_and_grad(jparams, mel, audio)
    refs['wg_loss'] = float(loss)
    refs['wg_step'] = jax.tree_util.tree_map(lambda p, g: np.asarray(p - 1e-3 * g),
                                             jparams, grads)
    sp_arch = JaxWaveGlow(** WG_SP)
    sp_params, sp_mel = jax_tree(x['sp']), jnp.asarray(x['sp_mel'])
    infer = lambda p, m: sp_arch.infer(p, m, deterministic = True)
    refs['sp_chain'] = np.asarray(compile_fast(infer, sp_params, sp_mel)(sp_params, sp_mel))
    # the port on one device: noise, z and the kernels' plain versions
    arch = WaveGlow(** WG_SP)
    params, mel = case['waveglow_sp']['params'], torch.from_numpy(x['sp_mel'])
    with torch.no_grad():
        refs['sp_noise'] = arch.infer(params, mel, sigma = 0.7,
                                      generator = torch.Generator().manual_seed(3)).numpy()
        refs['sp_z'] = arch.infer(params, mel, z = torch.from_numpy(x['sp_z'])).numpy()
        refs['sp_k1'] = arch.infer(params, mel, deterministic = True, use_kernel = True).numpy()
        refs['sp_k2'] = arch.infer(arch.quantize_kernel_params(params), mel,
                                   deterministic = True, use_kernel = True).numpy()
    # FastSpeech-2: JAX's infer and teacher-forced loss
    fs_arch = JaxFastSpeech2(** FS2_TINY)
    fs_params, fs_state = jax_tree(x['fs'][0]), jax_tree(x['fs'][1])
    tokens = jnp.asarray(x['fs_tokens'])
    infer = lambda p, s, t: fs_arch.infer(p, s, t, max_frames = 32).mel
    refs['fs_mel'] = np.asarray(compile_fast(infer, fs_params, fs_state, tokens)(
        fs_params, fs_state, tokens))
    loss_fn = jlosses.FastSpeech2Loss()

    def fs_loss(p, s, batch):
        tokens, durations, pitch, energy, mel = batch
        preds, _ = fs_arch(p, s, tokens, durations = durations, pitch = pitch,
                           energy = energy, max_frames = 32)
        return jnp.mean(loss_fn((mel, durations, pitch, energy), preds)['loss'])

    batch = tuple(jnp.asarray(b.astype(np.int32) if b.dtype == np.int64 else b)
                  for b in x['fs_batch'])
    refs['fs_loss'] = float(compile_fast(fs_loss, fs_params, fs_state, batch)(
        fs_params, fs_state, batch))
    # VITS: JAX at noise 0, the port's one process with noise
    v_arch = JaxVITS(** VITS_TINY)
    v_params, v_tokens = jax_tree(x['vits']), jnp.asarray(x['vits_tokens'].astype(np.int32))
    infer = lambda p, t: v_arch.infer(p, {}, t, noise_scale = 0., noise_scale_w = 0.,
                                      ** VITS_KW)
    out = compile_fast(infer, v_params, v_tokens)(v_params, v_tokens)
    refs['vits_quiet'] = (np.asarray(out.audio), np.asarray(out.lengths))
    with torch.no_grad():
        out = VITS(** VITS_TINY).infer(case['vits']['params'], {},
                                       torch.from_numpy(x['vits_tokens']),
                                       generator = torch.Generator().manual_seed(7), ** VITS_KW)
    refs['vits_noisy'] = (out.audio.numpy(), out.lengths.numpy())
    with torch.no_grad():
        refs['vits_encoded_train'] = VITS(** VITS_TINY).encode_text(
            case['vits']['params'], torch.from_numpy(x['vits_tokens']), train = True,
            generator = torch.Generator().manual_seed(8))[0].numpy()
    # Tacotron-2: JAX's teacher-forced loss, batch norms on the batch
    t_arch = JaxTacotron2(** TACO_TINY)
    t_params, t_state = jax_tree(x['taco'][0]), jax_tree(x['taco'][1])
    taco_loss_fn = jlosses.TacotronLoss()

    def taco_loss(p, s, batch):
        tokens, mel_in, lengths, mel_out, gate = batch
        preds, _ = t_arch(p, s, tokens, mel_in, mel_lengths = lengths, train = True,
                          rng = jax.random.PRNGKey(0))
        return jnp.mean(taco_loss_fn((mel_out, gate), preds)['loss'])

    batch = tuple(jnp.asarray(b.astype(np.int32) if b.dtype == np.int64 else b)
                  for b in x['taco_batch'])
    refs['taco_loss'] = float(compile_fast(taco_loss, t_params, t_state, batch)(
        t_params, t_state, batch))
    # the MoE transformer: the one-process gradient of each dp half's rows
    model = Transformer(** MOE)
    refs['moe_grads'] = []
    for half in (slice(0, 2), slice(2, 4)):
        params = workers.trainable(case['moe']['params'])
        logits, _ = model.decode(params, torch.from_numpy(x['moe_tokens'][half]))
        (logits * torch.from_numpy(x['moe_weights'][half])).sum().backward()
        refs['moe_grads'].append(workers.grads(params))
    return refs


# -- the spec trees on the port's layouts -------------------------------------------

def _sharded(specs):
    return sorted(k for k, v in flatten_tree(specs).items() if any(a is not None for a in v))


def _jax_sharded(specs):
    """The leaves whose spec names an axis (``P(None, None, None)`` is
    replicated too)."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf = lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return ['/'.join(getattr(k, 'key', str(k)) for k in path)
            for path, spec in flat if any(a is not None for a in spec)]


def _split_sizes(specs, params):
    """The sizes of the sharded dimensions, leaf by leaf, sorted."""
    flat = flatten_tree(params)
    return sorted(int(flat[key].shape[dim]) for key, spec in flatten_tree(specs).items()
                  for dim, axis in enumerate(tuple(spec)) if axis is not None)


def _jax_split_sizes(specs, params):
    sizes = []
    for spec, leaf in zip(jax.tree_util.tree_leaves(
            specs, is_leaf = lambda s: isinstance(s, jax.sharding.PartitionSpec)),
            jax.tree_util.tree_leaves(params)):
        sizes += [int(np.shape(leaf)[d]) for d, a in enumerate(tuple(spec)) if a is not None]
    return sorted(sizes)


def _spec_trees(name):
    """(JAX tree, port tree, JAX spec function, port spec function)."""
    if name == 'waveglow':
        arch = WaveGlow(** WG_TINY)
        tree = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
        return tree, waveglow_from_jax(tree), jax_parallel.waveglow_param_specs, \
            parallel.waveglow_param_specs
    if name == 'fastspeech2':
        tree = init_fastspeech2(HParamsFastSpeech2(** FS2_TINY), seed = 0)[0]
        return tree, convert_tree(tree), jax_parallel.fastspeech2_param_specs, \
            parallel.fastspeech2_param_specs
    if name == 'vits':
        tree = _np(JaxVITS(** VITS_TINY).init(jax.random.PRNGKey(0))[0])
        return tree, vits_from_jax(tree), jax_parallel.vits_param_specs, \
            parallel.vits_param_specs
    tree, state = init_tacotron2(Tacotron2(** TACO_TINY).hp, seed = 0)
    return tree, tacotron2_from_jax(tree, state)[0], jax_parallel.tacotron2_param_specs, \
        parallel.tacotron2_param_specs


@pytest.mark.parametrize('name', ['waveglow', 'fastspeech2', 'vits', 'tacotron2'])
def test_spec_trees_cover_what_the_jax_specs_cover(name):
    jtree, tree, jax_specs, specs = _spec_trees(name)
    got = specs(tree)
    sharded = _sharded(got)
    assert sharded, name
    # the JAX package's asserts (tests/test_parallel.py), on the port's tree
    if name == 'waveglow':
        for part in ('in_conv', 'start', 'end'):
            assert any(part in n for n in sharded)
        assert got['flow_0']['block']['start']['weight'] == P('tp', None, None)
        assert got['flow_0']['block']['in_conv_0']['weight'] == P(None, 'tp', None)
        assert got['flow_0']['block']['cond_conv_0']['weight'] == P()
    elif name == 'fastspeech2':
        for part in ('query', 'conv1', 'conv2'):
            assert any(part in n for n in sharded)
        assert not any('predictor' in n or 'embedding' in n for n in sharded)
        block = got['encoder']['layer_0']
        assert block['attention']['query']['weight'] == P('tp', None)
        assert block['attention']['output']['weight'] == P(None, 'tp')
        assert block['conv1']['bias'] == P('tp')
    elif name == 'vits':
        assert any(n.startswith('text_encoder/') for n in sharded)
        assert any('/wn/' in n for n in sharded)
        assert got['generator']['up0']['up']['weight'] == P('tp', None, None)
        assert got['generator']['conv_pre']['weight'] == P('tp', None, None)
    else:
        assert any('decoder_rnn' in n for n in sharded)
        assert any('linear_projection' in n for n in sharded)
        assert got['decoder']['attention_rnn']['weight_hh'] == P('tp', None)
    # as many leaves split as in the JAX spec of the JAX tree, on
    # dimensions of the same sizes (the layouts map, the splits do not move)
    jspecs = jax_specs(jax_tree(jtree))
    assert len(sharded) == len(_jax_sharded(jspecs))
    assert _split_sizes(got, tree) == _jax_split_sizes(jspecs, jtree)


def test_shard_and_gather_params_round_trip_without_a_group():
    arch = WaveGlow(** WG_TINY)
    tree = waveglow_from_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0))
    mesh = parallel.create_mesh({'dp': 2, 'tp': 2}, devices = range(4), rank = 3)
    local = parallel.shard_params(tree, mesh, parallel.waveglow_param_specs)
    w = tree['flow_1']['block']['in_conv_1']['weight']
    torch.testing.assert_close(local['flow_1']['block']['in_conv_1']['weight'], w[:, 16:])
    torch.testing.assert_close(local['flow_1']['block']['start']['weight'],
                               tree['flow_1']['block']['start']['weight'][16:])
    mel = np.arange(2 * 12 * 3).reshape(2, 12, 3)
    sp = parallel.create_mesh({'sp': 4}, devices = range(4), rank = 2)
    np.testing.assert_array_equal(parallel.shard_sequence(mel, sp), mel[:, 6:9])
    with pytest.raises(ValueError, match = 'do not divide'):
        parallel.shard_sequence(mel[:, :10], sp)


# -- the four-rank job --------------------------------------------------------------

def test_ranks_hold_their_slices_and_load_no_jax(job):
    ranks, _ = job
    assert [r['rank'] for r in ranks] == [0, 1, 2, 3]
    assert all(r['modules'] == [] for r in ranks)
    for r in ranks:
        assert r['wg_in_conv_shape'] == (64, 16, 3)          # 2C out, C / tp in
        assert r['fs_query_shape'] == (8, 16)                # one head of 8 of two
        assert r['taco_rnn_shape'] == (16, 12)               # 4H / tp gate rows
        assert r['sp_halo'] == 3                             # 1 + 2 groups


def test_waveglow_dp_tp_infer_and_loss_match_jax(job):
    ranks, refs = job
    # ranks 0, 1: dp shard 0 (tp 0, 1); ranks 2, 3: dp shard 1
    for r in ranks:
        np.testing.assert_array_equal(r['wg_audio'], ranks[r['rank'] ^ 1]['wg_audio'])
        assert len(r['wg_kernel_refused']) == 1 and 'tensor-parallel' in \
            r['wg_kernel_refused'][0]
    audio = np.concatenate([ranks[0]['wg_audio'], ranks[2]['wg_audio']])
    _close(audio, refs['wg_audio'], 1e-5, 'tp infer')
    loss = (ranks[0]['wg_loss'] + ranks[2]['wg_loss']) / 2
    assert _rel(loss, refs['wg_loss']) < 1e-5


def test_waveglow_sp_infer_matches_one_device(job):
    ranks, refs = job
    for r in ranks:
        _close(r['sp_chain'], refs['sp_chain'], 1e-5, 'sp chain against JAX')
        for key in ('sp_noise', 'sp_z', 'sp_k1', 'sp_k2'):
            _close(r[key], refs[key], 1e-5, key)
        np.testing.assert_array_equal(r['sp_k1'], ranks[0]['sp_k1'])


def test_halo_exchange_and_its_backward(job):
    ranks, _ = job
    whole = np.concatenate([[0., 0.], np.arange(16.), [0., 0.]])
    weights = np.arange(1., 9.)
    for r in ranks:
        i = r['rank']
        np.testing.assert_array_equal(r['halo'], whole[4 * i: 4 * i + 8])
        # row j of rank i: its own weight, plus the weight it has in each
        # neighbour's halo
        grad = weights[2: 6].copy()
        if i > 0:
            grad[:2] += weights[6:]                  # the previous rank's right halo
        if i < 3:
            grad[2:] += weights[:2]                  # the next rank's left halo
        np.testing.assert_array_equal(r['halo_grad'], grad)


def test_waveglow_dp_sp_infer_matches_one_process(job):
    """The batch over dp and the time axis over sp at once: each rank's row
    of the whole batch's draw, its frames' part of the row's."""
    ranks, refs = job
    for r in ranks:
        np.testing.assert_array_equal(r['dp_sp_noise'], ranks[r['rank'] ^ 1]['dp_sp_noise'])
    audio = np.concatenate([ranks[0]['dp_sp_noise'], ranks[2]['dp_sp_noise']])
    _close(audio, refs['sp_noise'], 1e-5, 'dp x sp with noise')


def test_hybrid_dcn_tp_sgd_step_matches_jax(job):
    ranks, refs = job
    loss = (ranks[0]['hybrid_loss'] + ranks[2]['hybrid_loss']) / 2
    assert _rel(loss, refs['wg_loss']) < 1e-5
    first = flatten_tree(ranks[0]['hybrid_params'])
    for r in ranks[1:]:
        for key, value in flatten_tree(r['hybrid_params']).items():
            np.testing.assert_array_equal(value, first[key], err_msg = key)
    ref = flatten_tree(refs['wg_step'])
    got = flatten_tree(waveglow_to_jax(
        jax.tree_util.tree_map(torch.from_numpy, ranks[0]['hybrid_params'])))
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        np.testing.assert_allclose(value, ref[key], atol = 1e-5, rtol = 0, err_msg = key)


def test_fastspeech2_dp_tp_infer_and_loss_match_jax(job):
    ranks, refs = job
    for r in ranks:
        np.testing.assert_array_equal(r['fs_mel'], ranks[r['rank'] ^ 1]['fs_mel'])
    mel = np.concatenate([ranks[0]['fs_mel'], ranks[2]['fs_mel']])
    _close(mel, refs['fs_mel'], 1e-5, 'fs2 mel')
    loss = (ranks[0]['fs_loss'] + ranks[2]['fs_loss']) / 2
    assert _rel(loss, refs['fs_loss']) < 1e-5


@pytest.mark.parametrize('key', ['vits_quiet', 'vits_noisy'])
def test_vits_dp_tp_infer_matches(job, key):
    ranks, refs = job
    audio = np.concatenate([ranks[0][key][0], ranks[2][key][0]])
    lengths = np.concatenate([ranks[0][key][1], ranks[2][key][1]])
    np.testing.assert_array_equal(lengths, refs[key][1])
    _close(audio, refs[key][0], 1e-4, key)


def test_vits_text_encoder_dropout_in_train_mode_matches_one_process(job):
    ranks, refs = job
    encoded = np.concatenate([ranks[0]['vits_encoded_train'], ranks[2]['vits_encoded_train']])
    _close(encoded, refs['vits_encoded_train'], 1e-5, 'train-mode text encoder')


def test_tacotron2_teacher_forced_loss_matches_jax(job):
    ranks, refs = job
    for r in ranks:
        assert r['taco_loss'] == ranks[r['rank'] ^ 1]['taco_loss']
        assert len(r['taco_decode_refused']) == 2
    loss = (ranks[0]['taco_loss'] + ranks[2]['taco_loss']) / 2
    assert _rel(loss, refs['taco_loss']) < 1e-5


def test_exit_gradient_is_local_and_all_reduce_sum_gives_tp_times_it(job):
    ranks, _ = job
    for r in ranks:
        assert r['exit_grad'] == [2., 4., 6.]
        assert r['all_reduce_sum_grad'] == [4., 8., 12.]


def test_moe_expert_parallel_gradients_match_one_process(job):
    ranks, refs = job
    for r in ranks:
        ref = flatten_tree(refs['moe_grads'][r['coords']['dp']])
        for key, value in flatten_tree(r['moe_grads']).items():
            full = ref[key]
            if '/experts/' in key:
                full = full[2 * r['moe_ep']: 2 * r['moe_ep'] + 2]
            _close(value, full, 1e-5, key)
