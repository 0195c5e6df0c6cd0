"""The port's mesh (`parallel`), its collectives, the WaveGlow pipeline and
expert parallelism, against the JAX package on the CPU.

The layout and error cases of the JAX package's ``tests/test_parallel.py``
run as plain cases: a mesh without a process group is a layout, sliced for
its ``rank``.  The rest runs once, in one job of four gloo ranks on the CPU
(`parallel.spawn`, one module fixture; `torch_port_mesh_workers.
parallel_cases`), while the test process computes the references:

  - the mesh: each rank's coordinates and groups; all-reduce over ``dp``
    and over ``pp`` (bfloat16 too); `shard_params` broadcasting the first
    rank's tree (the others pass None) and sending each rank its slice; the
    differentiable all-reduce and row gather (each rank's gradient the sum
    of every rank's); `batch_draw` giving each rank its rows of the whole
    batch's draw; no rank loads JAX;
  - the pipeline: the pipelined NLL on ``{'pp': 4}`` within 1e-5 of the
    JAX package's `arch.loss` and of the port's, its gradients within 1e-4
    (``tests/test_parallel.py:104-108``); one SGD step on ``{'dp': 2,
    'pp': 2}`` within 1e-5 of the one-process step;
  - `fit` on ``{'dp': 2, 'pp': 2}`` (the pipeline's route, 2 microbatches):
    the weights within 1e-5 of one Adam step of the JAX package's and the
    port's train step on the same batch, bit-equal on every rank, the mesh
    in the history, checkpoints written by the first rank only;
  - a mixture-of-experts `Transformer` on ``{'dp': 2, 'ep': 2}``: each rank
    holds 2 of the 4 experts a layer, its rows' logits (forward and
    KV-cached decode) within 1e-5 of the JAX package's unsharded logits
    (``tests/test_transformers.py:225-226``), equal on the two ep ranks, and
    the load-balancing loss replicated.
"""

import collections
import threading

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
import torch_port_mesh_workers as workers

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models.transformers import transformer_arch as jax_transformer
from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
from text_to_speech_tpu.train import optimizers as jax_optimizers
from text_to_speech_tpu.train import trainer as jax_trainer
from text_to_speech_tpu.train.losses import WaveGlowLoss as JaxWaveGlowLoss
from text_to_speech_tpu_torch import parallel
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.transformers import Transformer
from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.parallel import P
from text_to_speech_tpu_torch.parallel.pipeline import stage_bounds
from text_to_speech_tpu_torch.train import trainer
from text_to_speech_tpu_torch.train.datasets import prepare_dataset
from text_to_speech_tpu_torch.train.losses import get_loss
from text_to_speech_tpu_torch.train.optimizers import get_optimizer
from text_to_speech_tpu_torch.weights import (
    flatten_tree, transformer_from_jax, waveglow_from_jax, waveglow_to_jax)

#: ``tests/test_parallel.py``'s pipeline WaveGlow
WG_PP = dict(n_flows = 4, n_early_every = 2, n_early_size = 1, n_group = 4, wn_layers = 2,
             wn_channels = 16, upsample_width = 16, upsample_stride = 8)
#: a WaveGlow task model that `fit` trains at the model's hop (256)
WG_FIT = dict(n_mel_channels = 8, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 2, wn_channels = 16, upsample_width = 1024,
              upsample_stride = 256)
MOE = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 4, n_kv_heads = 2, ffn_dim = 64,
           max_position = 40, positional = 'rope', norm = 'rms', gated_ffn = True,
           ffn_activation = 'silu', use_bias = False, tie_embeddings = False, n_experts = 4,
           n_experts_per_token = 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_jax_layout(tree):
    """A port WaveGlow tree of numpy arrays in the JAX package's layout."""
    return waveglow_to_jax(jax.tree_util.tree_map(torch.from_numpy, tree))


def _rows(n, seed = 2):
    rng = np.random.default_rng(seed)
    return [{'audio': (0.3 * rng.standard_normal(4096 + 300 * i)).astype(np.float32),
             'rate': 22050} for i in range(n)]


def _close(out, ref, tol, what = ''):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol = 0, atol = tol * max(np.abs(ref).max(), 1.),
                               err_msg = what)


@pytest.fixture(scope = 'module')
def job(tmp_path_factory):
    """The four ranks' results and the references, computed meanwhile."""
    rng = np.random.default_rng(0)
    arch = WaveGlow(** WG_PP)
    wg_params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    mel = (rng.standard_normal((4, 16, 80)) * 2. - 6.).astype(np.float32)
    audio = rng.standard_normal((4, 16 * 8)).astype(np.float32)
    fit_arch = WaveGlow(** WG_FIT)
    fit_params = init_waveglow(fit_arch.hp, fit_arch.flow_channels, seed = 1)
    rows = _rows(4)
    moe_params = _np(jax_transformer.Transformer(** MOE).init(jax.random.PRNGKey(3)))
    tokens = rng.integers(1, 64, (4, 6))
    case = {
        'waveglow': {'config': WG_PP, 'params': waveglow_from_jax(wg_params), 'mel': mel,
                     'audio': audio},
        'fit': {'config': WG_FIT, 'params': fit_params, 'rows': rows,
                'root': str(tmp_path_factory.mktemp('pp_fit'))},
        'moe': {'config': MOE, 'params': transformer_from_jax(moe_params), 'tokens': tokens},
    }
    box = {}

    def run():
        try:
            box['ranks'] = parallel.spawn(workers.parallel_cases, 4, backend = 'gloo',
                                          device = 'cpu', args = (case,))
        except BaseException as e:                   # raised in the test below
            box['error'] = e

    thread = threading.Thread(target = run)
    thread.start()
    refs = {}
    try:
        # the pipeline's references: JAX and the port on one process
        jarch = JaxWaveGlow(** WG_PP)
        jparams = jax.tree_util.tree_map(jnp.asarray, wg_params)
        loss, grads = jax.value_and_grad(jarch.loss)(jparams, jnp.asarray(mel),
                                                     jnp.asarray(audio))
        refs['jax_loss'], refs['jax_grads'] = float(loss), _np(grads)
        params = workers.trainable(waveglow_from_jax(wg_params))
        loss = arch.loss(params, torch.from_numpy(mel), torch.from_numpy(audio))
        loss.backward()
        refs['port_loss'], refs['port_grads'] = float(loss.detach()), workers.grads(params)
        params = workers.trainable(waveglow_from_jax(wg_params))
        tx = get_optimizer('sgd', lr = 1e-3)
        opt = tx.init(params)
        loss = arch.loss(params, torch.from_numpy(mel), torch.from_numpy(audio))
        loss.backward()
        opt.step()
        refs['sgd_params'] = workers.to_numpy(params)
        refs['fit'] = _fit_references(fit_params, rows, tmp_path_factory.mktemp('pp_ref'))
        jmodel = jax_transformer.Transformer(** MOE)
        refs['moe_logits'] = np.asarray(jmodel.decode(moe_params, jnp.asarray(tokens))[0])
        model = Transformer(** MOE)
        with torch.no_grad():
            refs['port_moe_logits'] = model.decode(transformer_from_jax(moe_params),
                                                   torch.from_numpy(tokens))[0].numpy()
    finally:
        thread.join()
    if 'error' in box:
        raise box['error']
    return box['ranks'], refs


def _fit_references(params, rows, root):
    """One Adam step (lr 1e-4) of the JAX package's and of the port's train
    step on the batch `fit` makes of `rows`."""
    task = WaveGlowTask.from_jax(params, device = 'cpu', name = 'wg_ref', root = str(root),
                                 ** WG_FIT)
    ds = prepare_dataset(rows, prepare_fn = task.prepare_data,
                         filter_fn = getattr(task, 'filter_data', None),
                         collate_fn = task.collate, batch_size = 4, shuffle = False,
                         length_bucket_fn = trainer._item_length, seed = 0)
    batches = [trainer.bucket_pad(b, task) for b in ds]
    assert len(batches) == 1
    inputs, targets = batches[0]
    loss_fn = get_loss(task._default_loss)
    tx = get_optimizer('adam', lr = 1e-4)
    leaves = trainer._trainable(task.params)
    step = trainer.make_train_step(task, loss_fn, tx)
    leaves, _, _, metrics = step(leaves, task.state, tx.init(leaves), torch.Generator(),
                                 trainer._to_device(inputs, 'cpu'),
                                 trainer._to_device(targets, 'cpu'))
    from text_to_speech_tpu.models.tts.waveglow import WaveGlow as JaxTask
    jtask = object.__new__(JaxTask)
    jtask.arch = JaxWaveGlow(** WG_FIT)
    jtx = jax_optimizers.get_optimizer('adam', lr = 1e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstep = jax_trainer.make_train_step(jtask, JaxWaveGlowLoss(sigma = loss_fn.sigma), jtx)
    jparams, _, _, jmetrics = jstep(jparams, {}, jtx.init(jparams), jax.random.PRNGKey(0),
                                    inputs, targets)
    return {'port': workers.to_numpy(leaves), 'port_loss': float(metrics['loss']),
            'jax': _np(jparams), 'jax_loss': float(jmetrics['loss'])}


# -- the layout and its errors, without a process group ----------------------------

def test_create_mesh_layout_and_coverage():
    mesh = parallel.create_mesh({'dp': 2, 'tp': -1}, devices = range(8), rank = 5)
    assert dict(mesh.shape) == {'dp': 2, 'tp': 4}
    assert mesh.coords == {'dp': 1, 'tp': 1} and mesh.size == 8
    assert mesh.axis_index(('dp', 'tp')) == 5 and mesh.axis_size('dp') == 2
    assert mesh.axis_size('pp') == 1 and mesh.axis_index('pp') == 0
    with pytest.raises(ValueError, match = 'does not cover'):
        parallel.create_mesh({'dp': 3}, devices = range(8))
    with pytest.raises(ValueError, match = 'not in the mesh'):
        parallel.create_mesh({'dp': 2}, devices = [0, 1], rank = 4)
    assert [d.id for d in parallel.get_devices('cpu')] == [0]
    with pytest.raises(ValueError, match = 'Requested 2 devices'):
        parallel.get_devices('cpu', count = 2)
    with pytest.raises(RuntimeError, match = 'process group'):
        mesh.group('dp')


def test_axis_layout():
    """``tests/test_parallel.py``'s hybrid layout: dcn outermost, each dcn
    slab a contiguous block of ranks."""
    mesh = parallel.create_hybrid_mesh({'dp': 2, 'tp': 2}, {'dcn': 2}, devices = range(8))
    assert tuple(mesh.axis_names) == ('dcn', 'dp', 'tp')
    assert dict(mesh.shape) == {'dcn': 2, 'dp': 2, 'tp': 2}
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert sorted(ids[0].ravel().tolist()) == [0, 1, 2, 3]
    assert sorted(ids[1].ravel().tolist()) == [4, 5, 6, 7]
    assert parallel.data_axes(mesh) == ('dcn', 'dp')
    assert parallel.data_size(mesh) == 4


def test_coverage_validation():
    with pytest.raises(ValueError):
        parallel.create_hybrid_mesh({'dp': 3}, {'dcn': 2}, devices = range(8))
    with pytest.raises(ValueError, match = 'both dcn and ici'):
        parallel.create_hybrid_mesh({'dp': 2, 'dcn': 2}, {'dcn': 2}, devices = range(8))


def test_stage_bounds():
    assert stage_bounds(12, 4) == [0, 3, 6, 9, 12]
    assert stage_bounds(12, 3) == [0, 4, 8, 12]
    assert stage_bounds(5, 2) == [0, 3, 5]
    with pytest.raises(ValueError):
        stage_bounds(2, 3)


def test_shard_and_pad_batch_take_the_rank_rows():
    batch = (np.arange(6 * 2).reshape(6, 2), np.arange(5), np.float32(3.))
    mesh = parallel.create_hybrid_mesh({'dp': 2, 'tp': 2}, {'dcn': 2}, devices = range(8),
                                       rank = 6)                  # dcn 1, dp 1, tp 0
    padded = parallel.pad_batch_to_devices(batch, mesh, axis = ('dcn', 'dp'))
    assert padded[0].shape == (8, 2) and padded[1].shape == (8,)
    np.testing.assert_array_equal(padded[0][6:], np.repeat(batch[0][-1:], 2, axis = 0))
    np.testing.assert_array_equal(padded[1][5:], [4, 4, 4])
    assert parallel.pad_batch_to_devices(batch, mesh, multiple = 3)[1].shape == (6,)
    rows = parallel.shard_batch(padded, mesh, axis = ('dcn', 'dp'))
    np.testing.assert_array_equal(rows[0], padded[0][6:8])         # shard 3 of 4
    np.testing.assert_array_equal(rows[1], padded[1][6:8])
    assert rows[2] == np.float32(3.)
    # a leading dim that does not divide stays whole; a missing axis replicates
    np.testing.assert_array_equal(parallel.shard_batch(batch, mesh, ('dcn', 'dp'))[1],
                                  batch[1])
    np.testing.assert_array_equal(parallel.shard_batch(batch, mesh, 'pp')[0], batch[0])
    assert parallel.place(padded, parallel.replicated(mesh))[0].shape == (8, 2)
    assert parallel.batch_sharding(mesh, ('dcn', 'dp')).axes == ('dcn', 'dp')


def test_moe_param_specs_and_layout_only_slices():
    params = Transformer(** MOE).init(0, device = 'cpu')
    specs = parallel.moe_param_specs(params)
    flat = flatten_tree(specs)
    sharded = sorted(k for k, v in flat.items() if v != P())
    assert len(sharded) == 2 * 3 and all('/experts/' in k for k in sharded)
    assert all(flat[k] == P('ep', None, None) for k in sharded)
    mesh = parallel.create_mesh({'ep': 2}, devices = [0, 1], rank = 1)
    local = parallel.shard_params(params, mesh, parallel.moe_param_specs)
    w = params['layer_1']['ffn']['experts']['up']['weight']
    torch.testing.assert_close(local['layer_1']['ffn']['experts']['up']['weight'], w[2:])
    torch.testing.assert_close(local['embedding']['weight'], params['embedding']['weight'])


def test_backends_refuse_what_they_cannot_run():
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match = 'one rank a card'):
            parallel.spawn(workers.spawned_child_modules, 2, backend = 'nccl', device = 'cuda')
    with pytest.raises(ValueError, match = 'gloo'):
        parallel.check_backend('mpi', 1)


# -- the four-rank job --------------------------------------------------------------

def test_mesh_groups_and_collectives(job):
    ranks, _ = job
    assert [r['rank'] for r in ranks] == [0, 1, 2, 3]
    assert all(r['modules'] == [] for r in ranks)
    assert [r['coords'] for r in ranks] == [{'dp': 0, 'pp': 0}, {'dp': 0, 'pp': 1},
                                            {'dp': 1, 'pp': 0}, {'dp': 1, 'pp': 1}]
    assert ranks[1]['group_ranks'] == {'dp': [1, 3], 'pp': [0, 1]}
    assert all(r['device'] == 'cpu' for r in ranks)
    assert [r['dp_sum'][0] for r in ranks] == [4., 6., 4., 6.]
    assert all(r['pp_sum_bf16'] == [3., 3., 3.] for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r['replicated']['w'], np.arange(12.).reshape(4, 3))
        np.testing.assert_array_equal(r['replicated']['n']['i'], np.arange(3))
        dp = r['coords']['dp']
        np.testing.assert_array_equal(r['sliced']['w'],
                                      np.arange(12.).reshape(4, 3)[2 * dp: 2 * dp + 2])
        assert r['sum_value'] == [10., 10.] and r['sum_grad'] == [10., 10.]
        # the rows of ranks (dp 0, dp 1) of the rank's pp column
        column = [1. + r['coords']['pp'], 3. + r['coords']['pp']]
        assert r['gathered'] == [column[0]] * 2 + [column[1]] * 2
        # d/dx of sum(g * [1, 2, 3, 4]) summed over the two ranks of the dp group
        assert r['gather_grad'] == ([2., 4.] if dp == 0 else [6., 8.])
        whole = torch.rand((4, 3), generator = torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_array_equal(r['drawn'], whole[2 * dp: 2 * dp + 2])


def test_pipeline_loss_and_grads_match_jax(job):
    ranks, refs = job
    for r in ranks:
        for ref in (refs['jax_loss'], refs['port_loss']):
            assert abs(r['pp_loss'] - ref) < 1e-5 * max(1., abs(ref))
    jax_grads = flatten_tree(refs['jax_grads'])
    for r in ranks:
        got = flatten_tree(_to_jax_layout(r['pp_grads']))
        assert sorted(got) == sorted(jax_grads)
        for key, ref in jax_grads.items():
            np.testing.assert_allclose(got[key], ref, atol = 1e-4, rtol = 1e-4, err_msg = key)
    port = flatten_tree(refs['port_grads'])
    for key, value in flatten_tree(ranks[0]['pp_grads']).items():
        np.testing.assert_allclose(value, port[key], atol = 1e-4, rtol = 1e-4, err_msg = key)


def test_pipeline_dp_composed_sgd_step(job):
    ranks, refs = job
    for r in ranks:
        assert abs(r['pp_dp_loss'] - refs['port_loss']) < 1e-5 * max(1., abs(refs['port_loss']))
        for key, ref in flatten_tree(refs['sgd_params']).items():
            np.testing.assert_allclose(flatten_tree(r['pp_dp_params'])[key], ref, atol = 1e-5,
                                       rtol = 0, err_msg = key)


def test_fit_on_dp_and_pp_matches_one_process(job):
    ranks, refs = job
    fit = refs['fit']
    assert abs(fit['port_loss'] - fit['jax_loss']) < 1e-5 * max(1., abs(fit['jax_loss']))
    jax_params = flatten_tree(fit['jax'])
    port = flatten_tree(fit['port'])
    first = flatten_tree(ranks[0]['fit_params'])
    for r in ranks:
        assert abs(r['fit_loss'][0] - fit['jax_loss']) < 1e-5 * max(1., abs(fit['jax_loss']))
        assert r['fit_mesh'] == str(ranks[0]['fit_mesh'])
        for key, value in flatten_tree(r['fit_params']).items():
            np.testing.assert_array_equal(value, first[key])       # replicated, bit-equal
    # the JAX package records str(mesh.shape), an OrderedDict there too
    assert ranks[0]['fit_mesh'] == str(collections.OrderedDict([('dp', 2), ('pp', 2)]))
    for key, value in flatten_tree(_to_jax_layout(ranks[0]['fit_params'])).items():
        np.testing.assert_allclose(value, jax_params[key], atol = 1e-5, rtol = 0, err_msg = key)
    for key, value in first.items():
        np.testing.assert_allclose(value, port[key], atol = 1e-5, rtol = 0, err_msg = key)
    assert [r['fit_wrote'] for r in ranks] == [True, False, False, False]


def test_moe_expert_parallel_logits_match_jax(job):
    ranks, refs = job
    assert all(r['n_local_experts'] == 2 for r in ranks)
    # ranks 0, 1: dp shard 0 (ep 0, 1); ranks 2, 3: dp shard 1
    for r in ranks:
        np.testing.assert_array_equal(r['moe_logits'], ranks[r['rank'] ^ 1]['moe_logits'])
        assert r['moe_aux_loss'] == ranks[r['rank'] ^ 1]['moe_aux_loss']
    logits = np.concatenate([ranks[0]['moe_logits'], ranks[2]['moe_logits']])
    _close(logits, refs['moe_logits'], 1e-5, 'logits against JAX')
    _close(logits, refs['port_moe_logits'], 1e-5, 'logits against one process')
    cached = np.concatenate([ranks[0]['moe_cached'], ranks[2]['moe_cached']])
    _close(cached, refs['moe_logits'], 1e-5, 'cached decode against JAX')
    np.testing.assert_array_equal(cached.argmax(-1), refs['moe_logits'].argmax(-1))


def test_mixtral_state_dict_on_a_device_converts_as_the_numpy_route():
    """The card's expert-parallel run draws its Mixtral on the device
    (`init.mixtral_state_dict(device=)`) and converts it there
    (`families.mixtral_from_state_dict`): the same layout the numpy route
    reaches through `convert_mixtral_state_dict` and `transformer_from_jax`,
    and the stack runs on it."""
    from text_to_speech_tpu_torch.init import mixtral_state_dict
    from text_to_speech_tpu_torch.models.transformers import families
    kw = dict(vocab_size = 64, hidden_size = 32, intermediate_size = 48, num_hidden_layers = 2,
              num_attention_heads = 4, num_key_value_heads = 2, num_local_experts = 4)
    sd = mixtral_state_dict(3, device = 'cpu', ** kw)
    assert sorted(sd) == sorted(mixtral_state_dict(3, ** kw))
    params = families.mixtral_from_state_dict(sd, 4, 2)
    ref = transformer_from_jax(families.convert_mixtral_state_dict(
        {k: v.numpy() for k, v in sd.items()}, n_heads = 4, n_kv_heads = 2))
    flat, flat_ref = flatten_tree(params), flatten_tree(ref)
    assert sorted(flat) == sorted(flat_ref)
    for key, value in flat.items():
        torch.testing.assert_close(value, flat_ref[key], rtol = 0, atol = 0)
    model = Transformer(** families.mixtral_config(
        vocab_size = 64, dim = 32, ffn_dim = 48, n_layers = 2, n_heads = 4, n_kv_heads = 2,
        n_experts = 4))
    with torch.no_grad():
        logits, _ = model.decode(params, torch.tensor([[3, 5, 7]]))
    assert logits.shape == (1, 3, 64) and torch.isfinite(logits).all()
