"""What each rank runs in the port's mesh tests (`parallel.spawn`).

`parallel.spawn` starts fresh interpreters that import this module to find
the function they run, so it imports torch, numpy and the port only: never
JAX, nor the JAX package, nor a test file (which import both).  Each
function runs every case of one test file on one mesh job and returns
numpy values; the test file holds them against the JAX package and
against the port's own one-process runs.
"""

import os
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

from text_to_speech_tpu_torch import parallel
from text_to_speech_tpu_torch.parallel import P, collectives


def loaded_modules():
    """The JAX modules this process has loaded (it must have none)."""
    return sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
                  or m == 'text_to_speech_tpu' or m.startswith('text_to_speech_tpu.'))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().float().cpu().numpy() if tree.is_floating_point() \
            else tree.detach().cpu().numpy()
    return tree


def trainable(tree):
    """A copy of a tensor tree as leaves that require gradients."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def grads(tree):
    if isinstance(tree, dict):
        return {k: grads(v) for k, v in tree.items()}
    return (tree.grad if tree.grad is not None else torch.zeros_like(tree)).numpy().copy()


# -- tests/test_torch_port_parallel.py: the mesh, its collectives, the pipeline, MoE --------

def parallel_cases(case):
    """Four ranks: the mesh and its collectives on {'dp': 2, 'pp': 2}; the
    WaveGlow pipeline on {'pp': 4} (loss and gradients) and on {'dp': 2,
    'pp': 2} (one SGD step); `fit` on {'dp': 2, 'pp': 2}; the MoE
    transformer on {'dp': 2, 'ep': 2}."""
    from text_to_speech_tpu_torch.models.transformers import Transformer
    from text_to_speech_tpu_torch.models.transformers.transformer_arch import \
        moe_load_balancing_loss
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
    from text_to_speech_tpu_torch.parallel.pipeline import WaveGlowPipeline
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer

    rank = dist.get_rank()
    out = {'rank': rank, 'modules': loaded_modules()}

    # the mesh and its collectives
    mesh = parallel.create_mesh({'dp': 2, 'pp': 2})
    out['coords'] = mesh.coords
    out['device'] = str(mesh.device)
    out['group_ranks'] = {a: mesh.group_ranks(a) for a in ('dp', 'pp')}
    t = torch.full((2,), float(rank + 1))
    out['dp_sum'] = collectives.all_reduce_(t, mesh.group('dp')).tolist()
    bf = torch.full((3,), 1.5, dtype = torch.bfloat16)
    out['pp_sum_bf16'] = collectives.all_reduce_(bf, mesh.group('pp')).float().tolist()
    tree = {'w': torch.arange(12.).reshape(4, 3), 'n': {'i': torch.arange(3)}} \
        if rank == 0 else None
    out['replicated'] = to_numpy(parallel.shard_params(tree, mesh))
    out['sliced'] = to_numpy(parallel.shard_params(
        tree, mesh, lambda t: {'w': P('dp'), 'n': {'i': P()}}))
    x = torch.full((2,), float(rank + 1), requires_grad = True)
    y = collectives.all_reduce_sum(x, mesh.group(mesh.axis_names))
    (y * (rank + 1)).sum().backward()
    out['sum_value'], out['sum_grad'] = y.tolist(), x.grad.tolist()
    x = torch.full((2,), float(rank + 1), requires_grad = True)
    with collectives.batch_shard(mesh.group('dp'), mesh.coords['dp'], 2):
        gathered = collectives.batch_gather(x)
        drawn = collectives.batch_draw(torch.rand, (2, 3), generator = torch.Generator()
                                       .manual_seed(0))
    (gathered * torch.arange(1., 5.)).sum().backward()
    out['gathered'], out['gather_grad'] = gathered.tolist(), x.grad.tolist()
    out['drawn'] = drawn.numpy()

    # the pipeline
    wg = case['waveglow']
    arch = WaveGlow(** wg['config'])
    mel, audio = torch.from_numpy(wg['mel']), torch.from_numpy(wg['audio'])
    pp4 = parallel.create_mesh({'pp': 4})
    params = trainable(wg['params'])
    loss = WaveGlowPipeline(arch, pp4, n_micro = 2).value_and_grad(params, mel, audio)
    out['pp_loss'], out['pp_grads'] = float(loss), grads(params)
    params = trainable(wg['params'])
    tx = get_optimizer('sgd', lr = 1e-3)
    step = WaveGlowPipeline(arch, mesh, dp_axis = 'dp', n_micro = 2).train_step(tx)
    params, _, loss = step(params, tx.init(params), mel, audio)
    out['pp_dp_loss'], out['pp_dp_params'] = float(loss), to_numpy(params)

    # fit on the pipeline: each rank's own root (the first rank writes)
    fit = case['fit']
    root = os.path.join(fit['root'], 'rank{}'.format(rank))
    task = WaveGlowTask.from_jax(fit['params'], device = 'cpu', name = 'wg_pp', root = root,
                                 ** fit['config'])
    history = task.fit(fit['rows'], epochs = 1, batch_size = 4, valid_size = 0, lr = 1e-4,
                       shuffle = False, mesh = mesh, pp_microbatches = 2, device = 'cpu',
                       async_checkpointing = False)
    out['fit_params'] = to_numpy(task.params)
    out['fit_loss'] = history.get_metric('loss')
    out['fit_mesh'] = history.trainings[-1]['config']['mesh']
    out['fit_wrote'] = os.path.exists(os.path.join(root, 'wg_pp', 'saving', 'checkpoint'))

    # expert parallelism composed with data parallelism
    moe = case['moe']
    ep = parallel.create_mesh({'dp': 2, 'ep': 2})
    model = Transformer(mesh = ep, ** moe['config'])
    params = parallel.shard_params(moe['params'] if rank == 0 else None, ep,
                                   parallel.moe_param_specs)
    out['n_local_experts'] = int(params['layer_0']['ffn']['experts']['gate']['weight'].shape[0])
    tokens = torch.from_numpy(parallel.shard_batch(moe['tokens'], ep, 'dp'))
    with torch.no_grad():
        aux = []
        logits, _ = model.decode(params, tokens, aux = aux)
        out['moe_logits'] = logits.numpy()
        out['moe_aux_loss'] = float(moe_load_balancing_loss(
            aux, model.hp.n_experts, model.hp.n_experts_per_token))
        caches = model.init_caches(tokens.shape[0], tokens.shape[1], device = 'cpu')
        first, caches = model.decode(params, tokens[:, :-1], caches = caches)
        last, _ = model.decode(params, tokens[:, -1:], caches = caches)
        out['moe_cached'] = torch.cat([first, last], dim = 1).numpy()
    return out


# -- tests/test_torch_port_dp_training.py: fit and fit_gan on data-parallel meshes ----------

def _wg_fit(case, mesh, name, rank):
    from text_to_speech_tpu_torch.models.tts import WaveGlow as WaveGlowTask
    root = os.path.join(case['root'], '{}-rank{}'.format(name, rank))
    task = WaveGlowTask.from_jax(case['params'], device = 'cpu', name = name, root = root,
                                 ** case['config'])
    history = task.fit(case['rows'], epochs = 1, batch_size = 4, valid_size = 0, lr = 1e-4,
                       shuffle = False, mesh = mesh, device = 'cpu',
                       async_checkpointing = False)
    return {'params': to_numpy(task.params), 'loss': history.get_metric('loss'),
            'mesh': history.trainings[-1]['config']['mesh'],
            'wrote': os.path.exists(os.path.join(root, name, 'saving', 'checkpoint'))}


def dp_training_cases(case):
    """Two ranks: WaveGlow `fit` on {'dp': 2} and on {'dcn': 2} × {'dp': 1};
    a Tacotron-2 train step and a VITS GAN step on {'dp': 2}, rows of unequal
    lengths on the two ranks; HiFi-GAN `fit_gan` on {'dp': 2}."""
    from text_to_speech_tpu_torch.models import hifigan_arch
    from text_to_speech_tpu_torch.models.tts import Tacotron2
    from text_to_speech_tpu_torch.train import gan, trainer
    from text_to_speech_tpu_torch.train.losses import TacotronLoss
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer

    rank = dist.get_rank()
    out = {'rank': rank, 'modules': loaded_modules()}
    # the discriminators narrowed for the CPU, as the one-process runs are
    hifigan_arch.MPD_CHANNELS, hifigan_arch.MSD_SPECS = case['mpd'], case['msd']
    dp = parallel.create_mesh({'dp': 2})
    hybrid = parallel.create_hybrid_mesh({'dp': 1}, {'dcn': 2})
    out['hybrid_axes'] = hybrid.axis_names
    out['fit_dp'] = _wg_fit(case['waveglow'], dp, 'wg_dp', rank)
    out['fit_dcn'] = _wg_fit(case['waveglow'], hybrid, 'wg_dcn', rank)

    # Tacotron-2: one Adam step on this rank's rows, and the loss the local
    # batch-norm statistics would give
    taco = case['tacotron']
    model = Tacotron2.from_pretrained(taco['name'], root = taco['root'], device = 'cpu')
    inputs, targets = parallel.shard_batch(taco['batch'], dp, 'dp')
    inputs, targets = trainer._to_device(inputs, 'cpu'), trainer._to_device(targets, 'cpu')
    params = trainer._trainable(model.params)
    tx = get_optimizer('adam', lr = 1e-3)
    step = trainer.make_train_step(model, TacotronLoss(), tx, mesh = dp)
    with torch.no_grad():
        local, _ = trainer.model_forward(model, params, model.state, inputs, targets = targets,
                                         generator = torch.Generator().manual_seed(0))
        local_loss = torch.mean(TacotronLoss()(targets, local)['loss']).reshape(1)
        collectives.all_reduce_(local_loss, dp.group('dp')).div_(2)
    params, state, _, metrics = step(params, model.state, tx.init(params),
                                     torch.Generator().manual_seed(0), inputs, targets)
    out['taco'] = {'loss': float(metrics['loss']), 'grad_norm': float(metrics['grad_norm']),
                   'local_loss': float(local_loss), 'params': to_numpy(params),
                   'state': to_numpy(state)}

    # VITS: one step of both sides, the whole batch's draws given
    vits = case['vits']
    from text_to_speech_tpu_torch.models.vits_arch import VITS
    arch = VITS(** vits['config'])
    tx_g = get_optimizer('adam', lr = 2e-4, b1 = 0.8, b2 = 0.99)
    tx_d = get_optimizer('adam', lr = 2e-4, b1 = 0.8, b2 = 0.99)
    state = gan.init_vits_train_state(arch, vits['params'], tx_g, tx_d, seed = 0)
    vstep = gan.make_vits_train_step(arch, tx_g, tx_d, mesh = dp)
    batch = trainer._to_device(parallel.shard_batch(vits['batch'], dp, 'dp'), 'cpu')
    draws = {k: torch.from_numpy(v) for k, v in vits['draws'].items()}
    with torch.no_grad(), collectives.batch_shard(dp.group('dp'), rank, 2):
        fwd = arch.train_forward(state['gen'], * batch[:4], torch.Generator(),
                                 ** {k: v[rank * 2:(rank + 1) * 2] for k, v in draws.items()})
        kl_global = float(arch.kl_loss(fwd['z_p'], fwd['logs_q'], fwd['m_p'], fwd['logs_p'],
                                       fwd['frame_mask']))
    with torch.no_grad():
        kl_local = arch.kl_loss(fwd['z_p'], fwd['logs_q'], fwd['m_p'], fwd['logs_p'],
                                fwd['frame_mask']).reshape(1)
        collectives.all_reduce_(kl_local, dp.group('dp')).div_(2)
    _, metrics = vstep(state, batch, draws = draws)
    out['vits'] = {'metrics': {k: float(v) for k, v in metrics.items()},
                   'kl_global': kl_global, 'kl_local': float(kl_local),
                   'gen': to_numpy(state['gen']), 'disc': to_numpy(state['disc'])}

    # HiFi-GAN fit_gan
    out['fit_gan'] = hifigan_fit(case['hifigan'], dp, os.path.join(
        case['hifigan']['root'], 'rank{}'.format(rank)))
    return out


def hifigan_fit(case, mesh, root):
    """One epoch of `fit_gan` on a seeded tiny HiFi-GAN (one step of 4 rows)."""
    from text_to_speech_tpu_torch.models.tts import HiFiGAN
    from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
    model = HiFiGAN.create(name = 'hifi_dp', root = root, device = 'cpu',
                           mel_fn = TacotronSTFT(** case['stft']), ** case['config'])
    history = model.fit(case['rows'], epochs = 1, batch_size = 4, frame_multiple = 8,
                        mesh = mesh, shuffle = False, device = 'cpu', verbose = False)
    return {'params': to_numpy(model.params), 'disc_loss': history.get_metric('disc_loss'),
            'gen_loss': history.get_metric('loss'),
            'grad_norms': [history.get_metric(k)[0] for k in ('disc_grad_norm', 'gen_grad_norm')],
            'mesh': history.trainings[-1]['config']['mesh']}


# -- tests/test_torch_port_mesh_serving.py: the three steppers and serve --------------------

def _drive(engine, texts, ** kwargs):
    parts = [[] for _ in texts]
    requests = [engine.submit(t, on_audio = parts[i].append, ** kwargs)
                for i, t in enumerate(texts)]
    results = [r.result.get(timeout = 120) for r in requests]
    return results, parts


def serving_cases(case):
    """Two ranks on {'dp': 2}: the Tacotron-2 stepper (streamed audio), the
    VITS stepper, the LLM stepper, `serve` over HTTP, a single request (one
    rank without rows) and a follower that fails.  Each stepper's result
    comes with this rank's `mesh_stepper` counts."""
    from text_to_speech_tpu_torch.models import get_pretrained
    from text_to_speech_tpu_torch.models.transformers import Transformer
    from text_to_speech_tpu_torch.models.tts import WaveGlow, serve
    from text_to_speech_tpu_torch.runtimes.llm_serving import make_transformer_stepper
    from text_to_speech_tpu_torch.runtimes.serving import (
        ContinuousServingEngine, MeshStepperError, make_tacotron_stepper, make_vits_stepper,
        mesh_stepper)

    rank = dist.get_rank()
    out = {'rank': rank, 'modules': loaded_modules()}
    mesh = parallel.create_mesh({'dp': 2})
    root = case['root']
    taco = get_pretrained(case['tacotron'], root = root, device = 'cpu')
    taco.arch.hp.gate_threshold = 1.1              # every request runs to max_steps
    wg = case['waveglow']
    vocoder = WaveGlow.from_jax(wg['params'], name = 'mesh_wg', device = 'cpu', root = root,
                                ** wg['config'])

    def run(stepper, fn):
        """`fn(engine)` on the controller, the follower's loop elsewhere;
        and this rank's counts of rows served."""
        if stepper[1].controller:
            with ContinuousServingEngine(* stepper, max_batch_size = 4) as engine:
                result = fn(engine)
        else:
            stepper[1].follow()
            result = None
        return result, dict(stepper[1].stats)

    # Tacotron-2 with streamed audio
    stepper = make_tacotron_stepper(taco, chunk = 4, token_multiple = 8, max_steps = 8,
                                    deterministic = True, vocoder = vocoder, stream_audio = True,
                                    stream_context = 2, stream_lookahead = 1, mesh = mesh)
    out['tacotron'], out['tacotron_rows'] = run(stepper, lambda e: _drive(e, case['texts']))
    # one request: the other rank has no rows
    stepper = make_tacotron_stepper(taco, chunk = 4, token_multiple = 8, max_steps = 8,
                                    deterministic = True, mesh = mesh)
    out['single'], out['single_rows'] = run(stepper, lambda e: _drive(e, case['texts'][:1]))

    # VITS at noise 0
    vits = get_pretrained(case['vits'], root = root, device = 'cpu')
    stepper = make_vits_stepper(vits, window = 16, context = 8, token_multiple = 8,
                                noise_scale = 0., noise_scale_w = 0., min_duration = 2,
                                mesh = mesh)
    out['vits'], out['vits_rows'] = run(stepper, lambda e: _drive(e, case['texts']))

    # the LLM stepper: greedy rows, the weights from the first rank
    llm = case['llm']
    model = Transformer(** llm['config'])
    stepper = make_transformer_stepper(model, llm['params'] if rank == 0 else None,
                                       max_batch = 4, max_length = 32, chunk = 4,
                                       prompt_multiple = 8, max_new_tokens = 6, mesh = mesh)
    out['llm'], out['llm_rows'] = run(stepper, lambda e: [
        r.result.get(timeout = 120)['tokens'] for r in
        [e.submit(p) for p in llm['prompts']]])
    out['llm_slots'] = int(stepper[1].local[1]._dev['index'].shape[0])

    # serve over HTTP on the controller
    server = serve(model = taco, vocoder = vocoder, port = 0,
                   block = False, max_batch_size = 2, chunk = 4, token_multiple = 8,
                   max_steps = 8, deterministic = True, mesh = mesh)
    if server is not None:
        import json
        import urllib.request
        try:
            request = urllib.request.Request(
                server.address + '/tts',
                data = json.dumps({'text': case['texts'][0]}).encode(),
                headers = {'Content-Type': 'application/json'})
            with urllib.request.urlopen(request, timeout = 120) as response:
                out['http'] = (response.status, response.headers.get('Content-Type'),
                               len(response.read()))
        finally:
            server.stop()
    else:
        out['http'] = 'followed'

    # a follower's failure stops the controller's engine
    def local_step(states):
        if rank == 1:
            raise RuntimeError('follower failure')
        return states, [False] * len(states)

    local = (lambda inputs, ** kw: {'inputs': inputs}, local_step, lambda st: st)
    stepper = mesh_stepper(mesh, local)
    if stepper[1].controller:
        engine = ContinuousServingEngine(* stepper, max_batch_size = 4,
                                         native_scheduler = False)
        with engine:
            requests = [engine.submit(i) for i in range(3)]
            errors = []
            for r in requests:
                try:
                    r.result.get(timeout = 60)
                except Exception as e:
                    errors.append(type(e).__name__)
            alive = engine._thread is not None and engine._thread.is_alive()
            for _ in range(100):
                if not engine._running.is_set():
                    break
                threading.Event().wait(0.05)
            out['failure'] = {'errors': errors, 'running': engine._running.is_set(),
                              'loop_alive_after_failure': alive}
    else:
        try:
            stepper[1].follow()
            out['failure'] = 'follower returned'
        except MeshStepperError as e:
            out['failure'] = 'follower raised: ' + str(e).splitlines()[0]
    return out


def spawned_child_modules():
    """For the import test: what a spawned child has loaded."""
    return {'modules': loaded_modules(), 'rank': dist.get_rank(),
            'world': dist.get_world_size(), 'threads': torch.get_num_threads()}


# -- tests/test_torch_port_tensor_parallel.py: the tp and sp axes ---------------------------

def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def _wg_loss_step(arch, params, mel, audio, mesh, lr):
    """One SGD step of `arch.loss` on this rank's slices and rows inside
    `tensor_shard(mesh)`, the gradients averaged over the data axes →
    (loss, the whole tree gathered)."""
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.weights import flatten_tree
    params = trainable(params)
    opt = get_optimizer('sgd', lr = lr).init(params)
    with collectives.tensor_shard(mesh):
        loss = arch.loss(params, mel, audio)
    loss.backward()
    collectives.average_gradients(list(flatten_tree(params).values()),
                                  mesh.group(parallel.data_axes(mesh)))
    opt.step()
    return float(loss.detach()), to_numpy(parallel.gather_params(
        _detached(params), mesh, parallel.waveglow_param_specs))


def tensor_parallel_cases(case):
    """Four ranks: WaveGlow over {'dp': 2, 'tp': 2} (infer, loss),
    {'sp': 4} (infer on the chain, on K1's and K2's plain versions, with
    noise) and {'dp': 2, 'sp': 2}, one SGD step on {'dcn': 2, 'tp': 2}; FastSpeech-2 and VITS over
    {'dp': 2, 'tp': 2}; Tacotron-2's teacher-forced loss over {'dp': 2,
    'tp': 2}; the exit's gradient against `all_reduce_sum`'s; the MoE
    transformer's gradients over {'dp': 2, 'ep': 2}."""
    from text_to_speech_tpu_torch.models.fastspeech2_arch import FastSpeech2
    from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
    from text_to_speech_tpu_torch.models.transformers import Transformer
    from text_to_speech_tpu_torch.models.vits_arch import VITS
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
    from text_to_speech_tpu_torch.train.losses import FastSpeech2Loss, TacotronLoss

    rank = dist.get_rank()
    out = {'rank': rank, 'modules': None}
    dp_tp = parallel.create_mesh({'dp': 2, 'tp': 2})
    tp = collectives.Axis.of(dp_tp, 'tp')
    rows = lambda x: torch.from_numpy(parallel.shard_batch(x, dp_tp))
    out['coords'] = dp_tp.coords

    # WaveGlow over dp × tp: infer and loss; the kernels refused
    wg = case['waveglow']
    arch = WaveGlow(** wg['config'])
    specs = parallel.waveglow_param_specs
    params = parallel.shard_params(wg['params'] if rank == 0 else None, dp_tp, specs)
    out['wg_in_conv_shape'] = tuple(params['flow_0']['block']['in_conv_0']['weight'].shape)
    with torch.no_grad(), collectives.tensor_shard(dp_tp):
        out['wg_audio'] = arch.infer(params, rows(wg['mel']), deterministic = True).numpy()
        out['wg_loss'] = float(arch.loss(params, rows(wg['mel']), rows(wg['audio'])))
        refused = []
        for kw in ({'use_kernel': True},):
            try:
                arch.infer(params, rows(wg['mel']), deterministic = True, ** kw)
            except ValueError as e:
                refused.append(str(e))
        out['wg_kernel_refused'] = refused

    # WaveGlow over sp: the time axis split four ways
    sp = parallel.create_mesh({'sp': 4})
    sp_case = case['waveglow_sp']
    sp_arch = WaveGlow(** sp_case['config'])
    sp_params = parallel.shard_params(sp_case['params'] if rank == 0 else None, sp)
    mel = torch.from_numpy(parallel.shard_sequence(sp_case['mel'], sp))
    z = torch.from_numpy(parallel.shard_sequence(sp_case['z'], sp))
    with torch.no_grad(), collectives.tensor_shard(sp):
        out['sp_halo'] = sp_arch.halo_groups
        out['sp_chain'] = sp_arch.infer(sp_params, mel, deterministic = True).numpy()
        out['sp_noise'] = sp_arch.infer(sp_params, mel, sigma = 0.7, generator =
                                        torch.Generator().manual_seed(3)).numpy()
        out['sp_z'] = sp_arch.infer(sp_params, mel, z = z).numpy()
        out['sp_k1'] = sp_arch.infer(sp_params, mel, deterministic = True,
                                     use_kernel = True).numpy()
        out['sp_k2'] = sp_arch.infer(sp_arch.quantize_kernel_params(sp_params), mel,
                                     deterministic = True, use_kernel = True).numpy()

    # the halo exchange: rows 4r..4r+3 of 0..15 on rank r, a halo of 2; the
    # backward sends each halo row's gradient to its owner
    x = torch.arange(4. * rank, 4. * rank + 4., requires_grad = True)
    ext = collectives.halo_exchange(x[None, :, None], 2, 1, collectives.Axis.of(sp, 'sp'))
    (ext[0, :, 0] * torch.arange(1., 9.)).sum().backward()
    out['halo'], out['halo_grad'] = ext[0, :, 0].tolist(), x.grad.tolist()

    # dp × sp: each rank its row's frames, the noise its part of the whole draw
    dp_sp = parallel.create_mesh({'dp': 2, 'sp': 2})
    mel = parallel.shard_sequence(parallel.shard_batch(sp_case['mel'], dp_sp), dp_sp)
    with torch.no_grad(), collectives.tensor_shard(dp_sp), \
            collectives.batch_shard(dp_sp.group('dp'), dp_sp.coords['dp'], 2):
        out['dp_sp_noise'] = sp_arch.infer(sp_params, torch.from_numpy(mel), sigma = 0.7,
                                           generator = torch.Generator().manual_seed(3)).numpy()

    # one SGD step on a hybrid mesh: the batch over dcn, the channels over tp
    hybrid = parallel.create_hybrid_mesh({'tp': 2}, {'dcn': 2})
    hybrid_rows = lambda x: torch.from_numpy(parallel.shard_batch(x, hybrid, ('dcn',)))
    local = parallel.shard_params(wg['params'] if rank == 0 else None, hybrid, specs)
    out['hybrid_loss'], out['hybrid_params'] = _wg_loss_step(
        arch, local, hybrid_rows(wg['mel']), hybrid_rows(wg['audio']), hybrid, 1e-3)

    # FastSpeech-2 over dp × tp: infer and the teacher-forced loss
    fs = case['fastspeech2']
    fs_arch = FastSpeech2(** fs['config'])
    fs_params = parallel.shard_params(fs['params'] if rank == 0 else None, dp_tp,
                                      parallel.fastspeech2_param_specs)
    fs_state = parallel.shard_params(fs['state'] if rank == 0 else None, dp_tp)
    out['fs_query_shape'] = tuple(fs_params['encoder']['layer_0']['attention']['query']
                                  ['weight'].shape)
    batch = [rows(x) for x in fs['batch']]
    with torch.no_grad(), collectives.tensor_shard(dp_tp):
        out['fs_mel'] = fs_arch.infer(fs_params, fs_state, rows(fs['tokens']).long(),
                                      max_frames = 32).mel.numpy()
        tokens, durations, pitch, energy, mel = batch
        preds, _ = fs_arch(fs_params, fs_state, tokens.long(), durations = durations,
                           pitch = pitch, energy = energy, max_frames = 32)
        out['fs_loss'] = float(torch.mean(
            FastSpeech2Loss()((mel, durations, pitch, energy), preds)['loss']))

    # VITS over dp × tp: infer at noise 0 (against JAX) and with noise
    vits = case['vits']
    v_arch = VITS(** vits['config'])
    v_params = parallel.shard_params(vits['params'] if rank == 0 else None, dp_tp,
                                     parallel.vits_param_specs)
    with torch.no_grad(), collectives.tensor_shard(dp_tp):
        v_tokens = rows(vits['tokens']).long()
        quiet = v_arch.infer(v_params, {}, v_tokens, noise_scale = 0., noise_scale_w = 0.,
                             ** vits['kw'])
        with collectives.batch_shard(dp_tp.group('dp'), dp_tp.coords['dp'], 2):
            noisy = v_arch.infer(v_params, {}, v_tokens,
                                 generator = torch.Generator().manual_seed(7), ** vits['kw'])
        # the text encoder in train mode: its dropouts' masks those of the
        # whole batch (the FFN's, on this rank's channels, its slice)
        with collectives.batch_shard(dp_tp.group('dp'), dp_tp.coords['dp'], 2):
            out['vits_encoded_train'] = v_arch.encode_text(
                v_params, v_tokens, train = True,
                generator = torch.Generator().manual_seed(8))[0].numpy()
    out['vits_quiet'] = (quiet.audio.numpy(), quiet.lengths.numpy())
    out['vits_noisy'] = (noisy.audio.numpy(), noisy.lengths.numpy())

    # Tacotron-2's teacher-forced loss over dp × tp (batch norms on the
    # whole batch), and its decode refused
    taco = case['tacotron2']
    t_arch = Tacotron2(** taco['config'])
    t_params = parallel.shard_params(taco['params'] if rank == 0 else None, dp_tp,
                                     parallel.tacotron2_param_specs)
    t_state = parallel.shard_params(taco['state'] if rank == 0 else None, dp_tp)
    out['taco_rnn_shape'] = tuple(t_params['decoder']['attention_rnn']['weight_ih'].shape)
    tokens, mel_in, lengths, mel_out, gate = [rows(x) for x in taco['batch']]
    with torch.no_grad(), collectives.tensor_shard(dp_tp), \
            collectives.batch_shard(dp_tp.group('dp'), dp_tp.coords['dp'], 2):
        preds, _ = t_arch(t_params, t_state, tokens.long(), mel_in, mel_lengths = lengths,
                          train = True, generator = torch.Generator().manual_seed(0))
        out['taco_loss'] = float(torch.mean(TacotronLoss()((mel_out, gate), preds)['loss']))
        refused = []
        for call in (lambda: t_arch.infer(t_params, t_state, tokens.long(), max_length = 4),
                     lambda: t_arch.infer_fused(t_params, t_state, tokens.long(),
                                                max_length = 4)):
            try:
                call()
            except ValueError as e:
                refused.append(str(e))
        out['taco_decode_refused'] = refused

    # the exit's backward against all_reduce_sum's, on tp: y = Σ_r x_r w_r
    w = torch.full((3,), float(tp.index + 1), requires_grad = True)
    x = torch.arange(1., 4.)
    (collectives.tp_exit(x * w, tp) * 2.).sum().backward()
    out['exit_grad'] = w.grad.tolist()
    w.grad = None
    (collectives.all_reduce_sum(x * w, tp.group) * 2.).sum().backward()
    out['all_reduce_sum_grad'] = w.grad.tolist()

    # the MoE combine: the gradients of a tiny ep forward
    moe = case['moe']
    ep = parallel.create_mesh({'dp': 2, 'ep': 2})
    model = Transformer(mesh = ep, ** moe['config'])
    local = trainable(parallel.shard_params(moe['params'] if rank == 0 else None, ep,
                                            parallel.moe_param_specs))
    logits, _ = model.decode(local, torch.from_numpy(parallel.shard_batch(moe['tokens'], ep,
                                                                          'dp')))
    (logits * torch.from_numpy(parallel.shard_batch(moe['weights'], ep, 'dp'))).sum().backward()
    out['moe_grads'] = grads(local)
    out['moe_ep'] = ep.coords['ep']
    out['modules'] = loaded_modules()
    return out
