"""Training loop: the train and eval steps, and the epoch loop `fit`.

Counterpart of ``text_to_speech_tpu/train/trainer.py`` for the task
models the port trains: WaveGlow, Tacotron-2 (and SV2TTS) by teacher
forcing, FastSpeech-2 and the speaker encoder (GE2E).  The train step is
forward, loss, ``backward`` and the optimizer's update; the parameters are leaf tensors that the optimizer
updates in place (where the JAX step returns new arrays), which keeps one
copy of them and of the Adam moments on the device.  `fit` resumes from
``model.epochs`` with the optimizer state checkpointed beside the weights
(when its configuration is unchanged), checkpoints every epoch (on a
background writer thread with `async_checkpointing`, the default), keeps
the best one by `monitor`, stops early and on a non-finite loss.

On a `parallel.Mesh` (one process per device; every rank calls `fit` with
the same arguments) the training is data parallel over the mesh's data
axes (``dcn``, ``dp``): each batch pads to a multiple of the data shards
(× the microbatches with a pipeline), each rank takes its rows, and the
gradients are averaged over the data group before the optimizer, so every
rank steps the same replicated state.  Every statistic the JAX step takes
over the global batch stays global: the forward runs inside
`parallel.collectives.batch_shard`, where batch-norm statistics and the
masked means of the losses all-reduce their sums and counts, the GE2E
embeddings are gathered whole, and every random draw is the rank's rows of
the whole batch's draw.  Other axes (``tp``, ``sp``, ``ep``) leave the
step replicated over them.  A ``pp`` axis with a `WaveGlowLoss` trains
through `parallel.pipeline.WaveGlowPipeline`.  History, checkpoints and
their files are written by the mesh's first rank only.
"""

import contextlib
import logging
import sys
import time

import numpy as np
import torch

from ..devices import default_device
from ..parallel import collectives, data_axes, pad_batch_to_devices, shard_batch, shard_params
from ..utils.sequence_utils import pad_to_multiple
from ..weights import flatten_tree
from .checkpoint import AsyncCheckpointSaver
from .datasets import Dataset, GE2EDataset, prepare_dataset, train_test_split
from .losses import get_loss
from .optimizers import get_optimizer, global_norm
from .precision import cast_floating, compute_dtype as policy_dtype, get_policy

logger = logging.getLogger(__name__)

def data_shard(mesh):
    """(group, index, n): this rank's shard of the batch over the mesh's
    data axes, or None without a mesh or with one shard."""
    if mesh is None:
        return None
    axes = data_axes(mesh)
    n = mesh.axis_size(axes)
    if n == 1:
        return None
    return mesh.group(axes), mesh.axis_index(axes), n


def _sharded(shard):
    return collectives.batch_shard(* shard) if shard is not None else contextlib.nullcontext()


def _mean_metrics(metrics, shard):
    """Every metric averaged over the data shards (equal rows each: the
    batch is padded to a multiple of them), in one all-reduce."""
    if shard is None or not metrics:
        return metrics
    keys = sorted(metrics)
    device = metrics[keys[0]].device
    flat = torch.stack([metrics[k].float().reshape(()).to(device) for k in keys])
    collectives.all_reduce_(flat, shard[0]).div_(shard[2])
    return dict(zip(keys, flat.unbind(0)))


def model_forward(model, params, state, inputs, *, generator = None, train = True,
                  targets = None, compute_dtype = None):
    """A padded batch through the model's architecture → (y_pred, new_state).

    `targets` gives static shapes only (FastSpeech-2's frame buffer is the
    padded mel target's length).  Under a mixed `compute_dtype`, WaveGlow
    runs its own float32-island forward (per-flow remat unless
    ``model.train_remat`` is False); every other family casts its params
    (but those under ``model.precision_exempt``) and float inputs at this
    boundary and returns float32 predictions, unless its
    ``mixed_precision_ok`` is False, which keeps it in float32."""
    from ..models.encoder.speaker_encoder import SpeakerEncoder
    from ..models.tts.fastspeech2 import FastSpeech2
    from ..models.tts.tacotron2 import Tacotron2
    from ..models.tts.waveglow import WaveGlow

    arch = model.arch
    if compute_dtype is not None and not isinstance(model, WaveGlow):
        if not getattr(model, 'mixed_precision_ok', True):
            compute_dtype = None
        else:
            params = cast_floating(params, compute_dtype,
                                   exempt = tuple(getattr(model, 'precision_exempt', ())))
            inputs = cast_floating(inputs, compute_dtype)
            preds, new_state = model_forward(model, params, state, inputs,
                                             generator = generator, train = train,
                                             targets = targets)
            return cast_floating(preds, torch.float32), new_state
    if isinstance(model, FastSpeech2):          # a Tacotron2: dispatch first
        if len(inputs) == 5:
            tokens, embeddings, durations, pitch, energy = inputs
        else:
            (tokens, durations, pitch, energy), embeddings = inputs, None
        max_frames = targets[0].shape[1] if targets is not None else None
        return arch(params, state, tokens, durations = durations, pitch = pitch,
                    energy = energy, speaker_embedding = embeddings,
                    max_frames = max_frames, train = train, generator = generator)
    if isinstance(model, WaveGlow):
        mel, audio = inputs
        return model.arch.forward(params, mel, audio,
                                  remat = getattr(model, 'train_remat', True),
                                  compute_dtype = compute_dtype), state
    if isinstance(model, SpeakerEncoder):
        mels, lengths = inputs
        n_speakers, n_utt = model.ge2e_shape
        emb, new_state = arch.forward(params, state, mels, lengths = lengths, train = train,
                                      generator = generator)
        # the loss compares every speaker with every other: the whole batch
        emb = collectives.batch_gather(emb)
        return (emb.reshape(n_speakers, n_utt, -1), params['ge2e']['w'],
                params['ge2e']['b']), new_state
    if isinstance(model, Tacotron2):
        if len(inputs) == 4:
            tokens, embeddings, mel_in, lengths = inputs
        else:
            (tokens, mel_in, lengths), embeddings = inputs, None
        return arch(params, state, tokens, mel_in, mel_lengths = lengths,
                    speaker_embedding = embeddings, train = train, generator = generator)
    raise ValueError('No forward dispatch for {}'.format(type(model).__name__))


def make_train_step(model, loss_fn, optimizer, *, mesh = None, pp_microbatches = None,
                    precision = None):
    """``train_step(params, state, opt_state, generator, inputs, targets) →
    (params, state, opt_state, metrics)``; `opt_state` is
    ``optimizer.init(params)``, and it updates `params` in place.  Metrics:
    the loss's components and the gradients' global norm (before clipping,
    after the reduce over the data shards), as device tensors.

    On a `mesh` the inputs are this rank's rows of the batch (`fit`
    shards it), except on the pipeline's route (a ``pp`` axis, a WaveGlow
    and a `WaveGlowLoss`: ``train_step.global_batch``), which takes the
    whole batch; with any other loss the pipeline's route is left, as the
    JAX package leaves it, for the data-parallel step."""
    from ..models.tts.waveglow import WaveGlow
    from .losses import WaveGlowLoss
    dtype = policy_dtype(precision)
    use_pp = mesh is not None and 'pp' in mesh.shape and isinstance(model, WaveGlow)
    if use_pp and not isinstance(loss_fn, WaveGlowLoss):
        logger.warning('pp mesh requested with a non-WaveGlowLoss loss (%s); '
                       'falling back to the unpipelined train step', type(loss_fn).__name__)
        use_pp = False
    if use_pp:
        from ..parallel.pipeline import WaveGlowPipeline
        pipe = WaveGlowPipeline(model.arch, mesh, dp_axis = 'dp' if 'dp' in mesh.shape else None,
                                n_micro = pp_microbatches or 2 * mesh.shape['pp'])
        sigma = getattr(loss_fn, 'sigma', None)

        def pp_train_step(params, state, opt_state, generator, inputs, targets):
            mel, audio = inputs
            opt_state.zero_grad()
            loss = pipe.value_and_grad(params, mel, audio, sigma, compute_dtype = dtype)
            grad_norm = global_norm([t.grad for t in opt_state.tensors if t.grad is not None])
            opt_state.step()
            return params, state, opt_state, {'loss': loss.detach(), 'grad_norm': grad_norm}

        pp_train_step.global_batch = True
        pp_train_step.pipeline = pipe
        return pp_train_step

    shard = data_shard(mesh)

    def train_step(params, state, opt_state, generator, inputs, targets):
        with _sharded(shard):
            preds, new_state = model_forward(model, params, state, inputs,
                                             generator = generator, train = True,
                                             targets = targets, compute_dtype = dtype)
            losses = loss_fn(targets, preds)
            opt_state.zero_grad()
            torch.mean(losses['loss']).backward()
        if shard is not None:
            collectives.average_gradients(opt_state.tensors, shard[0])
        grad_norm = global_norm([t.grad for t in opt_state.tensors if t.grad is not None])
        opt_state.step()
        metrics = {k: torch.mean(v.detach().float()) for k, v in losses.items()}
        metrics['grad_norm'] = grad_norm.detach()
        return params, new_state, opt_state, _mean_metrics(metrics, shard)

    train_step.global_batch = False
    return train_step


def make_eval_step(model, loss_fn, *, mesh = None, precision = None):
    """``eval_step(params, state, generator, inputs, targets) → metrics``,
    without gradients; on a `mesh` the inputs are this rank's rows and the
    metrics the whole batch's."""
    dtype = policy_dtype(precision)
    shard = data_shard(mesh)

    def eval_step(params, state, generator, inputs, targets):
        with torch.no_grad(), _sharded(shard):
            preds, _ = model_forward(model, params, state, inputs, generator = generator,
                                     train = False, targets = targets, compute_dtype = dtype)
            losses = loss_fn(targets, preds)
        return _mean_metrics({k: torch.mean(v.float()) for k, v in losses.items()}, shard)

    return eval_step


def bucket_pad(batch, model, *, token_multiple = 32, frame_multiple = 64):
    """A collated batch padded into shape buckets.  GE2E batches pass
    through (they are bucketed when collated); a model's own `bucket_pad`
    decides for it; WaveGlow pads the mel to a multiple of `frame_multiple`
    frames with ``pad_mel_value`` and pads or cuts the audio to the mel's
    samples; otherwise (Tacotron-2, SV2TTS) the tokens pad to
    `token_multiple` and the decoder inputs to `frame_multiple` steps, and
    the targets to exactly r × those steps (the reduction factor r)."""
    from ..models.tts.waveglow import WaveGlow
    inputs, targets = batch
    if hasattr(model, 'collate_ge2e'):
        return inputs, targets
    if hasattr(model, 'bucket_pad'):
        return model.bucket_pad(batch, token_multiple = token_multiple,
                                frame_multiple = frame_multiple)
    if isinstance(model, WaveGlow):
        mel, audio = inputs
        mel = pad_to_multiple(np.asarray(mel), frame_multiple, axis = 1,
                              constant_values = model.pad_mel_value)
        samples = mel.shape[1] * model.upsample_rate
        audio = np.asarray(audio)
        if audio.shape[1] < samples:
            audio = np.pad(audio, [(0, 0), (0, samples - audio.shape[1])])
        return (mel, audio[:, :samples]), targets

    pad_in, pad_out = model.get_padding_values()
    parts = list(inputs)
    parts[0] = pad_to_multiple(np.asarray(parts[0]), token_multiple, axis = 1,
                               constant_values = pad_in[0])
    mel_idx = len(parts) - 2
    parts[mel_idx] = pad_to_multiple(np.asarray(parts[mel_idx]), frame_multiple, axis = 1,
                                     constant_values = pad_in[1])
    out_len = parts[mel_idx].shape[1] * model.arch.hp.n_frames_per_step
    mel_out = pad_to_multiple(np.asarray(targets[0]), out_len, axis = 1,
                              constant_values = pad_out[0])
    gate = pad_to_multiple(np.asarray(targets[1]), out_len, axis = 1,
                           constant_values = pad_out[1])
    return tuple(parts), (mel_out, gate)


def _to_device(tree, device):
    """A batch of numpy arrays → tensors on `device`: floats as float32,
    integers (tokens, durations, lengths) as int64."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    array = np.asarray(tree)
    array = array.astype(np.int64 if array.dtype.kind in 'iub' else np.float32)
    return torch.as_tensor(array, device = device)


def _trainable(tree):
    """The parameter tree as leaf tensors that require gradients, sharing
    storage with `tree`."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _item_length(item):
    inputs = item[0] if isinstance(item, tuple) else item
    return len(inputs[0] if isinstance(inputs, tuple) else inputs)


def fit(model, data, *, valid_data = None, valid_size = 0.1, epochs = 1, batch_size = 8,
        loss = None, optimizer = 'adam', lr = 1e-3, mesh = None, shuffle = True,
        early_stopping_patience = None, monitor = 'loss', terminate_on_nan = True,
        token_multiple = 32, frame_multiple = 64, precision = None, seed = 0,
        verbose = True, async_checkpointing = True, device = None, ** kwargs):
    """Train `model` on `data` (rows that ``model.prepare_data`` reads and
    ``model.filter_data`` keeps, or a prebuilt `Dataset` / `GE2EDataset`) on
    `device`: ``cuda`` unless ``device='cpu'`` is given (the model moves
    there); without a GPU and without a device it raises.

    Resumes from ``model.epochs``; checkpoints every epoch (params in the
    JAX package's layout, and the optimizer state under its configuration's
    fingerprint); the manager keeps the best by `monitor` (on the
    validation data when there is some).  With `async_checkpointing` each
    epoch's checkpoint is written by an `AsyncCheckpointSaver` while the next
    epoch runs, and `fit` waits for the last one before it returns; an error
    on the writer's thread is raised here.  `token_multiple` goes to
    `bucket_pad`.  With ``native_audio=True`` the datasets `fit` builds
    decode the rows' WAV files on the native loader pool, resampled to the
    model's rate (`train.datasets.Dataset`'s `native_audio_rate`), and
    ``num_parallel_calls`` threads map the rows.  ``clip_norm``,
    ``weight_decay``, ``lr_scheduler`` and optax's keywords for the
    optimizer go to `get_optimizer`.  Returns ``model.history``."""
    pp_microbatches = kwargs.pop('pp_microbatches', None)
    native_rate = getattr(model, 'rate', None) if kwargs.pop('native_audio', False) else None
    num_parallel_calls = kwargs.pop('num_parallel_calls', None)
    device = default_device(device, mesh)
    model.to(device)
    loss_fn = get_loss(loss or model._default_loss)
    tx = get_optimizer(optimizer, lr = lr, ** kwargs)
    prebuilt = isinstance(data, (Dataset, GE2EDataset))
    if not prebuilt and valid_data is None and valid_size:
        data, valid_data = train_test_split(data, valid_size = valid_size,
                                            random_state = seed)
    filter_fn = getattr(model, 'filter_data', None)
    train_ds = data if prebuilt else prepare_dataset(
        data, prepare_fn = model.prepare_data, filter_fn = filter_fn,
        collate_fn = model.collate, batch_size = batch_size, shuffle = shuffle,
        length_bucket_fn = _item_length, seed = seed, num_parallel_calls = num_parallel_calls,
        native_audio_rate = native_rate)
    valid_ds = valid_data if isinstance(valid_data, (Dataset, GE2EDataset)) \
        else prepare_dataset(valid_data, prepare_fn = model.prepare_data,
                             filter_fn = filter_fn, collate_fn = model.collate,
                             batch_size = batch_size, shuffle = False,
                             native_audio_rate = native_rate) if valid_data else None

    batch_multiple, chief = None, True
    if mesh is not None:
        batch_multiple = mesh.axis_size(data_axes(mesh))
        if 'pp' in mesh.shape:
            pp_microbatches = pp_microbatches or 2 * mesh.shape['pp']
            batch_multiple *= pp_microbatches
        chief = mesh.rank == mesh.first_rank
        # every rank starts from the first rank's weights
        model.set_weights(shard_params(model.params, mesh), shard_params(model.state, mesh)
                          if model.state else model.state)
    train_step = make_train_step(model, loss_fn, tx, mesh = mesh,
                                 pp_microbatches = pp_microbatches, precision = precision)
    eval_step = make_eval_step(model, loss_fn, mesh = mesh, precision = precision)
    params, state = _trainable(model.params), model.state

    def prepare(batch, step_global = False):
        """A collated batch in its shape buckets, padded to the mesh's
        multiple and cut to this rank's rows, on the device."""
        inputs, targets = bucket_pad(batch, model, token_multiple = token_multiple,
                                     frame_multiple = frame_multiple)
        if mesh is not None:
            inputs, targets = pad_batch_to_devices((inputs, targets), mesh,
                                                   multiple = batch_multiple)
            if not step_global:
                inputs, targets = shard_batch((inputs, targets), mesh, axis = data_axes(mesh))
        return _to_device(inputs, device), _to_device(targets, device)
    opt_state = tx.init(params)
    generator = torch.Generator(device = device).manual_seed(seed + model.epochs)

    # saved moments only hold under the optimizer configuration that made
    # them: a changed one starts fresh
    fingerprint = repr((optimizer, lr, sorted(kwargs.items())))

    def opt_tree(host = True):
        return {** opt_state.state_arrays(host = host),
                'config': np.frombuffer(fingerprint.encode(), np.uint8).copy()}

    resumed_from = None
    if model.epochs:
        saved = (model.ckpt_manager.load(trees = ('opt',)) or {}).get('opt')
        if saved:
            saved = flatten_tree(saved)
            saved_fp = saved.pop('config', None)
            if saved_fp is None or bytes(np.asarray(saved_fp, np.uint8)) != fingerprint.encode():
                logger.warning('checkpointed optimizer state was saved under another '
                               'optimizer configuration; starting fresh')
            else:
                try:
                    opt_state.load_state_arrays(saved)
                    resumed_from = model.ckpt_manager.latest_epoch
                except ValueError as err:
                    logger.warning('checkpointed optimizer state does not fit: %s; '
                                   'starting fresh', err)

    history = model.history
    history.set_config({
        'epochs': epochs, 'batch_size': batch_size, 'optimizer': str(optimizer),
        'lr': lr, 'loss': getattr(loss_fn, 'name', str(loss_fn)),
        'precision': get_policy(precision).name,
        'mesh': str(mesh.shape) if mesh is not None else None,
        'dataset': {'batches': len(train_ds), 'batch_size': batch_size},
        'valid_dataset': {'batches': len(valid_ds), 'batch_size': batch_size}
        if valid_ds is not None else None,
        'device': str(device), 'resumed_optimizer_from_epoch': resumed_from,
    })

    initial_epoch = model.epochs
    best_value, patience_left = None, early_stopping_patience
    interrupted = False
    saver = AsyncCheckpointSaver(model.ckpt_manager) if async_checkpointing and chief else None
    try:
        for epoch in range(initial_epoch, initial_epoch + epochs):
            history.on_epoch_begin(epoch)
            sums, n_batches = {}, 0
            start = time.time()
            for batch in train_ds:
                params, state, opt_state, metrics = train_step(
                    params, state, opt_state, generator,
                    * prepare(batch, train_step.global_batch))
                # read every step: the update is made in place, so a NaN step
                # must stop the loop before the next one builds on it
                metrics = {k: float(v) for k, v in metrics.items()}
                if terminate_on_nan and not np.isfinite(metrics['loss']):
                    logger.error('NaN loss at epoch %d; stopping', epoch)
                    raise FloatingPointError('NaN loss')
                history.on_batch_end(metrics)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.) + v
                n_batches += 1
            epoch_metrics = {k: v / max(n_batches, 1) for k, v in sums.items()}

            if valid_ds is not None:
                val_sums, n_val = {}, 0
                for batch in valid_ds:
                    m = eval_step(params, state, generator, * prepare(batch))
                    for k, v in m.items():
                        val_sums['val_' + k] = val_sums.get('val_' + k, 0.) + float(v)
                    n_val += 1
                epoch_metrics.update({k: v / max(n_val, 1) for k, v in val_sums.items()})

            history.on_epoch_end(epoch_metrics, epoch = epoch)
            if verbose:
                logger.info('epoch %d: %s (%.1fs)', epoch, epoch_metrics, time.time() - start)

            monitor_key = 'val_' + monitor if valid_ds is not None else monitor
            value = epoch_metrics.get(monitor_key, epoch_metrics.get(monitor))
            model.set_weights(params, state)
            if chief:
                model.save(epoch = epoch + 1, metric = value, saver = saver,
                           extra_trees = {'opt': opt_tree(host = saver is None)})

            if early_stopping_patience:
                if best_value is None or (value is not None and value < best_value):
                    best_value, patience_left = value, early_stopping_patience
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        logger.info('early stopping at epoch %d', epoch)
                        break
    except KeyboardInterrupt:
        interrupted = True
        logger.warning('training interrupted; saving the current state')
    except FloatingPointError:
        interrupted = True
    finally:
        # drain the writer whatever happened; its error reaches the caller
        # unless another one is already on its way
        exc_in_flight = sys.exc_info()[0] is not None
        model.set_weights(params, state)
        if saver is not None:
            try:
                saver.close()
            except Exception:
                if not exc_in_flight:
                    raise
                logger.exception('background checkpoint writer failed')
        if interrupted and chief:
            model.save(epoch = model.epochs, metric = None, extra_trees = {'opt': opt_tree()})
    return history
