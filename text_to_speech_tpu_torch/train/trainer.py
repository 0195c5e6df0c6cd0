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
the best one by `monitor`, stops early and on a non-finite loss.  The
`mesh` and pipeline-parallel arguments are not ported and raise.
"""

import logging
import sys
import time

import numpy as np
import torch

from ..devices import default_device
from ..utils.sequence_utils import pad_to_multiple
from ..weights import flatten_tree
from .checkpoint import AsyncCheckpointSaver
from .datasets import Dataset, GE2EDataset, prepare_dataset, train_test_split
from .losses import get_loss
from .optimizers import get_optimizer, global_norm
from .precision import cast_floating, compute_dtype as policy_dtype, get_policy

logger = logging.getLogger(__name__)

def _not_ported(mesh, pp_microbatches):
    if mesh is not None or pp_microbatches:
        raise NotImplementedError('mesh and pipeline-parallel training are not ported '
                                  'yet: the port trains on one device')


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
    the loss's components and the gradients' global norm (before clipping),
    as device tensors."""
    _not_ported(mesh, pp_microbatches)
    dtype = policy_dtype(precision)

    def train_step(params, state, opt_state, generator, inputs, targets):
        preds, new_state = model_forward(model, params, state, inputs, generator = generator,
                                         train = True, targets = targets,
                                         compute_dtype = dtype)
        losses = loss_fn(targets, preds)
        opt_state.zero_grad()
        torch.mean(losses['loss']).backward()
        grad_norm = global_norm([t.grad for t in opt_state.tensors if t.grad is not None])
        opt_state.step()
        metrics = {k: torch.mean(v.detach().float()) for k, v in losses.items()}
        metrics['grad_norm'] = grad_norm.detach()
        return params, new_state, opt_state, metrics

    return train_step


def make_eval_step(model, loss_fn, *, mesh = None, precision = None):
    """``eval_step(params, state, generator, inputs, targets) → metrics``,
    without gradients."""
    _not_ported(mesh, None)
    dtype = policy_dtype(precision)

    def eval_step(params, state, generator, inputs, targets):
        with torch.no_grad():
            preds, _ = model_forward(model, params, state, inputs, generator = generator,
                                     train = False, targets = targets, compute_dtype = dtype)
            losses = loss_fn(targets, preds)
        return {k: torch.mean(v.float()) for k, v in losses.items()}

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
    _not_ported(mesh, kwargs.pop('pp_microbatches', None))
    native_rate = getattr(model, 'rate', None) if kwargs.pop('native_audio', False) else None
    num_parallel_calls = kwargs.pop('num_parallel_calls', None)
    device = default_device(device)
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

    train_step = make_train_step(model, loss_fn, tx, precision = precision)
    eval_step = make_eval_step(model, loss_fn, precision = precision)
    params, state = _trainable(model.params), model.state
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
        'precision': get_policy(precision).name, 'mesh': None,
        'dataset': {'batches': len(train_ds), 'batch_size': batch_size},
        'valid_dataset': {'batches': len(valid_ds), 'batch_size': batch_size}
        if valid_ds is not None else None,
        'device': str(device), 'resumed_optimizer_from_epoch': resumed_from,
    })

    initial_epoch = model.epochs
    best_value, patience_left = None, early_stopping_patience
    interrupted = False
    saver = AsyncCheckpointSaver(model.ckpt_manager) if async_checkpointing else None
    try:
        for epoch in range(initial_epoch, initial_epoch + epochs):
            history.on_epoch_begin(epoch)
            sums, n_batches = {}, 0
            start = time.time()
            for batch in train_ds:
                inputs, targets = bucket_pad(batch, model, token_multiple = token_multiple,
                                             frame_multiple = frame_multiple)
                params, state, opt_state, metrics = train_step(
                    params, state, opt_state, generator, _to_device(inputs, device),
                    _to_device(targets, device))
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
                    inputs, targets = bucket_pad(batch, model, token_multiple = token_multiple,
                                                 frame_multiple = frame_multiple)
                    m = eval_step(params, state, generator, _to_device(inputs, device),
                                  _to_device(targets, device))
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
        if interrupted:
            model.save(epoch = model.epochs, metric = None, extra_trees = {'opt': opt_tree()})
    return history
