"""Adversarial training of HiFi-GAN, Vocos and VITS.

Counterpart of ``text_to_speech_tpu/train/gan.py``.  A step is the
alternating update of the published recipe, in the JAX step's order:

  1. the discriminators' LSGAN loss on the generator's audio, detached, and
     the real audio; their optimizer updates them;
  2. the generator's loss (adversarial + feature matching + L1 mel, and for
     VITS the KL and the durations' term) against the **updated**
     discriminators; its optimizer updates it.

The parameters are leaf tensors that two optimizers from `get_optimizer`
update in place (where the JAX step returns new trees).  The generator's
parameters do not change between the two passes, so the step runs its
forward once and the discriminators read that audio detached: the result
is the JAX step's, whose two passes recompute the same forward (for VITS
from the same key, so the same alignment, windows, noise and dropout).
Both steps end in `_adversarial_update`.  While the generator's loss runs,
the discriminators' leaves are frozen, so that its backward computes no
gradient of theirs.

`fit_gan` is `fit` for these families: History, a checkpoint of the
generator side every epoch (`model.save`), the discriminators and both
optimizer states in ``<model dir>/saving/gan_state.npz``, resumed from it
(a file that does not fit is warned about and the discriminators start
fresh), the data through the model's `prepare_data` / `filter_data` /
`collate`, padded into shape buckets.

On a `parallel.Mesh` both updates are data parallel over its data axes, as
`train.trainer.fit`'s step is: each rank runs its rows of the batch, the
generator's and the discriminators' gradients are averaged over the data
group before their optimizers, VITS's masked KL, duration and SDP means
take their sums and counts over the whole batch, and its random draws are
each rank's rows of the whole batch's draws.
"""

import contextlib
import logging
import os
import time

import numpy as np
import torch

from ..devices import default_device
from ..parallel import collectives, data_axes, pad_batch_to_devices, shard_batch, shard_params
from ..utils.sequence_utils import pad_to_multiple
from ..weights import convert_tree, flatten_tree, tree_to, tree_to_jax, unflatten_tree
from .datasets import prepare_dataset
from .optimizers import _leaves, get_optimizer, global_norm
from .precision import cast_floating, compute_dtype as policy_dtype, get_policy
from .trainer import _mean_metrics, _sharded, _to_device, _trainable, data_shard

logger = logging.getLogger(__name__)


def mel_fn_from_stft(mel_stft):
    """The differentiable waveform → mel of the L1 mel term, from a
    `ops.stft.MelSTFT` (its `mel_spectrogram`)."""
    def fn(wave):
        return mel_stft.mel_spectrogram(wave)
    return fn


@contextlib.contextmanager
def _frozen(tree):
    """The leaves of `tree` without gradient while the block runs."""
    leaves = _leaves(tree)
    for t in leaves:
        t.requires_grad_(False)
    try:
        yield
    finally:
        for t in leaves:
            t.requires_grad_(True)


def _update(optimizer, loss, shard = None):
    """backward, the gradients averaged over the data shards, their
    global norm (before any clipping), step."""
    optimizer.zero_grad()
    loss.backward()
    if shard is not None:
        collectives.average_gradients(optimizer.tensors, shard[0])
    norm = global_norm([t.grad for t in optimizer.tensors if t.grad is not None])
    optimizer.step()
    return norm.detach()


def _discriminators(arch, seed, device):
    return _trainable(tree_to({'mpd': arch.init_mpd(seed), 'msd': arch.init_msd(seed + 1)},
                              device))


def init_hifigan_train_state(arch, gen_params, gen_optimizer, disc_optimizer, *, seed = 0):
    """{'gen', 'disc', 'gen_opt', 'disc_opt'}: the generator's `gen_params`
    as trainable leaves (sharing their storage), random discriminators
    seeded by `seed` on the same device, and the two optimizers bound to
    them.  `arch` is a HiFi-GAN or a Vocos."""
    gen = _trainable(gen_params)
    device = _leaves(gen)[0].device
    disc = _discriminators(arch, seed, device)
    return {'gen': gen, 'disc': disc, 'gen_opt': gen_optimizer.init(gen),
            'disc_opt': disc_optimizer.init(disc)}


def init_vits_train_state(arch, gen_params, gen_optimizer, disc_optimizer, *, seed = 0):
    """`init_hifigan_train_state` for VITS: the whole model is the generator
    side, the discriminators are its HiFi-GAN decoder's."""
    return init_hifigan_train_state(arch.generator, gen_params, gen_optimizer, disc_optimizer,
                                    seed = seed)


def _adversarial_update(arch, state, fake, real, mel_fn, cd, lambda_fm, lambda_mel,
                        extra_terms = (), clock = None, shard = None):
    """The step's two updates on one generator forward → metrics.  The
    generator's params change only at the end of the step, so its audio
    `fake` serves both passes (the JAX step recomputes it): the
    discriminators' LSGAN loss on `fake` detached and `real`, their update,
    then the generator's ``adv + lambda_fm * fm + lambda_mel * mel`` plus
    each ``weight * value`` of `extra_terms` ((name, weight, value), in
    order) against the updated discriminators, their leaves frozen, and its
    update.  `arch` holds the discriminators (`GANDiscriminators`);
    `clock`, when given, is marked after each update; `shard` (the data
    shard of `train.trainer.data_shard`) averages both sides' gradients
    and the metrics over the data group."""
    disc_loss = arch.discriminator_terms(state['disc'], fake.detach(), real, compute_dtype = cd)
    disc_norm = _update(state['disc_opt'], disc_loss, shard)
    if clock is not None: clock.mark()
    with _frozen(state['disc']):
        terms = arch.generator_terms(state['disc'], fake, real, mel_fn, compute_dtype = cd)
        gen_loss = terms['adv'] + lambda_fm * terms['fm'] + lambda_mel * terms['mel']
        for name, weight, value in extra_terms:
            terms[name] = value
            gen_loss = gen_loss + weight * value
        gen_norm = _update(state['gen_opt'], gen_loss, shard)
    if clock is not None: clock.mark()
    out = {'disc_loss': disc_loss.detach(), 'gen_loss': gen_loss.detach()}
    out.update({k: v.detach() if torch.is_tensor(v) else torch.tensor(float(v))
                for k, v in terms.items()})
    out = _mean_metrics(out, shard)
    out['disc_grad_norm'], out['gen_grad_norm'] = disc_norm, gen_norm
    return out


def make_hifigan_train_step(arch, gen_optimizer, disc_optimizer, mel_fn = None, *,
                            lambda_mel = 45., lambda_fm = 2., precision = None, mesh = None):
    """``step(state, mel, audio) → (state, metrics)`` for a HiFi-GAN or a
    Vocos `arch`; `state` from `init_hifigan_train_state`, updated in place.
    `mel_fn` (a differentiable waveform → mel) enables the L1 mel term; the
    generator's audio and `audio` are cut to the shorter.  Under
    ``precision='mixed_bfloat16'`` the generator and the discriminators run
    in bfloat16 against float32 masters; the losses are float32.  Metrics
    (device tensors): ``disc_loss``, ``gen_loss``, ``adv``, ``fm``, ``mel``,
    and each side's gradient norm.  On a `mesh`, `mel` and `audio` are this
    rank's rows of the batch."""
    cd = policy_dtype(precision)
    shard = data_shard(mesh)

    def step(state, mel, audio):
        with _sharded(shard):
            fake = arch.apply(state['gen'], mel, dtype = cd)
            n = min(fake.shape[1], audio.shape[1])
            return state, _adversarial_update(arch, state, fake[:, :n], audio[:, :n], mel_fn,
                                              cd, lambda_fm, lambda_mel, shard = shard)

    return step


def make_vits_train_step(arch, gen_optimizer, disc_optimizer, mel_fn = None, *,
                         lambda_mel = 45., lambda_fm = 2., lambda_kl = 1., lambda_dur = 1.,
                         precision = None, mesh = None):
    """``step(state, batch, generator = None, draws = None, clock = None) →
    (state, metrics)`` for a VITS `arch`: `batch` = (tokens, spec, spec_lengths,
    audio[, speaker]) tensors, the speaker a column of ids (1-D) or rows of
    embeddings (2-D); `generator` draws the noise, the dropout and the
    windows, unless `draws` gives `train_forward`'s ``eps`` / ``e_q`` /
    ``starts``; `clock` (``mark()``), when given, is marked before the
    step, after the training forward, after the discriminators' update and
    after the generator's.  The generator side's loss adds ``lambda_kl * kl +
    lambda_dur * duration`` (the SDP's NLL under `use_sdp`, else the conv
    predictor's squared log error).  Under ``precision='mixed_bfloat16'``
    the model and the discriminators run in bfloat16; the waveform target,
    the KL, the durations and the scores stay float32 and the SDP is a
    float32 island.  Metrics as `make_hifigan_train_step`'s, with ``kl``
    and ``duration``.  On a `mesh`, `batch` is this rank's rows and `draws`
    (when given) the whole batch's, of which the step takes its rows."""
    cd = policy_dtype(precision)
    shard = data_shard(mesh)

    def step(state, batch, generator = None, draws = None, clock = None):
        with _sharded(shard):
            return sharded_step(state, batch, generator, draws, clock)

    def sharded_step(state, batch, generator, draws, clock):
        if clock is not None: clock.mark()
        if draws and shard is not None:
            draws = {k: v[shard[1] * (v.shape[0] // shard[2]):
                          (shard[1] + 1) * (v.shape[0] // shard[2])] for k, v in draws.items()}
        tokens, spec, spec_lengths, audio = batch[:4]
        speaker = batch[4] if len(batch) > 4 else None
        params = state['gen']
        if cd is not None:
            params = cast_floating(params, cd)
            spec = spec.to(cd)
            if speaker is not None and speaker.dim() > 1:
                speaker = speaker.to(cd)
        kwargs = dict(draws or {})
        if speaker is not None:
            kwargs['speaker_ids' if speaker.dim() == 1 else 'speaker_embedding'] = speaker
        out = arch.train_forward(params, tokens, spec, spec_lengths, audio, generator, ** kwargs)
        if clock is not None: clock.mark()
        kl = arch.kl_loss(out['z_p'], out['logs_q'], out['m_p'], out['logs_p'],
                          out['frame_mask'])
        duration = out['duration_nll'] if out['duration_nll'] is not None \
            else arch.duration_loss(out['log_durations_hat'], out['durations'],
                                    out['token_mask'])
        return state, _adversarial_update(
            arch.generator, state, out['audio_hat'], out['audio_seg'], mel_fn, cd, lambda_fm,
            lambda_mel, (('kl', lambda_kl, kl), ('duration', lambda_dur, duration)), clock,
            shard = shard)

    return step


# -- the side state's file ------------------------------------------------------------

def _side_arrays(state):
    """The discriminators (the JAX package's layout) and both optimizer
    states as one flat dict of numpy arrays."""
    out = {'disc/' + k: v for k, v in flatten_tree(tree_to_jax(state['disc'])).items()}
    for name in ('gen_opt', 'disc_opt'):
        out.update({name + '/' + k: v for k, v in state[name].state_arrays().items()})
    return out


def save_gan_state(state, path):
    """Write `state`'s discriminators and optimizer states to `path`
    (``.npz``), through a temporary file."""
    os.makedirs(os.path.dirname(path), exist_ok = True)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as file:
        np.savez(file, ** _side_arrays(state))
    os.replace(tmp, path)


def load_gan_state(state, path):
    """Restore what `save_gan_state` wrote into `state` (in place); raises
    ValueError when the file does not fit its discriminators or optimizers."""
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    disc = {k[len('disc/'):]: v for k, v in saved.items() if k.startswith('disc/')}
    fresh = flatten_tree(tree_to_jax(state['disc']))
    if set(disc) != set(fresh) or any(disc[k].shape != fresh[k].shape for k in fresh):
        raise ValueError('the discriminators differ from the saved ones')
    opts = {}
    for name in ('gen_opt', 'disc_opt'):
        part = {k[len(name) + 1:]: v for k, v in saved.items() if k.startswith(name + '/')}
        if 'count' not in part:
            raise ValueError('no {} state'.format(name))
        opts[name] = part
    with torch.no_grad():
        for t, v in zip(_leaves(state['disc']), _leaves(convert_tree(unflatten_tree(disc)))):
            t.copy_(v)
    for name, part in opts.items():
        state[name].load_state_arrays(part)


def fit_gan(model, data, *, epochs = 1, batch_size = 8, optimizer = 'adam', lr = 2e-4,
            betas = (0.8, 0.99), mesh = None, shuffle = True, lambda_mel = 45., lambda_fm = 2.,
            lambda_kl = 1., lambda_dur = 1., use_mel_loss = True, token_multiple = 16,
            frame_multiple = 32, terminate_on_nan = True, precision = None, seed = 0,
            verbose = True, device = None, ** kwargs):
    """Train a HiFi-GAN, Vocos or VITS task model adversarially on `data`
    (rows its `prepare_data` reads) on `device` (``cuda`` unless
    ``device='cpu'``, or the `mesh`'s device for this rank).  Resumes from
    ``model.epochs``: the generator side
    from the model, the discriminators and the optimizer states from
    ``<model dir>/saving/gan_state.npz``.  Each epoch draws from a
    `torch.Generator` seeded ``seed + 1 + epoch`` (the JAX package's step
    seed ``seed + 1 + model.epochs`` at the first epoch of a run), so a run
    resumed after an epoch continues as the uninterrupted one; the rows are
    shuffled by ``seed + epoch``.  Stops on a non-finite generator loss
    (`terminate_on_nan`) and saves on `KeyboardInterrupt`.  Other keywords
    of the JAX `fit` are accepted and unused, as there.  Returns
    ``model.history``."""
    device = default_device(device, mesh)
    model.to(device)
    chief = mesh is None or mesh.rank == mesh.first_rank
    if mesh is not None:
        # every rank starts from the first rank's generator
        model.set_weights(shard_params(model.params, mesh))
    arch = model.arch
    is_vits = hasattr(arch, 'train_forward')
    tx_g = get_optimizer(optimizer, lr = lr, b1 = betas[0], b2 = betas[1])
    tx_d = get_optimizer(optimizer, lr = lr, b1 = betas[0], b2 = betas[1])
    mel_fn = mel_fn_from_stft(model.mel_fn) if use_mel_loss else None
    if is_vits:
        step = make_vits_train_step(arch, tx_g, tx_d, mel_fn, lambda_mel = lambda_mel,
                                    lambda_fm = lambda_fm, lambda_kl = lambda_kl,
                                    lambda_dur = lambda_dur, precision = precision,
                                    mesh = mesh)
        init_state = init_vits_train_state
    else:
        base = make_hifigan_train_step(arch, tx_g, tx_d, mel_fn, lambda_mel = lambda_mel,
                                       lambda_fm = lambda_fm, precision = precision,
                                       mesh = mesh)
        step = lambda state, batch, generator: base(state, * batch)
        init_state = init_hifigan_train_state

    # the dataset shuffles its n-th pass by its seed + n: from seed +
    # model.epochs, training epoch e is shuffled by seed + e, resumed or not
    train_ds = prepare_dataset(data, prepare_fn = model.prepare_data,
                               filter_fn = getattr(model, 'filter_data', None),
                               collate_fn = model.collate, batch_size = batch_size,
                               shuffle = shuffle, seed = seed + model.epochs)

    def pad_batch_shapes(batch):
        """The time and token axes padded into buckets (VITS keeps spec
        frames × hop == audio samples)."""
        if is_vits:
            tokens, spec, lengths, audio = batch[:4]
            batch = (pad_to_multiple(np.asarray(tokens), token_multiple, axis = 1,
                                     constant_values = model.blank_token_idx),
                     pad_to_multiple(np.asarray(spec), frame_multiple, axis = 1),
                     np.asarray(lengths, np.int32),
                     pad_to_multiple(np.asarray(audio), frame_multiple * arch.upsample_rate,
                                     axis = 1)) + tuple(batch[4:])
        else:
            mel, audio = batch
            batch = (pad_to_multiple(np.asarray(mel), frame_multiple, axis = 1,
                                     constant_values = model.pad_mel_value),
                     pad_to_multiple(np.asarray(audio), frame_multiple * arch.total_upsampling,
                                     axis = 1))
        if mesh is not None:
            batch = shard_batch(pad_batch_to_devices(batch, mesh, axis = data_axes(mesh)),
                                mesh, axis = data_axes(mesh))
        return _to_device(batch, device)

    state = init_state(arch, model.params, tx_g, tx_d, seed = seed)
    gan_path = os.path.join(model.folder, 'saving', 'gan_state.npz')
    if os.path.exists(gan_path):
        try:
            load_gan_state(state, gan_path)
            logger.info('resuming the discriminators and optimizer states from %s', gan_path)
        except (ValueError, KeyError) as err:
            logger.warning('%s does not match the current GAN state (%s); starting the '
                           'discriminators fresh', gan_path, err)
            state = init_state(arch, model.params, tx_g, tx_d, seed = seed)
    if mesh is not None:
        # the first rank's discriminators (seeded, or resumed) on every rank
        with torch.no_grad():
            for t, v in zip(_leaves(state['disc']), _leaves(shard_params(state['disc'], mesh))):
                t.copy_(v)

    history = model.history
    history.set_config({
        'epochs': epochs, 'batch_size': batch_size, 'optimizer': 'gan-' + str(optimizer),
        'lr': lr, 'loss': 'vits_gan' if is_vits else 'hifigan_gan',
        'precision': get_policy(precision).name,
        'mesh': str(mesh.shape) if mesh is not None else None, 'device': str(device)})

    initial_epoch = model.epochs
    interrupted = False
    try:
        for epoch in range(initial_epoch, initial_epoch + epochs):
            history.on_epoch_begin(epoch)
            generator = torch.Generator(device = device).manual_seed(seed + 1 + epoch)
            sums, n_batches = {}, 0
            start = time.time()
            for batch in train_ds:
                state, metrics = step(state, pad_batch_shapes(batch), generator)
                # read every step: the update is in place, so a non-finite
                # step must stop the loop before the next one builds on it
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics['loss'] = metrics['gen_loss']
                if terminate_on_nan and not np.isfinite(metrics['loss']):
                    logger.error('non-finite generator loss at epoch %d; stopping', epoch)
                    raise FloatingPointError('NaN loss')
                history.on_batch_end(metrics)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.) + v
                n_batches += 1
            epoch_metrics = {k: v / max(n_batches, 1) for k, v in sums.items()}
            history.on_epoch_end(epoch_metrics, epoch = epoch)
            if verbose:
                logger.info('epoch %d: %s (%.1fs)', epoch, epoch_metrics, time.time() - start)
            model.set_weights(state['gen'])
            if chief:
                model.save(epoch = epoch + 1, metric = epoch_metrics.get('loss'))
                save_gan_state(state, gan_path)
    except KeyboardInterrupt:
        interrupted = True
        logger.warning('adversarial training interrupted; saving the current state')
    except FloatingPointError:
        interrupted = True
    model.set_weights(state['gen'])
    if interrupted and chief:
        model.save(epoch = model.epochs, metric = None)
        save_gan_state(state, gan_path)
    return history
