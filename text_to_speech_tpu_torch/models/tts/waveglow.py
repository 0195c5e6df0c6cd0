"""WaveGlow task model: mel → waveform.

Counterpart of ``text_to_speech_tpu/models/tts/waveglow.py``: `infer` with
the ×256-frame padding of `compiled_infer`, and the serving modes of
`_serving_mode_flags` / `_serving_params` / `quantize_for_serving`.  On a
CUDA device (the JAX package's test is ``platform == 'tpu'``) the coupling
blocks run in a kernel: `ops.wn_block` with bf16 buffers by default, or,
after `quantize_for_serving`, `ops.wn_block_int8`, its weights quantized
once from the float32 params.  With a `validate` mel the int8 mode is
gated on its waveform SNR against the float32 chain; when the gate fails,
the vocoder serves on the float32 chain, never on the bf16 kernel.  The
kernel weights are made once and cached.

Windowed vocoding (`infer(win_len=...)`, `vocode_windowed_batch`,
`vocode_windowed_from_device`) cuts a long mel into overlapping windows,
vocodes them in batches through the same serving route and stitches the
audio with half-overlap trimming, as the JAX package does.  The windows of
a mel on the card are cut on the card.

Training (the JAX package's `BaseModel.fit` and the task's data hooks):
the model owns its mel front end (`mel_fn`, saved as ``saving/mel_fn.json``),
prepares (mel, audio) pairs from WAV files or arrays (`prepare_data`,
`collate`), and `fit` trains it with `train.trainer.fit`.  `save` writes the
JAX package's directory layout under ``<root>/<name>/`` (``config.json``,
``saving/config_models.json``, ``saving/mel_fn.json``,
``saving/history.json`` and ``saving/checkpoint/``), the params in the JAX
package's tree layout (`weights.waveglow_to_jax`).  `from_nvidia_pretrained`
imports NVIDIA's weight-normed checkpoint (`models.tts_checkpoints`) and
saves it.
"""

import logging
import math
import os

import numpy as np
import torch

from ...devices import default_device
from ...loggers import timer
from ...ops.audio_io import load_audio
from ...ops.stft import MelSTFT
from ...utils.file_utils import load_json
from ...utils.sequence_utils import pad_batch
from ...weights import tree_to, waveglow_from_jax, waveglow_to_jax
from ..base_model import TrainableModel
from ..saving import load_model_files, model_dir
from ..tts_checkpoints import (
    _load_state_dict, convert_nvidia_waveglow, remove_torch_weight_norm,
    waveglow_config_from_state_dict)
from ..waveglow_arch import WaveGlow as WaveGlowArch

logger = logging.getLogger(__name__)


class WaveGlow(TrainableModel):
    serving_pad_multiple = 256   # compiled_infer's mel shape bucket
    _default_loss = 'WaveGlowLoss'
    train_remat = True           # per-flow remat in the train step

    def __init__(self, params, *, name = 'waveglow', device = None,
                 pad_mel_value = -11., rate = 22050, mel_fn = 'TacotronSTFT',
                 root = None, max_to_keep = 3, ** arch_config):
        """`params`: the port's parameter tree (`weights.waveglow_from_jax`).
        `mel_fn`: a `MelSTFT`, its config or class name (made at `rate` with
        the model's mel channels).  `root`: the directory that `save` and
        the checkpoints write under (``<root>/<name>/``), by default the
        pretrained-models root."""
        self.name = name
        self.device = default_device(device)
        self.arch = WaveGlowArch(** arch_config)
        self.params = tree_to(params, self.device)
        self.state = {}
        self.pad_mel_value = pad_mel_value
        if isinstance(mel_fn, str) and not os.path.isfile(mel_fn):
            mel_fn = MelSTFT.create(mel_fn, sampling_rate = rate,
                                    n_mel_channels = self.arch.hp.n_mel_channels)
        self.mel_fn = MelSTFT.create(mel_fn)
        self.rate = self.mel_fn.rate
        self.folder = model_dir(name, root = root)
        self.max_to_keep = max_to_keep
        self._packed_params = None        # (params, int8, kernel params)
        self._serve_int8 = False
        self._serve_force_xla = False

    @classmethod
    def from_jax(cls, params, ** kwargs):
        """From the JAX package's params tree (numpy arrays)."""
        return cls(waveglow_from_jax(params), ** kwargs)

    @classmethod
    def load_saved(cls, name, *, root = None, device = None):
        """Load a saved WaveGlow (the JAX package's directory layout)."""
        files = load_model_files(name, root = root)
        arch = {k: v for k, v in files['architecture'].items() if k != 'architecture'}
        config = files['config'].get('config', {})
        mel_fn = load_json(os.path.join(files['dir'], 'saving', 'mel_fn.json'))
        return cls.from_jax(files['params'], name = name, device = device, root = root,
                            mel_fn = mel_fn, pad_mel_value = config.get('pad_mel_value', -11.),
                            ** arch)

    @classmethod
    def from_nvidia_pretrained(cls, checkpoint, *, name = 'waveglow', config = None,
                               root = None, device = None, ** kwargs):
        """Import an NVIDIA-layout WaveGlow checkpoint (a state dict, or a
        ``.pt`` / ``.pth`` / ``.safetensors`` file; weight norm folded, fused
        cond layers) as `name` under `root`, as the JAX package's
        `from_nvidia_pretrained` does: the sizes come from the tensors'
        shapes, `config` overrides the rest (``upsample_stride`` if not
        256); the model is saved."""
        sd = remove_torch_weight_norm(_load_state_dict(checkpoint))
        inferred = waveglow_config_from_state_dict(sd)
        inferred.update(config or {})
        model = cls.from_jax(convert_nvidia_waveglow(sd), name = name, root = root,
                             device = device, ** {** inferred, ** kwargs})
        model.save()
        return model

    # -- training ----------------------------------------------------------------

    def _weights_changed(self):
        self._packed_params = None

    def jax_trees(self):
        return {'params': waveglow_to_jax(self.params)}

    def get_saving_objects(self):
        return {'mel_fn.json': self.mel_fn}

    def prepare_data(self, data):
        """A row (WAV filename, array or dict) → (mel (F, n_mel), audio (T,)),
        numpy; the mel computed on the model's device."""
        audio = load_audio(data, self.rate)
        with torch.no_grad():
            mel = self.mel_fn(torch.as_tensor(audio, device = self.device))[0]
        return mel.cpu().numpy(), audio

    def collate(self, batch):
        """(mel, audio) pairs → ((mels, audios), audios), padded with
        `pad_mel_value` and zeros."""
        mels = pad_batch([b[0] for b in batch], self.pad_mel_value)
        audios = pad_batch([b[1] for b in batch], 0.)
        return (mels, audios), audios

    def get_padding_values(self):
        return (self.pad_mel_value, 0.)

    def get_config(self):
        return {'audio_format': 'mel', 'pad_mel_value': self.pad_mel_value}

    @property
    def upsample_rate(self):
        return self.arch.hp.upsample_stride

    def _serving_mode_flags(self):
        """(use_kernel, int8): whether the coupling blocks run in a CUDA
        kernel, and whether in the int8 one.  After a failed quality gate
        (`quantize_for_serving`) neither: the float32 chain serves."""
        use_kernel = self.device.type == 'cuda' and not self._serve_force_xla
        return use_kernel, self._serve_int8 and use_kernel

    def _serving_params(self, use_kernel, int8):
        """The params `arch.infer` wants: with the kernel weights added once
        (int8, or bf16 buffers) when a kernel runs, cached per parameter
        tree and mode."""
        if not use_kernel:
            return self.params
        cached = self._packed_params
        if cached is None or cached[0] is not self.params or cached[1] != int8:
            pack = self.arch.quantize_kernel_params if int8 else self.arch.pack_kernel_params
            self._packed_params = cached = (self.params, int8, pack(self.params))
        return cached[2]

    def quantize_for_serving(self, enable = True, *, validate = None, gate_db = 25.):
        """Serve through the int8 WN-block kernel (`ops.wn_block_int8`):
        weights quantized once to int8 with per-output-channel scales,
        activations per row inside the kernel; the params themselves are
        untouched.  Without a card the mode is recorded and the vocoder
        stays on the float32 chain, as the JAX package does off its TPU.

        With `validate` (a mel), the int8 route is held to the float32
        chain on that mel first (`serving_snr`): below `gate_db` the
        vocoder serves on the float32 chain, never on the bf16 kernel.  On
        a card any error of that run propagates.  The mode is in
        `serving_mode`, the measured SNR in `_last_serving_snr_db`."""
        self._serve_int8 = bool(enable)
        self._serve_force_xla = False
        self._packed_params = None
        if enable and validate is not None:
            if self.device.type != 'cuda':
                logger.warning('int8 validation skipped: the int8 kernel runs on a '
                               'CUDA device, this model is on %s', self.device)
                return self
            snr = self.serving_snr(validate)
            self._last_serving_snr_db = snr
            if snr < gate_db:
                logger.warning('int8 serving SNR gate FAILED (%.1f dB < %.1f dB): '
                               'serving falls back to the float32 chain', snr, gate_db)
                self._serve_int8 = False
                self._serve_force_xla = True
            else:
                logger.info('int8 serving SNR gate: %.1f dB', snr)
        return self

    @property
    def serving_mode(self):
        """'int8' | 'float32_xla' (the gate failed: float32 chain) | 'default'."""
        if self._serve_force_xla: return 'float32_xla'
        if self._serve_int8: return 'int8'
        return 'default'

    def serving_snr(self, mel, *, seed = 0):
        """Waveform SNR (dB) of the int8 route against the float32 chain on
        `mel` (F, n_mel) or (B, F, n_mel), with the same noise: the quality
        gate of `quantize_for_serving`.  The int8 route runs as the JAX
        package's gate runs it, bf16 operands and an f32 audio stream; the
        float32 chain under the caller's TF32 settings.  Needs a CUDA model:
        raises `RuntimeError` elsewhere rather than compare a route that
        never runs there.  The kernel launches at any length, so the mel is
        not padded."""
        if self.device.type != 'cuda':
            raise RuntimeError('serving_snr needs a CUDA model (the int8 WN-block '
                               'kernel); this one is on {}'.format(self.device))
        mel = torch.as_tensor(mel, dtype = torch.float32, device = self.device)
        if mel.ndim == 2: mel = mel[None]
        noise = lambda: torch.Generator(device = self.device).manual_seed(seed)
        with torch.no_grad():
            w_f = self.arch.infer(self.params, mel, generator = noise(), use_kernel = False)
            w_q = self.arch.infer(self._serving_params(True, True), mel, generator = noise(),
                                  dtype = torch.bfloat16, use_kernel = True)
        w_f, w_q = w_f.double(), w_q.double()
        signal = float((w_f ** 2).mean())
        error = float(((w_f - w_q) ** 2).mean())
        return 10. * float(np.log10(signal / max(error, 1e-20)))

    def device_vocoder_fn(self, *, sigma = None, deterministic = False,
                          dtype = None, ** _):
        """(fn, params, tag): the vocode core in the current serving mode as
        a function of device tensors, ``fn(params, mel, generator) → f32
        waveform (B, F * upsample_rate)`` with no host read inside, the
        params to feed it, and a tag that names the mode.  A synthesizer
        chains decode → vocode on the device with it
        (`Tacotron2.compiled_tts`)."""
        use_kernel, int8 = self._serving_mode_flags()

        def fn(params, mel, generator = None):
            with torch.no_grad():
                return self.arch.infer(
                    params, mel, generator = generator, sigma = sigma,
                    deterministic = deterministic, dtype = dtype,
                    use_kernel = use_kernel).float()

        tag = (self.name, sigma, bool(deterministic), dtype, use_kernel, int8)
        return fn, self._serving_params(use_kernel, int8), tag

    def compiled_infer(self, mel, *, padding_multiple = 256, sigma = None,
                       generator = None, deterministic = False, dtype = None, ** _):
        """mel (B, F, n_mel) or (F, n_mel), numpy or tensor → f32 waveform
        tensor (B, F' * upsample_rate) on the model's device, F' being F
        padded with `pad_mel_value` to a multiple of `padding_multiple`."""
        mel = torch.as_tensor(mel, dtype = torch.float32, device = self.device)
        if mel.ndim == 2: mel = mel[None]
        if padding_multiple and mel.shape[1] % padding_multiple:
            pad = padding_multiple - mel.shape[1] % padding_multiple
            mel = torch.nn.functional.pad(mel, (0, 0, 0, pad), value = self.pad_mel_value)
        fn, params, _ = self.device_vocoder_fn(
            sigma = sigma, deterministic = deterministic, dtype = dtype)
        return fn(params, mel, generator)

    @timer(name = 'inference WaveGlow')
    def infer(self,
              mel,
              *,
              win_len = None,
              hop_len = -64,
              batch = False,
              max_win_len = None,
              ** kwargs
             ):
        """Vocode a mel (F, n_mel) or (B, F, n_mel) → numpy waveform
        (B, F * upsample_rate).  Without `win_len`: one call.  With it:
        overlapping windows of `win_len` frames (one padding bucket), `hop_len`
        frames apart (negative: `win_len + hop_len`; a float: a share of
        `win_len`), stitched with half-overlap trimming (`_stitch_windows`);
        this bounds the card's memory for arbitrarily long audio.  A float
        `win_len` is rounded as the JAX package rounds it, `max_win_len` caps
        it.  A mel no longer than a window, or a batch of mels, is vocoded in
        one call.  `batch` vocodes every window in one call; without it each
        window is its own call.  Every call is queued before the first fetch
        (`_materialize_window_batches`)."""
        if isinstance(mel, str): mel = np.load(mel)
        if not torch.is_tensor(mel): mel = np.asarray(mel)
        if mel.ndim == 2: mel = mel[None]
        seq_len = mel.shape[1]
        audio_len = seq_len * self.upsample_rate

        if win_len is not None:
            if isinstance(win_len, float):
                win_len = int(math.ceil(seq_len / win_len) * win_len)
            if max_win_len is not None:
                win_len = min(win_len, max_win_len)
            kwargs['padding_multiple'] = win_len
            if mel.shape[0] > 1 and seq_len > win_len:
                logger.info('batched mel input: direct inference')
        if win_len is None or seq_len <= win_len or mel.shape[0] > 1:
            return self.compiled_infer(mel, ** kwargs)[:, :audio_len].cpu().numpy()

        if isinstance(hop_len, float): hop_len = int(win_len * hop_len)
        if hop_len < 0: hop_len = win_len + hop_len

        starts = _get_steps(seq_len, win_len, hop_len)
        parts = [mel[:, s: s + win_len] for s in starts]
        if batch:
            stacked = torch.cat(parts) if torch.is_tensor(mel) else np.concatenate(parts)
            dev_parts, sizes = [self.compiled_infer(stacked, ** kwargs)], [len(parts)]
        else:
            dev_parts = [self.compiled_infer(p, ** kwargs) for p in parts]
            sizes = [1] * len(parts)
        audio_parts = _materialize_window_batches(dev_parts, sizes)
        jobs = [(0, int(s), win_len) for s in starts]
        return _stitch_windows(jobs, audio_parts, [seq_len], win_len, self.upsample_rate)[0][None]

    __call__ = infer

    def vocode_windowed_batch(self, mels, *, win_len, hop_len = -64,
                              pad_value = None, vocoder_batch = None,
                              transfer_dtype = 'float32', ** kwargs):
        """Windowed vocoding of several host mels with the windows of all of
        them batched together: one call per `vocoder_batch` windows (by
        default `_auto_vocoder_batch`), the tail batch padded with
        `pad_value` to the same shape.  Every window crosses to the card in
        one copy, and every call is queued before the first fetch.

        ``transfer_dtype='int16'`` quantizes each window batch to 16-bit PCM
        on the card before it is fetched (`_quantize_i16`; max abs error
        1/32767 against float32).

        Returns one stitched waveform per input mel."""
        if isinstance(win_len, float):
            win_len = int(win_len)
        if isinstance(hop_len, float): hop_len = int(win_len * hop_len)
        if hop_len < 0: hop_len = win_len + hop_len
        if pad_value is None: pad_value = self.pad_mel_value
        kwargs.pop('padding_multiple', None)    # windows are already one bucket
        quantize = np.dtype(transfer_dtype) == np.int16

        # (input_idx, start, valid_frames) of every window
        jobs, windows, seq_lens = [], [], []
        for idx, mel in enumerate(mels):
            mel = mel.cpu().numpy() if torch.is_tensor(mel) else np.asarray(mel)
            if mel.ndim == 3: mel = mel[0]
            seq_len = mel.shape[0]
            seq_lens.append(seq_len)
            starts = _get_steps(seq_len, win_len, hop_len) if seq_len > win_len \
                else np.array([0])
            for start in starts:
                part = mel[start: start + win_len]
                valid = part.shape[0]
                if valid < win_len:
                    part = np.pad(part, ((0, win_len - valid), (0, 0)),
                                  constant_values = pad_value)
                jobs.append((idx, int(start), valid))
                windows.append(part)

        vocoder_batch = self._auto_vocoder_batch(win_len, len(windows), vocoder_batch)
        n_batches = -(-len(windows) // vocoder_batch)
        # the tail batch is padded to the shared shape (its rows are dropped)
        windows += [np.full_like(windows[0], pad_value)] * (n_batches * vocoder_batch - len(windows))
        windows = _to_device(np.stack(windows).astype(np.float32), self.device)

        dev_parts, batch_sizes = [], []
        for b in range(n_batches):
            batch_sizes.append(min(vocoder_batch, len(jobs) - b * vocoder_batch))
            dev = self.compiled_infer(windows[b * vocoder_batch: (b + 1) * vocoder_batch],
                                      padding_multiple = None, ** kwargs)
            dev_parts.append(self._quantize_i16(dev) if quantize else dev)
        audio_parts = _materialize_window_batches(dev_parts, batch_sizes)
        return _stitch_windows(jobs, audio_parts, seq_lens, win_len, self.upsample_rate)

    def vocode_windowed_from_device(self, mel, lengths, *, win_len,
                                    hop_len = -64, pad_value = None,
                                    vocoder_batch = None,
                                    transfer_dtype = 'float32', ** kwargs):
        """Windowed vocoding straight off a mel batch ``(B, T, n_mel)`` on the
        card (the synthesizer's decode output): the windows are cut on the
        card (`_slice_windows`, one gather a window batch), so the mel does
        not cross to the host before the vocoder runs.

        `lengths[i]` (on the host) gives row i's valid frames: frames past
        it are replaced by `pad_value` inside the windows, as in the host
        path's trimmed mels.  A window never starts where it would run past
        the buffer (the buffer is padded to one window when shorter): a
        start that would have to be clamped raises.  Returns one stitched
        waveform per row, ``lengths[i] * upsample_rate`` samples long."""
        if isinstance(win_len, float): win_len = int(win_len)
        if isinstance(hop_len, float): hop_len = int(win_len * hop_len)
        if hop_len < 0: hop_len = win_len + hop_len
        if pad_value is None: pad_value = self.pad_mel_value
        kwargs.pop('padding_multiple', None)
        quantize = np.dtype(transfer_dtype) == np.int16

        lengths = [max(1, int(l)) for l in np.asarray(lengths).reshape(-1)]
        jobs = []
        for idx, L in enumerate(lengths):
            starts = _get_steps(L, win_len, hop_len) if L > win_len else np.array([0])
            for start in starts:
                jobs.append((idx, int(start), min(win_len, L - int(start))))

        vocoder_batch = self._auto_vocoder_batch(win_len, len(jobs), vocoder_batch)

        mel = torch.as_tensor(mel, dtype = torch.float32, device = self.device)
        if mel.shape[1] < win_len:      # decode buffer shorter than a window
            mel = torch.nn.functional.pad(mel, (0, 0, 0, win_len - mel.shape[1]),
                                          value = pad_value)

        # (owner, start, owner's length) of every window; the tail batch is
        # padded with windows of row 0 at 0 (their audio is dropped)
        n_batches = -(-len(jobs) // vocoder_batch)
        table = np.zeros((n_batches * vocoder_batch, 3), np.int64)
        table[:, 2] = lengths[0]
        for k, (owner, start, _) in enumerate(jobs):
            table[k] = (owner, start, lengths[owner])
        if (table[:, 1] + win_len > mel.shape[1]).any():
            raise ValueError('a window of {} frames would run past the {}-frame mel buffer '
                             '(lengths {})'.format(win_len, mel.shape[1], lengths))
        table = _to_device(table, mel.device)

        dev_parts, batch_sizes = [], []
        for b in range(n_batches):
            batch_sizes.append(min(vocoder_batch, len(jobs) - b * vocoder_batch))
            windows = _slice_windows(mel, table[b * vocoder_batch: (b + 1) * vocoder_batch],
                                     win_len, pad_value)
            dev = self.compiled_infer(windows, padding_multiple = None, ** kwargs)
            dev_parts.append(self._quantize_i16(dev) if quantize else dev)
        audio_parts = _materialize_window_batches(dev_parts, batch_sizes)
        return _stitch_windows(jobs, audio_parts, lengths, win_len, self.upsample_rate)

    @staticmethod
    def _quantize_i16(audio):
        """16-bit PCM on the card before a fetch: ``round(clip(audio, -1, 1)
        * 32767)``."""
        return torch.round(torch.clamp(audio, -1., 1.) * 32767.).to(torch.int16)

    def _auto_vocoder_batch(self, win_len, n_windows, vocoder_batch):
        """Windows per vocoder call: `vocoder_batch` when given; else each
        call aims at batch × grouped length = 32 × 8192 rows (the grouped
        length of a window is ``win_len * upsample_rate / n_group``), at most
        64 windows and at most the power-of-two ceiling of `n_windows`, so
        that few inputs do not pad a call and the batch sizes stay few."""
        if vocoder_batch is not None:
            return vocoder_batch
        grouped = max(1, win_len * self.upsample_rate // self.arch.hp.n_group)
        sweet = max(1, (32 * 8192) // grouped)
        pow2 = 1
        while pow2 < n_windows: pow2 *= 2
        return int(min(64, sweet, pow2))


def _to_device(array, device):
    """A host array as a tensor on `device`; to a card by one copy from
    pinned memory, which does not wait for the work queued before it."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == 'cuda':
        return tensor.pin_memory().to(device, non_blocking = True)
    return tensor


def _slice_windows(mel, table, win_len, pad_value):
    """Windows (N, win_len, n_mel) of `mel` (B, T, n_mel), one gather:
    window k is row ``table[k, 0]`` from frame ``table[k, 1]``, its frames at
    or past ``table[k, 2]`` (the row's length) set to `pad_value`."""
    idx = table[:, 1:2] + torch.arange(win_len, device = mel.device)
    windows = mel[table[:, 0:1], idx]
    return windows.masked_fill((idx >= table[:, 2:3])[..., None], pad_value)


def _materialize_window_batches(dev_parts, batch_sizes):
    """Window batches (device tensors) → one host waveform per valid row.
    Every device→host copy is queued (into pinned memory) before one wait;
    int16 batches (see ``transfer_dtype``) come back as float32 / 32767."""
    host = []
    for dev in dev_parts:
        if dev.is_cuda:
            buf = torch.empty(dev.shape, dtype = dev.dtype, pin_memory = True)
            host.append(buf.copy_(dev, non_blocking = True))
        else:
            host.append(dev)
    cuda = [dev.device for dev in dev_parts if dev.is_cuda]
    if cuda: torch.cuda.synchronize(cuda[0])
    audio_parts = []
    for out, n_valid in zip(host, batch_sizes):
        out = out.numpy()
        if out.dtype == np.int16:
            out = out.astype(np.float32) / 32767.
        audio_parts.extend(out[i] for i in range(n_valid))
    return audio_parts


def _stitch_windows(jobs, audio_parts, seq_lens, win_len, rate):
    """Half-overlap-trim stitching of per-window waveforms back into one
    waveform per input.  `jobs[k] = (input_idx, start_frame, valid_frames)`
    in input-major order; `seq_lens[i]` is input i's total frame count."""
    results = []
    cursor = 0
    for idx, seq_len in enumerate(seq_lens):
        my_jobs = []
        while cursor < len(jobs) and jobs[cursor][0] == idx:
            my_jobs.append((jobs[cursor], audio_parts[cursor]))
            cursor += 1
        starts = np.array([j[0][1] for j in my_jobs])
        overlaps = ((starts[:-1] + win_len) - starts[1:]) * rate \
            if len(starts) > 1 else np.array([], np.int64)
        pieces = []
        for i, ((_, start, valid), audio) in enumerate(my_jobs):
            audio = audio[: valid * rate]
            lo = 0 if i == 0 else int(overlaps[i - 1]) // 2
            trim = 0 if i == len(my_jobs) - 1 else int(overlaps[i]) // 2
            pieces.append(audio[lo: len(audio) - trim])
        results.append(np.concatenate(pieces)[: seq_len * rate])
    return results


def _get_steps(length, win_len, hop_len):
    """Evenly-spread window starts covering [0, length-win_len]."""
    num_steps = int(math.ceil((length - win_len) / hop_len)) + 1
    if num_steps == 1: return np.array([0])
    max_start = length - win_len
    actual = max_start / (num_steps - 1)
    return np.round(np.arange(num_steps) * actual).astype(np.int64)
