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
kernel weights are made once and cached.  Windowed vocoding is not ported
yet (see ROADMAP.md).

Training (the JAX package's `BaseModel.fit` and the task's data hooks):
the model owns its mel front end (`mel_fn`, saved as ``saving/mel_fn.json``),
prepares (mel, audio) pairs from WAV files or arrays (`prepare_data`,
`collate`), and `fit` trains it with `train.trainer.fit`.  `save` writes the
JAX package's directory layout under ``<root>/<name>/`` (``config.json``,
``saving/config_models.json``, ``saving/mel_fn.json``,
``saving/history.json`` and ``saving/checkpoint/``), the params in the JAX
package's tree layout (`weights.waveglow_to_jax`).
"""

import logging
import os

import numpy as np
import torch

from ...devices import default_device
from ...loggers import timer
from ...ops.audio_io import load_audio
from ...ops.stft import MelSTFT
from ...train.checkpoint import CheckpointManager
from ...train.history import History, dump_json
from ...weights import tree_to, waveglow_from_jax, waveglow_to_jax
from ..saving import load_json, load_model_files, model_dir
from ..waveglow_arch import WaveGlow as WaveGlowArch

logger = logging.getLogger(__name__)


class WaveGlow:
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
        self._history = None
        self._ckpt_manager = None
        self._packed_params = None        # (params, int8, kernel params)
        self._serve_int8 = False
        self._serve_force_xla = False

    @classmethod
    def from_jax(cls, params, ** kwargs):
        """From the JAX package's params tree (numpy arrays)."""
        return cls(waveglow_from_jax(params), ** kwargs)

    @classmethod
    def from_pretrained(cls, name, *, root = None, device = None):
        """Load a saved WaveGlow (the JAX package's directory layout)."""
        files = load_model_files(name, root = root)
        arch = {k: v for k, v in files['architecture'].items() if k != 'architecture'}
        config = files['config'].get('config', {})
        mel_fn = load_json(os.path.join(files['dir'], 'saving', 'mel_fn.json'))
        return cls.from_jax(files['params'], name = name, device = device, root = root,
                            mel_fn = mel_fn, pad_mel_value = config.get('pad_mel_value', -11.),
                            ** arch)

    # -- training ----------------------------------------------------------------

    @property
    def history(self):
        if self._history is None:
            self._history = History.load(os.path.join(self.folder, 'saving', 'history.json'))
        return self._history

    @property
    def epochs(self):
        return self.history.epochs

    @property
    def ckpt_manager(self):
        """The `CheckpointManager` of ``saving/checkpoint/``, made (with its
        directory) at first use."""
        if self._ckpt_manager is None:
            self._ckpt_manager = CheckpointManager(
                os.path.join(self.folder, 'saving', 'checkpoint'),
                max_to_keep = self.max_to_keep)
        return self._ckpt_manager

    def to(self, device):
        """Move the params to `device` (a no-op where they are)."""
        device = torch.device(device)
        if device != self.device:
            self.params = tree_to(self.params, device)
            self.device = device
            self._packed_params = None
        return self

    def set_weights(self, params, state = None):
        self.params = tree_to(_detach(params), self.device)
        if state is not None: self.state = state
        self._packed_params = None

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
        mels = _pad_batch([b[0] for b in batch], self.pad_mel_value)
        audios = _pad_batch([b[1] for b in batch], 0.)
        return (mels, audios), audios

    def get_padding_values(self):
        return (self.pad_mel_value, 0.)

    def get_config(self):
        return {'pad_mel_value': self.pad_mel_value}

    def save(self, *, epoch = None, metric = None, extra_trees = None, saver = None):
        """Write the model's directory in the JAX package's layout, with a
        checkpoint of the params (JAX tree layout) and of `extra_trees` for
        `epoch` (default: ``epochs``); through `saver`
        (`train.checkpoint.AsyncCheckpointSaver`), when given, the checkpoint
        is written on its thread."""
        saving = os.path.join(self.folder, 'saving')
        dump_json(os.path.join(self.folder, 'config.json'), {
            'class_name': 'WaveGlow', 'config': {** self.get_config(), 'name': self.name}})
        dump_json(os.path.join(saving, 'config_models.json'),
                  {'architecture': 'waveglow', ** self.arch.get_config()})
        self.mel_fn.save(os.path.join(saving, 'mel_fn.json'))
        self.history.save(os.path.join(saving, 'history.json'))
        trees = {'params': waveglow_to_jax(self.params), ** (extra_trees or {})}
        (saver or self.ckpt_manager).save(trees, epoch if epoch is not None else self.epochs,
                                          metric = metric)
        return self.folder

    def fit(self, dataset, ** kwargs):
        """Train on `dataset` with `train.trainer.fit`."""
        from ...train.trainer import fit
        return fit(self, dataset, ** kwargs)

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
    def infer(self, mel, ** kwargs):
        """Vocode a mel in one call → numpy waveform (B, F * upsample_rate)."""
        mel = np.asarray(mel) if not torch.is_tensor(mel) else mel
        seq_len = mel.shape[-2]
        audio = self.compiled_infer(mel, ** kwargs)
        return audio[:, :seq_len * self.upsample_rate].cpu().numpy()

    __call__ = infer


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def _pad_batch(arrays, pad_value):
    """Arrays of equal trailing shape → one array padded along axis 1."""
    arrays = [np.asarray(a) for a in arrays]
    out = np.full((len(arrays), max(len(a) for a in arrays)) + arrays[0].shape[1:],
                  pad_value, dtype = arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
    return out
