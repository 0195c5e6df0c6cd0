"""WaveGlow task model: mel → waveform.

Counterpart of ``text_to_speech_tpu/models/tts/waveglow.py``: `infer` with
the ×256-frame padding of `compiled_infer`, and the kernel choice of
`_serving_mode_flags` / `_serving_params` — the coupling blocks run in the
`ops.wn_block` CUDA kernel whenever the model lives on a CUDA device (the
JAX package's test is ``platform == 'tpu'``), with the kernel weights
packed once, in its bf16 buffer dtype, and cached.  Windowed vocoding and
the int8 serving mode are not ported yet (see ROADMAP.md).
"""

import os

import numpy as np
import torch

from ...devices import default_device
from ...weights import tree_to, waveglow_from_jax
from ..saving import load_json, load_model_files
from ..waveglow_arch import WaveGlow as WaveGlowArch


class WaveGlow:
    serving_pad_multiple = 256   # compiled_infer's mel shape bucket

    def __init__(self, params, *, name = 'waveglow', device = None,
                 pad_mel_value = -11., rate = 22050, ** arch_config):
        """`params`: the port's parameter tree (`weights.waveglow_from_jax`)."""
        self.name = name
        self.device = default_device(device)
        self.arch = WaveGlowArch(** arch_config)
        self.params = tree_to(params, self.device)
        self.pad_mel_value = pad_mel_value
        self.rate = rate
        self._packed_params = None

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
        return cls.from_jax(files['params'], name = name, device = device,
                            rate = mel_fn.get('sampling_rate', 22050),
                            pad_mel_value = config.get('pad_mel_value', -11.), ** arch)

    @property
    def upsample_rate(self):
        return self.arch.hp.upsample_stride

    def _serving_mode_flags(self):
        """Whether the coupling blocks run in the CUDA kernel."""
        return self.device.type == 'cuda'

    def _serving_params(self, use_kernel):
        """The params `arch.infer` wants: with the kernel-layout weights
        added once, in the kernel's buffer dtype, when the kernel runs."""
        if not use_kernel:
            return self.params
        if self._packed_params is None:
            self._packed_params = self.arch.pack_kernel_params(self.params)
        return self._packed_params

    def quantize_for_serving(self, * args, ** kwargs):
        raise NotImplementedError(
            'int8 serving (fused_wn_block_int8) is not ported yet: see ROADMAP.md')

    def device_vocoder_fn(self, *, sigma = None, deterministic = False,
                          dtype = None, ** _):
        """(fn, params, tag): the vocode core in the current serving mode as
        a function of device tensors, ``fn(params, mel, generator) → f32
        waveform (B, F * upsample_rate)`` with no host read inside, the
        params to feed it, and a tag that names the mode.  A synthesizer
        chains decode → vocode on the device with it
        (`Tacotron2.compiled_tts`)."""
        use_kernel = self._serving_mode_flags()

        def fn(params, mel, generator = None):
            with torch.no_grad():
                return self.arch.infer(
                    params, mel, generator = generator, sigma = sigma,
                    deterministic = deterministic, dtype = dtype,
                    use_kernel = use_kernel).float()

        tag = (self.name, sigma, bool(deterministic), dtype, use_kernel)
        return fn, self._serving_params(use_kernel), tag

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

    def infer(self, mel, ** kwargs):
        """Vocode a mel in one call → numpy waveform (B, F * upsample_rate)."""
        mel = np.asarray(mel) if not torch.is_tensor(mel) else mel
        seq_len = mel.shape[-2]
        audio = self.compiled_infer(mel, ** kwargs)
        return audio[:, :seq_len * self.upsample_rate].cpu().numpy()

    __call__ = infer
