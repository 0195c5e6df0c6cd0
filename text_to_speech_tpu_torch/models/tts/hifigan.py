"""HiFi-GAN task model: mel → waveform, the vocoder beside WaveGlow.

Counterpart of the inference part of ``text_to_speech_tpu/models/tts/hifigan.py``:
the vocoder surface that `tts()` and the Tacotron-2 flows call —
`compiled_infer` (the mel padded with `pad_mel_value` to a multiple of 64
frames, `serving_pad_multiple`, one forward), `device_vocoder_fn` (the
forward as a function of device tensors, which `Tacotron2.compiled_tts`
queues behind the fused decoder, K3, in one call), and `infer` /
``__call__`` (cropped to ``T * upsample_rate`` samples, a 2-D mel squeezed
to one waveform).  The options of a windowed vocoder (`win_len`,
`hop_len`) are accepted and ignored: the whole mel is vocoded, as the JAX
package's `compiled_infer` does through ``** _``.  The architecture is the
one the saved model names (`models.registry`): ``hifigan``, or ``vocos``
for the `Vocos` task.

`save` writes the JAX package's directory layout (``config.json``,
``saving/config_models.json``, ``saving/mel_fn.json``, a checkpoint of the
JAX tree), which `load_saved` and `models.get_pretrained` read; `create`
makes a new model with seeded random weights (`init.init_hifigan`);
`from_torch_pretrained` imports an official generator checkpoint
(`models.tts_checkpoints.convert_hifigan`, the sizes from its shapes) and
saves it.  `fit` trains it adversarially (`train.gan.fit_gan`, with the
discriminators of `hifigan_arch`) on the pairs `prepare_data` makes: the
mel of a row's audio and that audio cut to the mel's frames.
"""

import logging
import os

import numpy as np
import torch

from ...devices import default_device
from ...init import init_hifigan
from ...loggers import timer
from ...ops.stft import MelSTFT
from ...ops.audio_io import load_audio
from ...utils.file_utils import load_json
from ...utils.sequence_utils import pad_batch
from ...weights import hifigan_from_jax, hifigan_to_jax, tree_to
from ..base_model import TrainableModel
from ..registry import get_architecture
from ..saving import load_model_files, model_dir
from ..tts_checkpoints import (
    _load_state_dict, convert_hifigan, hifigan_config_from_state_dict,
    remove_torch_weight_norm)

logger = logging.getLogger(__name__)


class HiFiGAN(TrainableModel):
    serving_pad_multiple = 64    # compiled_infer's mel shape bucket
    architecture = 'hifigan'

    def __init__(self, params, *, name = 'hifigan', device = None, pad_mel_value = -11.,
                 rate = 22050, mel_fn = 'TacotronSTFT', root = None, architecture = None,
                 ** arch_config):
        """`params`: the port's parameter tree (`weights.hifigan_from_jax`).
        `mel_fn`: a `MelSTFT`, its config or class name (made at `rate` with
        the model's mel channels).  `root`: the directory holding
        ``<name>/`` (the pretrained-models root by default)."""
        self.name = name
        self.root = root
        self.device = default_device(device)
        self.arch = get_architecture(architecture or self.architecture, ** arch_config)
        self.params = tree_to(params, self.device)
        self.state = {}
        self.pad_mel_value = pad_mel_value
        if isinstance(mel_fn, str) and not os.path.isfile(mel_fn):
            mel_fn = MelSTFT.create(mel_fn, sampling_rate = rate,
                                    n_mel_channels = self.arch.hp.n_mel_channels)
        self.mel_fn = MelSTFT.create(mel_fn)
        self.rate = self.mel_fn.rate
        self.folder = model_dir(name, root = root)
        self._weights_changed()

    @classmethod
    def from_jax(cls, params, ** kwargs):
        """From the JAX package's params tree (numpy arrays)."""
        return cls(hifigan_from_jax(params), ** kwargs)

    @classmethod
    def load_saved(cls, name, *, root = None, device = None, ** kwargs):
        """Load a saved model (the JAX package's directory layout) with the
        architecture its ``config_models.json`` names."""
        files = load_model_files(name, root = root)
        config = files['config'].get('config', {})
        mel_fn = load_json(os.path.join(files['dir'], 'saving', 'mel_fn.json'))
        return cls.from_jax(files['params'], name = name, device = device, root = root,
                            mel_fn = mel_fn, pad_mel_value = config.get('pad_mel_value', -11.),
                            ** files['architecture'], ** kwargs)

    @staticmethod
    def _random_params(arch, seed):
        return init_hifigan(arch.hp, seed = seed)

    @classmethod
    def create(cls, *, name = None, seed = 0, root = None, device = None,
               mel_fn = 'TacotronSTFT', pad_mel_value = -11., ** kwargs):
        """A new model with random weights seeded by `seed` (the JAX
        package's constructor with hparams `kwargs`), saved under
        ``<root>/<name>/``."""
        arch = get_architecture(cls.architecture, ** kwargs)
        params = cls._random_params(arch, seed)
        model = cls.from_jax(params, name = name or cls.architecture, root = root,
                             device = device, mel_fn = mel_fn, pad_mel_value = pad_mel_value,
                             ** arch.get_config())
        model.save()
        return model

    @classmethod
    def from_torch_pretrained(cls, checkpoint, *, name = 'hifigan', config = None, root = None,
                              device = None, ** kwargs):
        """Import an official HiFi-GAN generator checkpoint (a state dict,
        or a ``.pt`` / ``.pth`` / ``.safetensors`` file; weight norm
        folded) as `name` under `root`: the sizes come from its shapes,
        `config` overrides what they cannot say (`upsample_rates` if not
        kernel // 2, other dilations); the model is saved."""
        sd = remove_torch_weight_norm(_load_state_dict(checkpoint))
        inferred = hifigan_config_from_state_dict(sd)
        inferred.update(config or {})
        params = convert_hifigan(sd, num_kernels = len(inferred['resblock_kernel_sizes']))
        model = cls.from_jax(params, name = name, root = root, device = device,
                             ** {** inferred, ** kwargs})
        model.save()
        return model

    # -- saving --------------------------------------------------------------------

    def jax_trees(self):
        return {'params': hifigan_to_jax(self.params)}

    def get_saving_objects(self):
        return {'mel_fn.json': self.mel_fn}

    def get_config(self):
        return {'audio_format': 'mel', 'pad_mel_value': self.pad_mel_value}

    # -- inference -----------------------------------------------------------------

    @property
    def upsample_rate(self):
        return self.arch.total_upsampling

    def device_vocoder_fn(self, *, dtype = None, ** _):
        """(fn, params, tag): the forward as a function of device tensors,
        ``fn(params, mel, generator) → float32 waveform (B, F * rate)`` (the
        generator is unused: the forward is deterministic), the params to
        feed it and a tag of the mode."""
        def fn(params, mel, generator = None):
            with torch.no_grad():
                return self.arch.apply(params, mel, dtype = dtype)
        return fn, self._cast_params(dtype), (self.name, dtype)

    def compiled_infer(self, mel, *, padding_multiple = 64, dtype = None, ** _):
        """mel (B, F, n_mel) or (F, n_mel), numpy or tensor → float32
        waveform tensor (B, F' * rate) on the model's device, F' being F
        padded with `pad_mel_value` to a multiple of `padding_multiple`."""
        mel = torch.as_tensor(mel, dtype = torch.float32, device = self.device)
        if mel.ndim == 2: mel = mel[None]
        if padding_multiple and mel.shape[1] % padding_multiple:
            pad = padding_multiple - mel.shape[1] % padding_multiple
            mel = torch.nn.functional.pad(mel, (0, 0, 0, pad), value = self.pad_mel_value)
        fn, params, _ = self.device_vocoder_fn(dtype = dtype)
        return fn(params, mel)

    @timer(name = 'inference HiFiGAN')
    def infer(self, mel, *, dtype = None, ** kwargs):
        """Vocode a mel (F, n_mel) or (B, F, n_mel) → numpy float32
        waveform(s) of exactly ``F * upsample_rate`` samples, one waveform
        for a 2-D mel."""
        if isinstance(mel, str): mel = np.load(mel)
        squeeze = mel.ndim == 2
        n_frames = mel.shape[-2]
        audio = self.compiled_infer(mel, dtype = dtype, ** kwargs)
        audio = audio[:, :n_frames * self.upsample_rate].cpu().numpy()
        return audio[0] if squeeze else audio

    __call__ = infer

    # -- training (adversarial: `train.gan.fit_gan`) ---------------------------------

    def prepare_data(self, data):
        """A row (a WAV filename, an array or a dict) → (mel (F, n_mel),
        waveform (F * hop,)), numpy; the mel computed on the model's device."""
        audio = np.asarray(load_audio(data, self.rate), np.float32)
        with torch.no_grad():
            mel = self.mel_fn(torch.as_tensor(audio, device = self.device))[0].cpu().numpy()
        hop = self.mel_fn.hop_length
        n = min(mel.shape[0], len(audio) // hop)
        return mel[:n], audio[: n * hop]

    def filter_data(self, * args):
        """Enough frames for the training windows (8)."""
        if len(args) == 1: args = args[0]
        return args[0].shape[0] >= 8

    def collate(self, batch):
        """(mel, waveform) pairs → (mels, waveforms), padded with
        `pad_mel_value` and zeros."""
        return (pad_batch([b[0] for b in batch], pad_value = self.pad_mel_value),
                pad_batch([b[1] for b in batch], pad_value = 0.))

    def fit(self, data, ** kwargs):
        """Adversarial training: `train.gan.fit_gan`."""
        from ...train.gan import fit_gan
        return fit_gan(self, data, ** kwargs)
