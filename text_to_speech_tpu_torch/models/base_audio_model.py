"""The audio side of a task model.

Counterpart of the audio part of
``text_to_speech_tpu/models/interfaces/base_audio_model.py``: the model's
mel front end (`mel_fn`, a `ops.stft.MelSTFT`, saved as
``saving/mel_fn.json``), its rate and width, and `get_audio`: a filename,
an array or a dataset row → the mel, computed on the model's device.  The
port's audio models read mels only (the JAX ``audio_format='mel'``).
Silence trimming and noise reduction are not ported (`get_audio` raises
when asked for them).
"""

import os

from ..ops.audio_io import load_mel
from ..ops.stft import MelSTFT


class BaseAudioModel:
    def _init_audio(self, mel_fn = 'TacotronSTFT', *, pad_mel_value = -11., audio_rate = None):
        """`mel_fn`: a `MelSTFT`, its config dict or ``.json`` file, or a class
        name (made at `audio_rate`)."""
        self.pad_mel_value = pad_mel_value
        if isinstance(mel_fn, str) and not os.path.isfile(mel_fn) and audio_rate:
            mel_fn = MelSTFT.create(mel_fn, sampling_rate = audio_rate)
        self.mel_fn = MelSTFT.create(mel_fn)

    @property
    def rate(self):
        return self.mel_fn.rate

    @property
    def n_mel_channels(self):
        return self.mel_fn.n_mel_channels

    def get_audio(self, data, ** kwargs):
        """The mel (frames, n_mel) of `data`, a float32 tensor on the model's device."""
        return load_mel(data, self.mel_fn, device = self.device, ** kwargs)

    def get_config_audio(self):
        return {'audio_format': 'mel', 'pad_mel_value': self.pad_mel_value}
