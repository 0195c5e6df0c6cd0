"""Speaker-encoder task model: audio → l2-normalized speaker embedding.

Counterpart of ``text_to_speech_tpu/models/encoder/speaker_encoder.py``
(inference): loading a saved encoder (`from_pretrained`, the JAX package's
directory layout, with its own ``mel_fn.json``: TacotronSTFT at 16 kHz),
`save` (the same layout, so that the JAX package loads it),
`embed` (the mels of a batch padded to its longest clip with
`pad_mel_value`, then to a multiple of 64, as the JAX package pads them:
the convs after the first see the pad frames shifted by batch norm, so the
padding length reaches the edge frames), `identify` and `embedding_dim`.
The delegate of SV2TTS's `encoder_name`.  GE2E training (`fit`,
`collate_ge2e`) is not ported.
"""

import os

import numpy as np
import torch

from ...devices import default_device
from ...loggers import timer
from ...utils.distances import distance
from ...train.checkpoint import CheckpointManager
from ...weights import audio_encoder_from_jax, audio_encoder_to_jax, tree_to
from ..base_audio_model import BaseAudioModel
from ..encoder_arch import AudioEncoder
from ..saving import load_model_files, model_dir, write_model_config

_NOT_PORTED = 'GE2E training of the speaker encoder is not ported (ROADMAP.md, queue 1, item 8)'


class SpeakerEncoder(BaseAudioModel):
    def __init__(self, params, state, *, name = 'speaker_encoder', device = None,
                 mel_fn = 'TacotronSTFT', audio_rate = 16000, max_audio_time = 3.0,
                 pad_mel_value = -11., root = None, ** arch_config):
        """`params`, `state`: the port's trees (`weights.audio_encoder_from_jax`)."""
        self.name = name
        self.root = root
        self.folder = model_dir(name, root = root)
        self.device = default_device(device)
        self.max_audio_time = max_audio_time
        self._init_audio(mel_fn, pad_mel_value = pad_mel_value, audio_rate = audio_rate)
        self.arch = AudioEncoder(n_mel_channels = self.n_mel_channels, ** arch_config)
        self.params = tree_to(params, self.device)
        self.state = tree_to(state, self.device)

    @classmethod
    def from_jax(cls, params, state, ** kwargs):
        """From the JAX package's (params, state) trees (numpy arrays)."""
        return cls(* audio_encoder_from_jax(params, state), ** kwargs)

    @classmethod
    def from_pretrained(cls, name, *, root = None, device = None):
        """Load a saved speaker encoder (the JAX package's directory layout)."""
        files = load_model_files(name, root = root)
        config = files['config'].get('config', {})
        arch = {k: v for k, v in files['architecture'].items()
                if k not in ('architecture', 'n_mel_channels')}
        return cls.from_jax(
            files['params'], files['state'], name = name, root = root, device = device,
            mel_fn = os.path.join(files['dir'], 'saving', 'mel_fn.json'),
            audio_rate = config.get('audio_rate', 16000),
            max_audio_time = config.get('max_audio_time', 3.0),
            pad_mel_value = config.get('pad_mel_value', -11.), ** arch)

    def save(self):
        """Write the model's directory in the JAX package's layout (config,
        architecture, ``mel_fn.json``, a checkpoint of the params and the
        batch-norm statistics as JAX trees at epoch 0)."""
        saving = os.path.join(self.folder, 'saving')
        write_model_config(self.folder, 'SpeakerEncoder',
                           {** self.get_config_audio(), 'audio_rate': self.rate,
                            'max_audio_time': self.max_audio_time, 'name': self.name},
                           'audioencoder', self.arch.get_config())
        self.mel_fn.save(os.path.join(saving, 'mel_fn.json'))
        params, state = audio_encoder_to_jax(self.params, self.state)
        CheckpointManager(os.path.join(saving, 'checkpoint')).save(
            {'params': params, 'state': state}, 0)
        return self.folder

    @property
    def embedding_dim(self):
        return self.arch.hp.embedding_dim

    # -- inference ---------------------------------------------------------------

    def compiled_embed(self, mel, lengths = None, *, padding_multiple = 64):
        """mel (B, T, n_mel) tensor → embeddings (B, D) on the model's device:
        T padded with `pad_mel_value` to a multiple of `padding_multiple`,
        `lengths` (default T) the frames of each row."""
        mel = torch.as_tensor(mel, dtype = torch.float32, device = self.device)
        if mel.ndim == 2: mel = mel[None]
        if lengths is None:
            lengths = [mel.shape[1]] * mel.shape[0]
        if mel.shape[1] % padding_multiple:
            mel = torch.nn.functional.pad(
                mel, (0, 0, 0, padding_multiple - mel.shape[1] % padding_multiple),
                value = self.pad_mel_value)
        lengths = torch.as_tensor(lengths, dtype = torch.int64, device = self.device)
        with torch.no_grad():
            return self.arch(self.params, self.state, mel, lengths = lengths)

    @timer(name = 'embed')
    def embed(self, audio, ** kwargs):
        """audio (a file, an array with its rate in a row dict, a mel, or a
        list of them) → (D,) or (N, D) numpy float32."""
        single = not isinstance(audio, (list, tuple))
        mels = [self.get_audio(a, ** kwargs) for a in ([audio] if single else audio)]
        batch = torch.full((len(mels), max(len(m) for m in mels), self.n_mel_channels),
                           self.pad_mel_value, dtype = torch.float32, device = self.device)
        for i, m in enumerate(mels):
            batch[i, :len(m)] = m
        emb = self.compiled_embed(batch, [len(m) for m in mels]).cpu().numpy()
        return emb[0] if single else emb

    __call__ = embed

    def identify(self, audio, embeddings, *, labels = None, method = 'cosine'):
        """The index (or label) of the reference embedding closest to `audio`'s."""
        query = self.embed(audio)
        sims = np.asarray(distance(query, np.asarray(embeddings),
                                   method = method, as_matrix = True))[0]
        idx = int(np.argmax(sims)) if method == 'cosine' else int(np.argmin(sims))
        return labels[idx] if labels is not None else idx

    # -- training (not ported) ------------------------------------------------------

    def collate_ge2e(self, batch):
        raise NotImplementedError(_NOT_PORTED)

    def fit(self, data, ** kwargs):
        raise NotImplementedError(_NOT_PORTED)
