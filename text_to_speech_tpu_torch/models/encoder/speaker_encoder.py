"""Speaker-encoder task model: audio → l2-normalized speaker embedding.

Counterpart of ``text_to_speech_tpu/models/encoder/speaker_encoder.py``
(inference): loading a saved encoder (`from_pretrained`, the JAX package's
directory layout, with its own ``mel_fn.json``: TacotronSTFT at 16 kHz),
`save` (the same layout, so that the JAX package loads it),
`embed` (the mels of a batch padded to its longest clip with
`pad_mel_value`, then to a multiple of 64, as the JAX package pads them:
the convs after the first see the pad frames shifted by batch norm, so the
padding length reaches the edge frames), `identify` and `embedding_dim`.
The delegate of SV2TTS's `encoder_name`.  Training: `create` (a new
encoder with seeded random weights, saved under its name), `prepare_data`
(a mel cropped at random to `max_mel_frames`), `collate_ge2e` and `fit`,
which trains with `GE2ELoss` on `train.datasets.GE2EDataset` batches of
`n_speakers` × `n_utterances` rows; the encoder stays float32 under a mixed
policy (``mixed_precision_ok = False``, as the JAX package's).
"""

import os

import numpy as np
import torch

from ...devices import default_device
from ...init import init_audio_encoder
from ...loggers import timer
from ...ops.stft import MelSTFT
from ...utils.distances import distance
from ...utils.sequence_utils import pad_batch, pad_to_multiple
from ...weights import audio_encoder_from_jax, audio_encoder_to_jax, tree_to
from ..base_audio_model import BaseAudioModel
from ..base_model import TrainableModel, transfer_trees
from ..encoder_arch import AudioEncoder
from ..saving import load_model_files, model_dir


class SpeakerEncoder(TrainableModel, BaseAudioModel):
    _default_loss = 'GE2ELoss'
    mixed_precision_ok = False

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
    def load_saved(cls, name, *, root = None, device = None):
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

    @classmethod
    def create(cls, *, name = 'speaker_encoder', seed = 0, root = None, device = None,
               mel_fn = 'TacotronSTFT', audio_rate = 16000, max_audio_time = 3.0,
               pad_mel_value = -11., pretrained_name = None, ** kwargs):
        """A new encoder with random weights (the JAX package's constructor):
        the mel front end `mel_fn` at `audio_rate`, the architecture's
        hparams from `kwargs`, weights from the port's `init` seeded with
        `seed` (with `pretrained_name`, the saved model's transferred onto
        them, `base_model.transfer_trees`); saved under
        ``<root>/<name>/``."""
        if isinstance(mel_fn, str):
            mel_fn = MelSTFT.create(mel_fn, sampling_rate = audio_rate)
        arch = AudioEncoder(** {'n_mel_channels': mel_fn.n_mel_channels, ** kwargs})
        params, state = init_audio_encoder(arch.hp, seed = seed)
        if pretrained_name:
            params, state = transfer_trees(pretrained_name, params, state, root = root)
        config = {k: v for k, v in arch.get_config().items() if k != 'n_mel_channels'}
        model = cls.from_jax(params, state, name = name, root = root, device = device,
                             mel_fn = mel_fn, audio_rate = audio_rate,
                             max_audio_time = max_audio_time, pad_mel_value = pad_mel_value,
                             ** config)
        model.save()
        return model

    def get_config(self):
        return {** self.get_config_audio(), 'audio_rate': self.rate,
                'max_audio_time': self.max_audio_time}

    def get_saving_objects(self):
        return {'mel_fn.json': self.mel_fn}

    def jax_trees(self):
        params, state = audio_encoder_to_jax(self.params, self.state)
        return {'params': params, 'state': state}

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

    # -- training -----------------------------------------------------------------

    @property
    def max_mel_frames(self):
        return self.mel_fn.get_mel_length(int(self.max_audio_time * self.rate))

    def prepare_data(self, row):
        """The row's mel (numpy), cropped at a random start (numpy's global
        generator, as the JAX package draws it) to `max_mel_frames`."""
        mel = self.get_audio(row).cpu().numpy()
        if len(mel) > self.max_mel_frames:
            start = np.random.randint(0, len(mel) - self.max_mel_frames + 1)
            mel = mel[start: start + self.max_mel_frames]
        return mel

    def collate_ge2e(self, batch):
        """[speakers][utterances] of mels → ((mels (N M, T, n_mel), lengths),
        None): T is `max_mel_frames` (or the longest) rounded up to a
        multiple of 32, padded with `pad_mel_value`; the (N, M) grouping is
        ``ge2e_shape``."""
        flat = [mel for group in batch for mel in group]
        lengths = np.asarray([len(m) for m in flat], np.int32)
        mels = pad_batch(flat, pad_value = self.pad_mel_value, max_length = self.max_mel_frames)
        mels = pad_to_multiple(mels, 32, axis = 1, constant_values = self.pad_mel_value)
        return (mels, lengths), None

    def fit(self, data, *, n_speakers = 8, n_utterances = 4, speaker_column = 'speaker',
            ** kwargs):
        """GE2E training on rows with a `speaker_column`: each batch holds
        `n_speakers` speakers × `n_utterances` of their rows; no validation
        split.  `kwargs` go to `train.trainer.fit`."""
        from ...train.datasets import GE2EDataset
        from ...train.trainer import fit
        self.ge2e_shape = (n_speakers, n_utterances)
        ds = GE2EDataset(data, speaker_column = speaker_column, n_speakers = n_speakers,
                         n_utterances = n_utterances, map_fn = self.prepare_data,
                         collate_fn = self.collate_ge2e)
        return fit(self, ds, valid_size = 0., ** kwargs)
