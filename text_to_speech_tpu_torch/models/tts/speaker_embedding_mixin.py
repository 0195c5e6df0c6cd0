"""The SV2TTS speaker-embedding machinery.

Counterpart of ``text_to_speech_tpu/models/tts/speaker_embedding_mixin.py``:
the model's embeddings directory (``<root>/<name>/embeddings/``) and its
default embedding (``default_embedding.npy`` there), embedding tables
(`utils.embeddings`: files, `select_embedding` modes mean / random /
label), and the speaker encoder named by `encoder_name`, loaded lazily
(`models.get_pretrained`) on the model's device and root to embed
reference audio.
"""

import os

import numpy as np

from ...utils.embeddings import load_embeddings, save_embeddings, select_embedding


class SpeakerEmbeddingMixin:
    """Expects `folder`, `root` and `device` (from the task model); call
    `_init_speaker_embedding` from the constructor."""

    def _init_speaker_embedding(self, embedding_dim, encoder_name):
        self.embedding_dim = embedding_dim
        self.encoder_name = encoder_name
        self._speaker_encoder = None
        self._default_embedding = None

    # -- embeddings ------------------------------------------------------------

    @property
    def embeddings_dir(self):
        path = os.path.join(self.folder, 'embeddings')
        os.makedirs(path, exist_ok = True)
        return path

    @property
    def default_embedding_file(self):
        return os.path.join(self.embeddings_dir, 'default_embedding.npy')

    def set_default_embedding(self, embedding):
        np.save(self.default_embedding_file, np.asarray(embedding))
        self._default_embedding = np.asarray(embedding)

    def get_default_embedding(self):
        if self._default_embedding is None and os.path.exists(self.default_embedding_file):
            self._default_embedding = np.load(self.default_embedding_file)
        return self._default_embedding

    @property
    def speaker_encoder(self):
        """The speaker encoder named `encoder_name`, loaded on first use."""
        if self._speaker_encoder is None and self.encoder_name:
            from .. import get_pretrained
            self._speaker_encoder = get_pretrained(self.encoder_name, root = self.root,
                                                   device = self.device)
        return self._speaker_encoder

    def embed_audio(self, audio, ** kwargs):
        """The speaker embedding of reference `audio`, by the speaker encoder."""
        encoder = self.speaker_encoder
        if encoder is None:
            raise ValueError('{} has no speaker encoder; pass `embeddings=` explicitly or '
                             'set `encoder_name`'.format(self.name))
        return np.asarray(encoder.embed(audio, ** kwargs))

    def get_speaker_embedding(self, embeddings = None, *, audio = None, mode = 'mean',
                              label = None, ** kwargs):
        """A (D,) speaker embedding from a vector, a table or its file (with
        the selection `mode` and `label`), reference `audio`, or the stored
        default."""
        if embeddings is None and audio is not None:
            return self.embed_audio(audio, ** kwargs)
        if embeddings is None:
            default = self.get_default_embedding()
            if default is None:
                raise ValueError('No embedding provided and no default stored')
            return default
        if isinstance(embeddings, str):
            embeddings = load_embeddings(embeddings)
        if isinstance(embeddings, np.ndarray) and embeddings.ndim == 1:
            return embeddings
        return select_embedding(embeddings, mode = mode, label = label)

    def save_embeddings(self, filename, embeddings, ** metadata):
        return save_embeddings(os.path.join(self.embeddings_dir, filename), embeddings,
                               ** metadata)

    def get_speaker_config(self):
        return {'embedding_dim': self.embedding_dim, 'encoder_name': self.encoder_name}
