"""SV2TTS VITS: voice cloning on the end-to-end family.

Counterpart of the inference part of
``text_to_speech_tpu/models/tts/sv2tts_vits.py``: a `VITS` whose
architecture takes an external speaker embedding (`speaker_embedding_dim`
= `embedding_dim`, projected to the global conditioning of the flow,
duration and decoder stacks, `vits_arch.VITS.global_cond`), with the
embedding machinery of `SpeakerEmbeddingMixin`: `infer`, `predict` and
`predict_batched` take the speaker as `embeddings` (a vector, a table or
its file, with `mode` and `label`), as reference `audio` (through the
`encoder_name` speaker encoder), or from the stored default.  As for
`SV2TTSTacotron2`, these flows default to ``overwrite=True``: the
``map.json`` cache is keyed by text alone.  In training (`fit`) the
speaker embedding rides the batch's speaker slot: a row's 'embedding', or
the one `get_speaker_embedding` gives for its 'embeddings' (the stored
default without).
"""

import numpy as np

from ..saving import load_model_files
from .speaker_embedding_mixin import SpeakerEmbeddingMixin
from .vits import VITS


class SV2TTSVITS(SpeakerEmbeddingMixin, VITS):
    _task_keys = VITS._task_keys + ('embedding_dim', 'encoder_name', 'speaker_encoder_name')

    def __init__(self, params, state = None, *, name = 'sv2tts_vits', embedding_dim = 256,
                 encoder_name = None, speaker_encoder_name = None, ** kwargs):
        if speaker_encoder_name: encoder_name = speaker_encoder_name
        kwargs.setdefault('speaker_embedding_dim', embedding_dim)
        super().__init__(params, state, name = name, ** kwargs)
        self._init_speaker_embedding(embedding_dim, encoder_name)

    @classmethod
    def load_saved(cls, name, *, root = None, device = None, ** kwargs):
        """Load a saved SV2TTS VITS with its `embedding_dim` and
        `encoder_name`."""
        config = load_model_files(name, root = root)['config'].get('config', {})
        for key in ('embedding_dim', 'encoder_name', 'speaker_encoder_name'):
            if key in config: kwargs.setdefault(key, config[key])
        return super().load_saved(name, root = root, device = device, ** kwargs)

    @classmethod
    def create(cls, lang = 'en', *, embedding_dim = 256, ** kwargs):
        """`VITS.create` with an `embedding_dim`-wide speaker projection."""
        kwargs.setdefault('speaker_embedding_dim', embedding_dim)
        return super().create(lang, embedding_dim = embedding_dim, ** kwargs)

    def get_config(self):
        return {** super().get_config(), ** self.get_speaker_config()}

    def _resolve_speaker(self, embeddings, audio, mode, label):
        return np.asarray(self.get_speaker_embedding(embeddings, audio = audio, mode = mode,
                                                     label = label), np.float32)

    def infer(self, text, *, embeddings = None, audio = None, mode = 'mean', label = None,
              overwrite = True, ** kwargs):
        return super().infer(
            text, embeddings = self._resolve_speaker(embeddings, audio, mode, label),
            overwrite = overwrite, ** kwargs)

    def predict_batched(self, texts, *, embeddings = None, audio = None, mode = 'mean',
                        label = None, overwrite = True, ** kwargs):
        return super().predict_batched(
            texts, embeddings = self._resolve_speaker(embeddings, audio, mode, label),
            overwrite = overwrite, ** kwargs)

    def predict(self, inputs, *, overwrite = True, ** kwargs):
        return super().predict(inputs, overwrite = overwrite, ** kwargs)

    # -- training -----------------------------------------------------------------------

    def prepare_data(self, data):
        """`VITS.prepare_data` and the row's speaker embedding (float32)."""
        tokens, spec, n_frames, audio = super().prepare_data(data)
        if isinstance(data, dict) and 'embedding' in data:
            embedding = data['embedding']
        else:
            embedding = self.get_speaker_embedding(
                data.get('embeddings') if isinstance(data, dict) else None)
        return tokens, spec, n_frames, audio, np.asarray(embedding, np.float32)

    def get_padding_values(self):
        return super().get_padding_values() + (0.,)

    def collate(self, batch):
        return super().collate([b[:4] for b in batch]) + (np.stack([b[4] for b in batch]),)
