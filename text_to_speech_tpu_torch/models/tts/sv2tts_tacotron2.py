"""SV2TTS Tacotron-2: voice cloning from a speaker embedding.

Counterpart of ``text_to_speech_tpu/models/tts/sv2tts_tacotron2.py``
(inference): a `Tacotron2` whose architecture takes a speaker embedding
(`speaker_embedding_dim` = `embedding_dim`, concatenated at
`speaker_concat_pos`, 'end' by default), with the embedding machinery of
`SpeakerEmbeddingMixin`.  `infer`, `predict` and `predict_batched` take the
speaker as `embeddings` (a vector, a table or its file, with `mode` and
`label`), as reference `audio` (through the `encoder_name` speaker
encoder), or from the stored default.

The ``map.json`` cache is keyed by text alone, so these flows default to
``overwrite=True``: a second speaker is never answered with the first
one's audio.  (The JAX package's `predict` passes its own
``overwrite=False`` to `infer`.)

Training: `create` makes a new model (``embedding_dim`` becomes the
architecture's ``speaker_embedding_dim``), and
``from_pretrained(name, pretrained_name, embedding_dim = ...)`` makes one
from a single-speaker Tacotron-2 (the JAX package's way of starting a voice
clone: the speaker's new rows start at zero); `prepare_data` / `collate` put the
row's speaker embedding (its ``embedding``, else the resolved
``embeddings``) second in the inputs, (tokens, embedding, mel_in, steps),
and the teacher-forced forward takes it at every concat position.
"""

import numpy as np

from ...utils.sequence_utils import pad_batch
from ..saving import load_model_files
from .speaker_embedding_mixin import SpeakerEmbeddingMixin
from .tacotron2 import Tacotron2


class SV2TTSTacotron2(SpeakerEmbeddingMixin, Tacotron2):
    _task_keys = Tacotron2._task_keys + ('embedding_dim', 'encoder_name',
                                         'speaker_encoder_name')

    def __init__(self, params, state, *, name = 'sv2tts_tacotron2', embedding_dim = 256,
                 encoder_name = None, speaker_encoder_name = None, ** kwargs):
        if speaker_encoder_name: encoder_name = speaker_encoder_name
        kwargs.setdefault('speaker_embedding_dim', embedding_dim)
        kwargs.setdefault('speaker_concat_pos', 'end')
        super().__init__(params, state, name = name, ** kwargs)
        self._init_speaker_embedding(embedding_dim, encoder_name)

    @classmethod
    def load_saved(cls, name, *, root = None, device = None, ** kwargs):
        """Load a saved SV2TTS Tacotron-2 with its `embedding_dim` and
        `encoder_name` (or `speaker_encoder_name`)."""
        config = load_model_files(name, root = root)['config'].get('config', {})
        for key in ('embedding_dim', 'encoder_name', 'speaker_encoder_name'):
            if key in config: kwargs.setdefault(key, config[key])
        return super().load_saved(name, root = root, device = device, ** kwargs)

    @classmethod
    def create(cls, lang = 'en', *, embedding_dim = 256, ** kwargs):
        """`Tacotron2.create` with the speaker: `embedding_dim` wide,
        concatenated at ``speaker_concat_pos`` ('end' unless given).  With
        ``pretrained_name`` this is the JAX package's way of making a
        voice-cloning model from a single-speaker Tacotron-2
        (``from_pretrained(name, pretrained_name, embedding_dim = ...)``):
        every source weight arrives, and the rows that the speaker widens
        (with 'end': the attention memory layer, both LSTMs' input kernels,
        the projections) start at zero, so the clone speaks as its source
        until it is fine-tuned."""
        kwargs.setdefault('speaker_embedding_dim', embedding_dim)
        kwargs.setdefault('speaker_concat_pos', 'end')
        return super().create(lang, embedding_dim = embedding_dim, ** kwargs)

    def get_config(self):
        return {** super().get_config(), ** self.get_speaker_config()}

    # -- data processing (training) --------------------------------------------

    def prepare_data(self, data):
        (tokens, mel_in, length), outputs = super().prepare_data(data)
        embedding = np.asarray(
            data['embedding'] if isinstance(data, dict) and 'embedding' in data
            else self.get_speaker_embedding(
                data.get('embeddings') if isinstance(data, dict) else None), np.float32)
        return (tokens, embedding, mel_in, length), outputs

    def collate(self, batch):
        inputs, outputs = zip(* batch)
        pad_in, pad_out = self.get_padding_values()
        tokens = pad_batch([i[0] for i in inputs], pad_value = pad_in[0])
        embeddings = np.stack([i[1] for i in inputs])
        mel_in = pad_batch([i[2] for i in inputs], pad_value = pad_in[1])
        lengths = np.asarray([i[3] for i in inputs], np.int32)
        mel_out = pad_batch([o[0] for o in outputs], pad_value = pad_out[0])
        gate = pad_batch([o[1] for o in outputs], pad_value = pad_out[1])
        return (tokens, embeddings, mel_in, lengths), (mel_out, gate)

    # -- inference -------------------------------------------------------------

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
