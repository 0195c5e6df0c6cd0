"""FastSpeech-2 task model: text → mel in one parallel pass (→ waveform).

Counterpart of the inference part of
``text_to_speech_tpu/models/tts/fastspeech2.py``: a `Tacotron2` whose
`compiled_infer` runs `fastspeech2_arch.FastSpeech2.infer` (the duration
predictor, the length regulator and the decoder in one forward, no decode
loop) instead of the autoregressive decoder.  Everything else is the
Tacotron-2 task surface, unchanged: text splitting, cleaning and encoding,
`_tts_one_launch` → `compiled_tts` (forward → vocoder → int16 on the
device, no host read between), the batched and windowed flows,
`predict_batched`, the callbacks and ``map.json``, `stream`.

`compiled_infer` pads the tokens to a multiple of `padding_multiple` (64)
and sizes the frame buffer as the JAX package does: `max_length` (a float
is a multiple of the padded token count) clamped to `max_output_length`
and to the positional table (`max_position`), rounded up to the multiple
and clamped again below `max_position`.  The Tacotron-2 flows' decode
options (`use_fused_decoder`, `deterministic`, `attn_mask_*`, ...) are
accepted and ignored.  `infer` turns the frames-per-token gates off, as
the JAX package's does.

Training (`fit`, through the `Tacotron2` task's): `prepare_data` gives
((tokens, durations, pitch, energy), (mel, durations, pitch, energy)): the
durations from ``durations``, from a teacher's ``alignment``
(`ops.pitch.durations_from_attention`) or a uniform split with a warning,
always re-tiled to sum to the mel's length (`_load_durations`); pitch and
energy from the row or estimated from its waveform at the model's rate
(`_load_variances`), at the architecture's variance level.  `bucket_pad`
pads tokens and phoneme-level variances to the token multiple, the mel and
frame-level variances to the frame multiple.
"""

import logging

import numpy as np
import torch

from ...init import init_fastspeech2
from ...loggers import timer
from ...ops.audio_io import load_audio
from ...ops.pitch import (
    durations_from_attention, estimate_pitch, frame_energy, log_normalize, phoneme_average)
from ...utils.sequence_utils import pad_batch, pad_to_multiple
from ...weights import cast_tree, convert_tree
from ..fastspeech2_arch import FastSpeech2 as FastSpeech2Arch
from .tacotron2 import Tacotron2

logger = logging.getLogger(__name__)


class FastSpeech2(Tacotron2):
    arch_class = FastSpeech2Arch
    _default_loss = 'FastSpeech2Loss'
    mixed_precision_ok = True

    def __init__(self, params, state, *, name = 'fastspeech2', ** kwargs):
        super().__init__(params, state, name = name, ** kwargs)

    @classmethod
    def from_jax(cls, params, state, ** kwargs):
        """From the JAX package's (params, state) trees (numpy arrays)."""
        return cls(convert_tree(params), convert_tree(state), ** kwargs)

    @staticmethod
    def _random_trees(hp, seed):
        return init_fastspeech2(hp, seed = seed)

    @property
    def variance_level(self):
        return self.arch.hp.variance_level

    def _weights(self, dtype):
        """(params, state) cast to `dtype`, the params once per dtype and set
        of weights."""
        return self._cast_params(dtype), \
            self.state if dtype is None else cast_tree(self.state, dtype)

    def compiled_infer(self,
                       tokens,
                       *,
                       embeddings = None,
                       max_length = None,
                       padding_multiple = 64,
                       d_control = 1.,
                       p_control = 1.,
                       e_control = 1.,
                       min_duration = 0,
                       dtype = None,
                       ** _):
        """One parallel forward on a padded token batch (B, S); `embeddings`:
        the speaker, (D,) or one row per text, for a model with a speaker
        projection.  The controls reach the architecture as float32 tensors,
        as the JAX package's are float32 arrays."""
        tokens = np.asarray(tokens)
        if tokens.ndim == 1: tokens = tokens[None]
        tokens = pad_to_multiple(tokens, padding_multiple, axis = 1,
                                 constant_values = self.blank_token_idx)
        max_frames = self._max_frames(tokens.shape[1], max_length, padding_multiple)
        spk = self._speaker_rows(embeddings, tokens.shape[0])
        controls = torch.tensor([d_control, p_control, e_control], dtype = torch.float32,
                                device = self.device)
        params, state = self._weights(dtype)
        with torch.no_grad():
            return self.arch.infer(
                params, state, torch.as_tensor(tokens, dtype = torch.long, device = self.device),
                speaker_embedding = None if spk is None else torch.tensor(spk, device = self.device),
                max_frames = max_frames, d_control = controls[0], p_control = controls[1],
                e_control = controls[2], min_duration = int(min_duration), dtype = dtype)

    @timer(name = 'inference FastSpeech2')
    def infer(self, text, *, min_fpt_ratio = 0., max_fpt_ratio = float('inf'),
              max_length = 10., ** kwargs):
        """`Tacotron2.infer` with the frames-per-token gates off: durations
        are explicit, a parallel pass cannot run away as attention can."""
        return super().infer(text, min_fpt_ratio = min_fpt_ratio, max_fpt_ratio = max_fpt_ratio,
                             max_length = max_length, ** kwargs)

    # -- training data pipeline ------------------------------------------------

    def _load_durations(self, data, n_tokens, n_frames):
        """Frames per token: the row's ``durations``, else the durations of
        its ``alignment`` (an attention map), else a uniform split (with a
        warning, once); cut or padded to `n_tokens` and re-tiled so that
        they sum to `n_frames` (the last token takes the difference, then
        the ones before it while it is 0)."""
        durations = data.get('durations') if isinstance(data, dict) else None
        if isinstance(durations, str):
            durations = np.load(durations)
        if durations is None and isinstance(data, dict) and data.get('alignment') is not None:
            align = data['alignment']
            if isinstance(align, str): align = np.load(align)
            durations = durations_from_attention(align, n_tokens = n_tokens)
        if durations is None:
            if not getattr(self, '_warned_uniform_durations', False):
                logger.warning('no duration targets in data: falling back to a uniform split '
                               '(provide data["durations"] or data["alignment"] for real '
                               'training)')
                self._warned_uniform_durations = True
            base = n_frames // max(n_tokens, 1)
            durations = np.full((n_tokens,), base, np.int32)
            durations[: n_frames - base * n_tokens] += 1
        durations = np.asarray(durations, np.int32)[:n_tokens]
        if len(durations) < n_tokens:
            durations = np.pad(durations, (0, n_tokens - len(durations)))
        diff = n_frames - int(durations.sum())
        if diff != 0:
            durations[-1] = max(0, durations[-1] + diff)
            overflow = int(durations.sum()) - n_frames
            if overflow > 0:
                for i in range(len(durations) - 2, -1, -1):
                    take = min(durations[i], overflow)
                    durations[i] -= take
                    overflow -= take
                    if overflow == 0: break
        return durations

    def _load_variances(self, data, durations, n_frames):
        """(pitch, energy) targets at the architecture's variance level: the
        row's, else estimated from its waveform (autocorrelation F0 and frame
        energy at the mel's hop and window, log-normalized), else zeros."""
        hp = self.arch.hp
        pitch = data.get('pitch') if isinstance(data, dict) else None
        energy = data.get('energy') if isinstance(data, dict) else None
        if isinstance(pitch, str): pitch = np.load(pitch)
        if isinstance(energy, str): energy = np.load(energy)
        if (pitch is None and hp.use_pitch) or (energy is None and hp.use_energy):
            audio = None
            if isinstance(data, dict) and any(
                    k in data for k in ('audio', 'wavs_22050', 'filename', 'wav')):
                try:
                    audio = np.asarray(load_audio(data, self.rate))
                except Exception:
                    audio = None
            hop = getattr(self.mel_fn, 'hop_length', 256)
            win = getattr(self.mel_fn, 'win_length', 1024)
            if pitch is None and hp.use_pitch:
                if audio is not None and len(audio) > win:
                    f0, _ = estimate_pitch(audio, self.rate, hop_length = hop,
                                           win_length = win)
                    pitch, _, _ = log_normalize(f0)
                else:
                    pitch = np.zeros((n_frames,), np.float32)
            if energy is None and hp.use_energy:
                if audio is not None and len(audio) > win:
                    e = frame_energy(audio, hop_length = hop, win_length = win)
                    energy, _, _ = log_normalize(e, log_scale = False)
                else:
                    energy = np.zeros((n_frames,), np.float32)

        def fit_level(v):
            if v is None:
                return np.zeros((0,), np.float32)
            v = np.asarray(v, np.float32)
            if self.variance_level == 'phoneme':
                if len(v) != len(durations):
                    v = phoneme_average(v[:n_frames], durations)
                return v
            v = v[:n_frames]
            if len(v) < n_frames:
                v = np.pad(v, (0, n_frames - len(v)))
            return v

        return fit_level(pitch), fit_level(energy)

    def prepare_data(self, data):
        """((tokens, durations, pitch, energy), (mel, durations, pitch,
        energy)): the variances condition the decoder and supervise the
        predictors."""
        tokens = self.prepare_input(data)
        mel = self.get_audio(data)
        durations = self._load_durations(data, len(tokens), len(mel))
        pitch, energy = self._load_variances(data, durations, len(mel))
        return (tokens, durations, pitch, energy), (mel, durations, pitch, energy)

    def filter_data(self, inputs, outputs):
        return (len(inputs[0]) <= self.max_input_length
                and outputs[0].shape[0] <= self.max_output_length)

    def get_padding_values(self):
        return ((self.blank_token_idx, 0, 0., 0.), (self.pad_mel_value, 0, 0., 0.))

    def collate(self, batch):
        inputs, outputs = zip(* batch)
        tokens = pad_batch([i[0] for i in inputs], pad_value = self.blank_token_idx)
        durations = pad_batch([i[1] for i in inputs], pad_value = 0)
        pitch = pad_batch([i[2] for i in inputs], pad_value = 0.)
        energy = pad_batch([i[3] for i in inputs], pad_value = 0.)
        mel = pad_batch([o[0] for o in outputs], pad_value = self.pad_mel_value)
        return (tokens, durations, pitch, energy), (mel, durations, pitch, energy)

    def bucket_pad(self, batch, *, token_multiple = 32, frame_multiple = 64):
        """The trainer's bucketing hook: tokens, durations (and phoneme-level
        variances) to `token_multiple`, the mel (and frame-level variances)
        to `frame_multiple`; the durations still sum to the true mel length
        and the padding is masked."""
        (tokens, durations, pitch, energy), (mel, * _) = batch
        tokens = pad_to_multiple(np.asarray(tokens), token_multiple, axis = 1,
                                 constant_values = self.blank_token_idx)
        durations = pad_to_multiple(np.asarray(durations), token_multiple, axis = 1)
        mel = pad_to_multiple(np.asarray(mel), frame_multiple, axis = 1,
                              constant_values = self.pad_mel_value)
        multiple = token_multiple if self.variance_level == 'phoneme' else frame_multiple
        pitch = pad_to_multiple(np.asarray(pitch), multiple, axis = 1)
        energy = pad_to_multiple(np.asarray(energy), multiple, axis = 1)
        inputs = (tokens, durations, pitch, energy)
        return inputs, (mel, durations, pitch, energy)
