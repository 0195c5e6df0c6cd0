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
the JAX package's does.  The training data pipeline is not ported.
"""

import numpy as np
import torch

from ...loggers import timer
from ...weights import cast_tree, convert_tree
from ..fastspeech2_arch import FastSpeech2 as FastSpeech2Arch
from .tacotron2 import Tacotron2, pad_to_multiple


class FastSpeech2(Tacotron2):
    arch_class = FastSpeech2Arch

    def __init__(self, params, state, *, name = 'fastspeech2', ** kwargs):
        super().__init__(params, state, name = name, ** kwargs)

    @classmethod
    def from_jax(cls, params, state, ** kwargs):
        """From the JAX package's (params, state) trees (numpy arrays)."""
        return cls(convert_tree(params), convert_tree(state), ** kwargs)

    @property
    def variance_level(self):
        return self.arch.hp.variance_level

    def _weights(self, dtype):
        """(params, state) cast to `dtype`, once per dtype and set of params."""
        if dtype is None:
            return self.params, self.state
        key = ('cast', dtype)
        if key not in self._derived:
            self._derived[key] = cast_tree(self.params, dtype)
        return self._derived[key], cast_tree(self.state, dtype)

    def _max_frames(self, n_tokens, max_length, padding_multiple):
        """The frame buffer: `max_length` (a float: a multiple of the padded
        token count) clamped to `max_output_length` and `max_position`,
        rounded up to `padding_multiple`, and clamped below `max_position`
        again, where the positional table ends."""
        hp = self.arch.hp
        if max_length is None:
            max_length = hp.max_frames
        elif isinstance(max_length, float):
            max_length = int(n_tokens * max_length)
        max_frames = int(min(max_length, self.max_output_length, hp.max_position))
        max_frames = -(-max_frames // padding_multiple) * padding_multiple
        if max_frames > hp.max_position:
            max_frames = (hp.max_position // padding_multiple) * padding_multiple
        return max_frames

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
