"""VITS task model: text → waveform in one pass, the model its own vocoder.

Counterpart of the inference part of ``text_to_speech_tpu/models/tts/vits.py``:
a `Tacotron2` task (text splitting, cleaning and encoding, `predict`,
`predict_batched`, the callbacks and ``map.json``, `stream`, `tts()`) whose
`compiled_infer` runs `vits_arch.VITS.infer` and already returns waveforms.
`is_end_to_end` makes `tts(text, model = vits)` resolve the vocoder to the
model itself (`models.tts.get_models`), and `infer` / `predict` / `stream`
default their vocoder to it.

`compiled_infer` pads the tokens to a multiple of `padding_multiple` (64)
and sizes the frame buffer as the JAX package does: `max_length` (a float
is a multiple of the padded token count) clamped to `max_output_length`
and `max_position`, rounded up to the multiple.  The controls
`noise_scale`, `noise_scale_w` and `d_control` reach the architecture as
float32 tensors, as the JAX package's are float32 arrays; the noise comes
from `generator` (the global generator when None).
`_synthesize_and_vocode` runs every chunk in one call and never falls back
to the retry path: durations do not change on a retry, so a
frames-per-token ratio outside the gates is logged and the output kept.
`last_timings` splits a call into the text → latent part (``decode_s``)
and the generator (``vocode_s``).

`create` seeds `init.init_vits`; `from_torch_pretrained` imports an
official ``SynthesizerTrn`` checkpoint (`models.tts_checkpoints.convert_vits`,
the sizes from its shapes; the tokenizer must reproduce its symbol table)
and saves it.  `fit` trains it adversarially, its only objective
(`train.gan.fit_gan`), on (tokens, linear spectrogram, frames, waveform)
rows from `prepare_data`.
"""

import logging

import numpy as np
import torch

from ...init import init_vits
from ...loggers import Timer, timer
from ...ops.audio_io import load_audio
from ...ops.stft import MelSTFT
from ...text import get_tokenizer
from ...utils.sequence_utils import pad_batch, pad_to_multiple
from ...weights import vits_from_jax, vits_to_jax
from ..tts_checkpoints import (
    _load_state_dict, convert_vits, remove_torch_weight_norm, vits_config_from_state_dict)
from ..vits_arch import VITS as VITSArch, VITSInferenceOutput
from .tacotron2 import Tacotron2, _Clock

logger = logging.getLogger(__name__)


class VITS(Tacotron2):
    arch_class = VITSArch
    #: `tts()` resolves the vocoder to the model itself
    is_end_to_end = True

    def __init__(self, params, state = None, *, name = 'vits', ** kwargs):
        super().__init__(params, state or {}, name = name, ** kwargs)
        if self.arch.upsample_rate != self.mel_fn.hop_length:
            logger.warning('generator upsampling (%d) != STFT hop (%d): training '
                           'spectrograms and waveform segments will be misaligned',
                           self.arch.upsample_rate, self.mel_fn.hop_length)

    @classmethod
    def from_jax(cls, params, state = None, ** kwargs):
        """From the JAX package's params tree (numpy arrays); VITS has no state."""
        return cls(vits_from_jax(params), {}, ** kwargs)

    def jax_trees(self):
        return {'params': vits_to_jax(self.params)}

    @staticmethod
    def _random_trees(hp, seed):
        return init_vits(hp, seed = seed), {}

    @classmethod
    def create(cls, lang = 'en', *, mel_fn = 'TacotronSTFT', ** kwargs):
        """`Tacotron2.create`, the linear spectrogram's bins (`spec_channels`)
        from the mel front end's filter length."""
        mel_fn = MelSTFT.create(mel_fn)
        kwargs.setdefault('spec_channels', mel_fn.filter_length // 2 + 1)
        return super().create(lang, mel_fn = mel_fn, ** kwargs)

    @classmethod
    def from_torch_pretrained(cls, checkpoint, *, name = 'pretrained_vits', lang = 'en',
                              config = None, root = None, device = None, tokenizer = None,
                              ** kwargs):
        """Import an official VITS checkpoint (a state dict, or a ``.pt`` /
        ``.pth`` / ``.safetensors`` file) as `name` under `root`.  The sizes
        come from its shapes; `config` overrides what they cannot say (the
        pad token, `upsample_rates` if not kernel // 2).  `tokenizer` (by
        default `lang`'s) must reproduce the checkpoint's symbol table: a
        vocabulary of another size is warned about.  The model is saved."""
        sd = remove_torch_weight_norm(_load_state_dict(checkpoint))
        inferred = vits_config_from_state_dict(sd)
        inferred.update(config or {})
        tokenizer = get_tokenizer(tokenizer, lang = lang)
        if len(tokenizer) != inferred['vocab_size']:
            logger.warning('tokenizer vocab (%d) != checkpoint embedding table (%d): '
                           'pass a `tokenizer` matching the original training config',
                           len(tokenizer), inferred['vocab_size'])
        model = cls.from_jax(convert_vits(sd), name = name, lang = lang, root = root,
                             device = device, tokenizer = tokenizer, ** {** inferred, ** kwargs})
        model.save()
        return model

    @property
    def upsample_rate(self):
        return self.arch.upsample_rate

    # -- inference ---------------------------------------------------------------------

    def compiled_infer(self,
                       tokens,
                       *,
                       embeddings = None,
                       max_length = None,
                       padding_multiple = 64,
                       noise_scale = 0.667,
                       noise_scale_w = 0.8,
                       d_control = 1.,
                       min_duration = 0,
                       dtype = None,
                       generator = None,
                       clock = None,
                       ** _):
        """One parallel text → waveform pass on a padded token batch (B, S)
        → `VITSInferenceOutput` of device tensors; `embeddings`: the
        speaker, (D,) or a row per text, for a model with a speaker
        projection.  `clock` gets a mark before the pass, after the latent
        and after the generator."""
        tokens = np.asarray(tokens)
        if tokens.ndim == 1: tokens = tokens[None]
        tokens = pad_to_multiple(tokens, padding_multiple, axis = 1,
                                 constant_values = self.blank_token_idx)
        # no positional table over the frames: the buffer may round past max_position
        max_frames = self._max_frames(tokens.shape[1], max_length, padding_multiple,
                                      within_position = False)
        spk = self._speaker_rows(embeddings, tokens.shape[0])
        controls = torch.tensor([noise_scale, d_control, noise_scale_w], dtype = torch.float32,
                                device = self.device)
        params = self._cast_params(dtype)
        arch = self.arch
        with torch.no_grad():
            if clock is not None: clock.mark()
            z, cond, lengths, durations, align = arch.infer_latent(
                params, torch.as_tensor(tokens, dtype = torch.long, device = self.device),
                speaker_embedding = None if spk is None else torch.tensor(spk, device = self.device),
                max_frames = max_frames, noise_scale = controls[0], d_control = controls[1],
                noise_scale_w = controls[2], min_duration = int(min_duration), dtype = dtype,
                generator = generator)
            if clock is not None: clock.mark()
            audio = arch.decode_frames(params, z, cond, dtype = dtype)
            if clock is not None: clock.mark()
        return VITSInferenceOutput(
            audio = audio.float(), lengths = lengths, stop_tokens = None,
            attention_weights = align, decoder_output = None, durations = durations)

    @timer(name = 'inference VITS')
    def infer(self, text, *, vocoder = None, min_fpt_ratio = 0., max_fpt_ratio = float('inf'),
              max_length = 10., ** kwargs):
        """`Tacotron2.infer` with the model as its own vocoder and the
        frames-per-token gates off (durations are explicit and bounded)."""
        return super().infer(text, vocoder = vocoder or self, min_fpt_ratio = min_fpt_ratio,
                             max_fpt_ratio = max_fpt_ratio, max_length = max_length, ** kwargs)

    def predict(self, inputs, *, vocoder = None, ** kwargs):
        return super().predict(inputs, vocoder = vocoder or self, ** kwargs)

    def stream(self, stream, *, vocoder = None, ** kwargs):
        return super().stream(stream, vocoder = vocoder or self, ** kwargs)

    def _synthesize_and_vocode(self, encoded, vocoder, *, embeddings = None, max_length = 10.,
                               min_fpt_ratio = 0., max_fpt_ratio = float('inf'),
                               vocoder_config = {}, fetch_attention = True, ** kwargs):
        """One end-to-end call for every chunk (the synthesizer is the
        vocoder).  Never falls back: a ratio outside the gates is logged and
        the output kept.  Returns (mels (None each: no mel hand-off),
        attention, audios)."""
        tokens = pad_batch(encoded, pad_value = self.blank_token_idx)
        clock = _Clock(self.device)
        with Timer('compiled_infer'):
            outputs = self.compiled_infer(tokens, embeddings = embeddings, max_length = max_length,
                                          clock = clock, ** {** kwargs, ** vocoder_config})
        out_lengths = outputs.lengths.cpu().numpy()
        for i, e in enumerate(encoded):
            ratio = float(out_lengths[i]) / max(len(e), 1)
            if not (min_fpt_ratio < ratio < max_fpt_ratio):
                logger.info('chunk %d frames/token %.2f outside (%s, %s); keeping the output '
                            '(durations are deterministic)', i, ratio, min_fpt_ratio,
                            max_fpt_ratio)
        audio_host = outputs.audio.cpu().numpy()
        attn_host = outputs.attention_weights.cpu().numpy() if fetch_attention else None
        decode_s, vocode_s = clock.seconds()
        self.last_timings = {'decode_s': decode_s, 'vocode_s': vocode_s}
        rate = self.upsample_rate
        mels, attn, audios = [], [], []
        for i in range(len(encoded)):
            out_len = max(1, int(out_lengths[i]))
            mels.append(None)
            attn.append(attn_host[i, :out_len] if attn_host is not None else None)
            audios.append(audio_host[i, : out_len * rate])
        return mels, attn, audios

    # -- training (adversarial: `train.gan.fit_gan`) ---------------------------------

    def fit(self, data, ** kwargs):
        """Adversarial training: `train.gan.fit_gan` (History, checkpoints,
        the discriminators' and optimizers' state resumed)."""
        from ...train.gan import fit_gan
        return fit_gan(self, data, ** kwargs)

    def prepare_data(self, data):
        """A row (its text, and its audio as a WAV filename, an array or a
        dict) → (tokens, linear magnitude (F, n_fft // 2 + 1), F, waveform
        (F * hop,)), numpy; the magnitude from the mel front end's STFT on
        the model's device."""
        tokens = self.prepare_input(data)
        audio = np.asarray(load_audio(data, self.rate), np.float32)
        with torch.no_grad():
            magnitude, _ = self.mel_fn.stft_fn.transform(
                torch.as_tensor(audio[None], device = self.device))
        spec = magnitude[0].cpu().numpy()
        n_frames = min(spec.shape[0], len(audio) // self.mel_fn.hop_length)
        return tokens, spec[:n_frames], n_frames, audio[: n_frames * self.mel_fn.hop_length]

    def filter_data(self, * args):
        """Within the length limits, and no more tokens than frames (the
        monotonic alignment needs T >= L)."""
        if len(args) == 1: args = args[0]
        tokens, spec = args[0], args[1]
        return (len(tokens) <= self.max_input_length and len(tokens) <= spec.shape[0]
                and spec.shape[0] <= self.max_output_length)

    def get_padding_values(self):
        return (self.blank_token_idx, 0., 0, 0.)

    def collate(self, batch):
        """`prepare_data` rows → (tokens, spec, lengths, waveforms), padded
        with the blank token and zeros."""
        return (pad_batch([b[0] for b in batch], pad_value = self.blank_token_idx),
                pad_batch([b[1] for b in batch], pad_value = 0.),
                np.asarray([b[2] for b in batch], np.int32),
                pad_batch([b[3] for b in batch], pad_value = 0.))
