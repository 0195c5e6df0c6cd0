"""Tacotron-2 task model: text → mel (→ waveform via a vocoder).

Counterpart of ``text_to_speech_tpu/models/tts/tacotron2.py``: loading a
saved model, `clean_text` / `encode_text`, `compiled_infer` with the ×64
token padding and max-length bucketing, and the `predict_batched` flow —
split, clean, tokenize, decode every chunk as one batch, vocode the decode
buffer, trim each chunk to its length.

Not ported yet (see ROADMAP.md): the frames-per-token retry loop, the
artifact callbacks and the ``map.json`` cache, and the fused decoder kernel.
"""

import os
import time

import numpy as np
import torch

from ...devices import default_device
from ...text import Tokenizer, split_text, split_sentences
from ...weights import tacotron2_from_jax, tree_to
from ..saving import load_json, load_model_files
from ..tacotron2_arch import Tacotron2 as Tacotron2Arch

DEFAULT_MAX_MEL_LENGTH = 1024


def pad_batch(batch, pad_value = 0):
    """Stack 1-D arrays into one (len(batch), max_len) array."""
    out = np.full((len(batch), max(len(b) for b in batch)), pad_value,
                  dtype = np.asarray(batch[0]).dtype)
    for i, b in enumerate(batch):
        out[i, :len(b)] = b
    return out


def pad_to_multiple(data, multiple, axis = 0, constant_values = 0):
    rem = data.shape[axis] % multiple
    if rem == 0: return data
    pads = [(0, 0)] * data.ndim
    pads[axis] = (0, multiple - rem)
    return np.pad(data, pads, mode = 'constant', constant_values = constant_values)


class Tacotron2:
    def __init__(self, params, state, *, tokenizer, name = 'tacotron2',
                 device = None, rate = 22050, pad_mel_value = -11.,
                 max_output_length = DEFAULT_MAX_MEL_LENGTH, ** arch_config):
        """`params`, `state`: the port's trees (`weights.tacotron2_from_jax`)."""
        self.name = name
        self.device = default_device(device)
        self.tokenizer = tokenizer
        self.arch = Tacotron2Arch(** arch_config)
        self.params = tree_to(params, self.device)
        self.state = tree_to(state, self.device)
        self.rate = rate
        self.pad_mel_value = pad_mel_value
        self.max_output_length = max_output_length
        self.last_timings = {}

    @classmethod
    def from_jax(cls, params, state, ** kwargs):
        """From the JAX package's (params, state) trees (numpy arrays)."""
        return cls(* tacotron2_from_jax(params, state), ** kwargs)

    @classmethod
    def from_pretrained(cls, name, *, root = None, device = None):
        """Load a saved Tacotron-2 (the JAX package's directory layout)."""
        files = load_model_files(name, root = root)
        saving = os.path.join(files['dir'], 'saving')
        arch = {k: v for k, v in files['architecture'].items() if k != 'architecture'}
        config = files['config'].get('config', {})
        mel_fn = load_json(os.path.join(saving, 'mel_fn.json'))
        return cls.from_jax(
            files['params'], files['state'], name = name, device = device,
            tokenizer = Tokenizer.load_from_file(os.path.join(saving, 'tokenizer.json')),
            rate = mel_fn.get('sampling_rate', 22050),
            pad_mel_value = config.get('pad_mel_value', -11.),
            max_output_length = config.get('max_output_length', DEFAULT_MAX_MEL_LENGTH),
            ** arch)

    # -- text ------------------------------------------------------------------

    @property
    def blank_token_idx(self):
        return self.tokenizer.blank_token_idx

    def clean_text(self, text, ** kwargs):
        return self.tokenizer.clean_text(text, ** kwargs)

    def encode_text(self, text, ** kwargs):
        return self.tokenizer.encode(text, ** kwargs)

    # -- inference -------------------------------------------------------------

    def compiled_infer(self,
                       tokens,
                       *,
                       max_length = None,
                       padding_multiple = 64,
                       attn_mask_win_len = None,
                       attn_mask_offset = 0.5,
                       early_stopping = True,
                       deterministic = False,
                       dtype = None,
                       generator = None,
                       use_fused_decoder = None,
                       ** _):
        """AR inference on one padded token batch (B, S): tokens pad to a
        multiple of `padding_multiple`, and so does the decode buffer
        (`max_length` frames; a float is a multiple of the padded token
        length)."""
        tokens = np.asarray(tokens)
        if tokens.ndim == 1: tokens = tokens[None]
        tokens = pad_to_multiple(tokens, padding_multiple, axis = 1,
                                 constant_values = self.blank_token_idx)
        if max_length is None:
            max_length = self.arch.hp.max_decoder_steps
        elif isinstance(max_length, float):
            max_length = int(tokens.shape[1] * max_length)
        max_length = int(min(max_length, self.max_output_length))
        max_length = -(-max_length // padding_multiple) * padding_multiple

        # The JAX package picks its fused decoder kernel (decoder_steps) for
        # batches of <= 2 on its accelerator.  That kernel is not ported yet,
        # so the default is the plain decoder for every batch.
        if use_fused_decoder:
            raise NotImplementedError(
                'the fused decoder kernel (decoder_steps) is not ported yet: '
                'see ROADMAP.md')
        with torch.no_grad():
            return self.arch.infer(
                self.params, self.state,
                torch.as_tensor(tokens, dtype = torch.long, device = self.device),
                generator = generator, max_length = max_length,
                early_stopping = early_stopping, attn_mask_win_len = attn_mask_win_len,
                attn_mask_offset = attn_mask_offset, deterministic = deterministic,
                dtype = dtype)

    def _split_and_encode(self, text, max_text_length):
        if max_text_length == -1:
            splitted = [text]
        elif max_text_length == -2:
            splitted = split_sentences(text)
        else:
            splitted = split_text(text, max_text_length)
        splitted = [self.clean_text(s) for s in splitted]
        splitted = [s for s in splitted if any(c.isalnum() for c in s)]
        encoded = [self.encode_text(s, cleaned = True) for s in splitted]
        keep = [i for i, e in enumerate(encoded) if len(e)]
        return [splitted[i] for i in keep], [encoded[i] for i in keep]

    def predict_batched(self,
                        texts,
                        *,
                        batch_size = 8,
                        vocoder = None,
                        max_length = 10.,
                        max_text_length = -1,
                        vocoder_batch = 8,
                        vocoder_config = {},
                        ** kwargs
                       ):
        """Synthesize `texts`: the chunks of up to `batch_size` texts decode
        as one batch; the decode buffer is vocoded in sub-batches of
        `vocoder_batch` rows; each chunk is trimmed to its decoded length.
        Returns one dict per text: {'text', 'cleaned', 'splitted', 'mel'
        (list of (frames, n_mel) arrays), and with a vocoder 'audio',
        'rate', 'time'}.  `last_timings` holds the decode and vocode seconds
        of the last group."""
        vkwargs = {k: v for k, v in kwargs.items()
                   if k in ('deterministic', 'dtype', 'generator', 'sigma')}
        vkwargs.update(vocoder_config)
        results = []
        for group_start in range(0, len(texts), batch_size):
            group = texts[group_start: group_start + batch_size]
            flat, owners, metas = [], [], []
            for idx, text in enumerate(group):
                splitted, encoded = self._split_and_encode(text, max_text_length)
                metas.append(splitted)
                flat.extend(encoded)
                owners.extend([idx] * len(encoded))

            mels, audios = [], []
            if flat:
                start = time.perf_counter()
                tokens = pad_batch(flat, pad_value = self.blank_token_idx)
                out = self.compiled_infer(tokens, max_length = max_length, ** kwargs)
                lengths = out.lengths.cpu().numpy()      # waits for the decode
                decode_s = time.perf_counter() - start

                start = time.perf_counter()
                audio_rows = []
                if vocoder is not None:
                    for lo in range(0, len(flat), vocoder_batch):
                        audio_rows.append(vocoder.compiled_infer(
                            out.mel[lo: lo + vocoder_batch], ** vkwargs).cpu().numpy())
                    audio_rows = np.concatenate(audio_rows, axis = 0)
                self.last_timings = {'decode_s': decode_s,
                                     'vocode_s': time.perf_counter() - start}

                mel_host = out.mel.cpu().numpy()
                rate = getattr(vocoder, 'upsample_rate', 256)
                for i in range(len(flat)):
                    out_len = max(1, int(lengths[i]))
                    mels.append(mel_host[i, :out_len])
                    if vocoder is not None:
                        audios.append(audio_rows[i, :out_len * rate])

            for idx, text in enumerate(group):
                splitted = metas[idx]
                rows = [i for i, o in enumerate(owners) if o == idx]
                output = {
                    'text': text,
                    'cleaned': '\n\n'.join(splitted) if len(splitted) > 1
                               else (splitted[0] if splitted else ''),
                    'splitted': splitted,
                    'mel': [mels[i] for i in rows],
                }
                if vocoder is not None:
                    chunks = [audios[i] for i in rows]
                    audio = (chunks[0] if len(chunks) == 1 else np.concatenate(chunks)) \
                        if chunks else np.zeros((int(0.15 * self.rate),), np.float32)
                    output.update(audio = audio, rate = self.rate,
                                  time = len(audio) / self.rate)
                results.append(output)
        return results

    def predict(self, inputs, *, batch_size = None, ** kwargs):
        """`predict_batched` over one text or a list; without `batch_size`
        each text decodes on its own (its chunks still share one batch)."""
        if isinstance(inputs, str): inputs = [inputs]
        return self.predict_batched(list(inputs), batch_size = batch_size or 1, ** kwargs)
