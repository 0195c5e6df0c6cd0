"""Tacotron-2 task model: text → mel (→ waveform via a vocoder).

Counterpart of ``text_to_speech_tpu/models/tts/tacotron2.py``: loading a
saved model, `clean_text` / `encode_text`, `compiled_infer` with the ×64
token padding and max-length bucketing, and the two synthesis flows:

  - `infer` (one text; what `predict` runs without a `batch_size`): a single
    chunk goes through `_tts_one_launch` → `compiled_tts`, decode → vocode →
    16-bit quantisation queued on the device with no host read in between;
    several chunks decode as one batch in `_synthesize_and_vocode`.  A
    frames-per-token ratio outside its gates falls to `_synthesize_chunks`,
    which retries the failing chunks with fresh prenet dropout.
  - `predict_batched` (lists with ``batch_size > 1``): the chunks of several
    texts share one decode batch, through the same helpers.

The decoder is the fused kernel (`arch.infer_fused`) or the plain loop
(`arch.infer`), chosen in `_use_fused_decoder`.

The JAX package's spans (`loggers`) time the flows on the host, around
dispatch: `predict`, `inference` (`infer`) with `processing` (cleaning and
tokenizing), `compiled_tts` (the one-launch path) and `compiled_infer`
(each other decode).

Not ported yet (see ROADMAP.md): windowed vocoding, the artifact callbacks
and the ``map.json`` cache, speaker embeddings, streaming.
"""

import logging
import os
import time

import numpy as np
import torch

from ...devices import default_device
from ...loggers import Timer, timer
from ...ops.decoder_kernel import kernel_weights_only, pack_decoder_weights
from ...text import Tokenizer, split_text, split_sentences
from ...weights import cast_tree, tacotron2_from_jax, tree_to
from ..saving import load_json, load_model_files
from ..tacotron2_arch import Tacotron2 as Tacotron2Arch

logger = logging.getLogger(__name__)

DEFAULT_MAX_MEL_LENGTH = 1024

# decode options that the vocoder must not see: they would change its own
# padding
_DECODE_ONLY = ('padding_multiple', 'use_fused_decoder', 'attn_mask_win_len',
                'attn_mask_offset', 'early_stopping')


class _Clock:
    """Marks along one device's queue: CUDA events on a card (no host
    synchronisation when a mark is taken), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        self.marks = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing = True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """Seconds between consecutive marks; on a card, call it after the
        work has been waited for."""
        if self.cuda:
            return [1e-3 * a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


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
        self.params = params
        self.state = tree_to(state, self.device)
        self.rate = rate
        self.pad_mel_value = pad_mel_value
        self.max_output_length = max_output_length
        self.last_timings = {}

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        """New parameters drop the decoder packed from the old ones."""
        self._params = tree_to(params, self.device)
        self._packed_decoder = {}

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

    def _bucket(self, tokens, max_length, padding_multiple):
        """Tokens (B, S) padded to a multiple of `padding_multiple`, and the
        decode buffer's length bucketed the same way (a float `max_length`
        is a multiple of the padded token length)."""
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
        return tokens, max_length

    def _use_fused_decoder(self, batch, seq_len, use_fused_decoder):
        """The decoder route.  By default the fused kernel on a card inside
        its envelope (`arch.supports_fused_decoder`), and the plain loop
        otherwise and on the CPU.  Asking for the kernel outside its
        envelope raises; so does, on a card, a model inside the envelope
        whose widths the CUDA kernel cannot take (`ops.decoder_kernel`)."""
        supported = self.arch.supports_fused_decoder(batch, seq_len)
        if use_fused_decoder is None:
            return self.device.type == 'cuda' and supported
        if use_fused_decoder and not supported:
            raise ValueError('use_fused_decoder=True outside the fused decoder\'s envelope '
                             '(batch {}, {} tokens, or the architecture)'.format(batch, seq_len))
        return bool(use_fused_decoder)

    def _decoder_weights(self, dtype):
        """The decoder packed for the fused kernel, once per compute dtype
        and set of parameters; on a card, in the kernel's layouts only."""
        if dtype not in self._packed_decoder:
            dec = self.params['decoder']
            packed = pack_decoder_weights(
                cast_tree(dec, dtype) if dtype is not None else dec,
                n_mel = self.arch.hp.n_mel_channels, dtype = dtype or torch.float32)
            if self.device.type == 'cuda':
                packed = kernel_weights_only(packed)
            self._packed_decoder[dtype] = packed
        return self._packed_decoder[dtype]

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
        """AR inference on one padded token batch (B, S), bucketed by
        `_bucket`, on the decoder route `_use_fused_decoder` picks."""
        tokens, max_length = self._bucket(tokens, max_length, padding_multiple)
        options = dict(
            generator = generator, max_length = max_length,
            early_stopping = early_stopping, attn_mask_win_len = attn_mask_win_len,
            attn_mask_offset = attn_mask_offset, deterministic = deterministic,
            dtype = dtype)
        tokens_dev = torch.as_tensor(tokens, dtype = torch.long, device = self.device)
        with torch.no_grad():
            if self._use_fused_decoder(* tokens.shape, use_fused_decoder):
                return self.arch.infer_fused(self.params, self.state, tokens_dev,
                                             weights = self._decoder_weights(dtype),
                                             ** options)
            return self.arch.infer(self.params, self.state, tokens_dev, ** options)

    def compiled_tts(self, tokens, vocoder, *, vocoder_config = {}, clock = None,
                     ** kwargs):
        """Text tokens → 16-bit PCM with no host read on the way: decode (as
        `compiled_infer`), pad the mel to the vocoder's multiple with its
        silence value, vocode, and quantise on the device as
        ``round(clip(audio, -1, 1) * 32767)``.

        Returns device tensors ``(audio_i16 (B, F * rate), lengths (B,),
        mel (B, F, n_mel), attention (B, F, S))``; nothing is fetched here.
        `clock` gets a mark before the decode, after it and after the
        vocoder.  The vocoder's options are `vocoder_config` alone, as in
        the JAX package: the decode's options (``deterministic`` among
        them) do not reach it."""
        voc_fn, voc_params, _ = vocoder.device_vocoder_fn(** vocoder_config)
        voc_pad = vocoder.serving_pad_multiple
        if clock is not None: clock.mark()
        out = self.compiled_infer(tokens, ** kwargs)
        if clock is not None: clock.mark()
        mel = out.mel
        if mel.shape[1] % voc_pad:
            # the decode buffer is bucketed by `padding_multiple`, the
            # vocoder's bucket may be coarser; frames past `lengths` are
            # cut off the audio anyway
            mel = torch.nn.functional.pad(
                mel, (0, 0, 0, voc_pad - mel.shape[1] % voc_pad), value = vocoder.pad_mel_value)
        audio = voc_fn(voc_params, mel, kwargs.get('generator'))
        a16 = torch.round(torch.clamp(audio, -1., 1.) * 32767.).to(torch.int16)
        if clock is not None: clock.mark()
        return a16, out.lengths, out.mel, out.attention_weights

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

    @timer(name = 'inference')
    def infer(self,
              text,
              *,
              max_length = 10.,
              max_text_length = -1,
              max_trial = 5,
              min_fpt_ratio = 2.,
              max_fpt_ratio = 10.,
              vocoder = None,
              silence_time = 0.15,
              vocoder_config = {},
              batch_chunks = True,
              fetch_attention = None,
              ** kwargs):
        """Synthesize one text (possibly split into chunks).

        With `batch_chunks` all chunks decode as one padded batch.  The
        frames-per-token gates (`min_fpt_ratio`, `max_fpt_ratio`) catch
        degenerate attention (too short, or runaway); only the failing
        chunks are retried, with fresh prenet dropout, up to `max_trial`
        times, and the last output is kept.

        Returns {'text', 'cleaned', 'splitted', 'mel' and 'attention' (one
        entry per chunk), and with a vocoder 'audio', 'rate', 'time'}.
        Attention maps are fetched by default on the sequential (retry)
        path; on the paths that queue the vocoder behind the decoder their
        entries are None unless ``fetch_attention=True``."""
        for name in ('callbacks', 'predicted', 'embeddings'):
            if name in kwargs:
                raise TypeError('infer() does not take `{}` yet: see ROADMAP.md'.format(name))
        if isinstance(text, dict):
            text = text.get('text', text.get('content'))
        with Timer('processing'):
            splitted, encoded = self._split_and_encode(text, max_text_length)
            cleaned = '\n\n'.join(splitted) if len(splitted) > 1 else (
                splitted[0] if splitted else '')

        fa_sequential = True if fetch_attention is None else fetch_attention
        fa_pipelined = False if fetch_attention is None else fetch_attention

        mels, attn_weights, audios = [], [], []
        if encoded:
            mels, attn_weights, audios = self._synthesize(
                encoded, vocoder, max_length = max_length, max_trial = max_trial,
                min_fpt_ratio = min_fpt_ratio, max_fpt_ratio = max_fpt_ratio,
                vocoder_config = vocoder_config, batch_chunks = batch_chunks,
                fa_sequential = fa_sequential, fa_pipelined = fa_pipelined, ** kwargs)

        output = {'text': text, 'cleaned': cleaned, 'splitted': splitted,
                  'mel': mels, 'attention': attn_weights}
        if vocoder is not None:
            output.update(self._audio_infos(audios, silence_time))
        return output

    def _audio_infos(self, audios, silence_time = 0.15):
        if audios:
            audio = audios[0] if len(audios) == 1 else np.concatenate(audios, axis = 0)
        else:
            audio = np.zeros((int(silence_time * self.rate),), np.float32)
        return {'audio': audio, 'rate': self.rate, 'time': len(audio) / self.rate}

    def _synthesize(self, encoded, vocoder, *, max_length, max_trial, min_fpt_ratio,
                    max_fpt_ratio, vocoder_config, fa_sequential, fa_pipelined,
                    batch_chunks = True, ** kwargs):
        """(mels, attention, audios) of the chunks: the vocoder queued behind
        the decoder when the chunks decode as one batch and the ratio gates
        pass, else the sequential path with its retries."""
        if vocoder is not None and batch_chunks:
            done = self._synthesize_and_vocode(
                encoded, vocoder, max_length = max_length, min_fpt_ratio = min_fpt_ratio,
                max_fpt_ratio = max_fpt_ratio, vocoder_config = vocoder_config,
                fetch_attention = fa_pipelined, ** kwargs)
            if done is not None:
                return done
        start = time.perf_counter()
        mels, attn = self._synthesize_chunks(
            encoded, max_length = max_length, max_trial = max_trial,
            min_fpt_ratio = min_fpt_ratio, max_fpt_ratio = max_fpt_ratio,
            batch_chunks = batch_chunks, fetch_attention = fa_sequential, ** kwargs)
        decode_s = time.perf_counter() - start
        start = time.perf_counter()
        audios = []
        if vocoder is not None:
            audios = self._vocode_chunks(vocoder, mels, batch_chunks = batch_chunks,
                                         ** {** kwargs, ** vocoder_config})
        self.last_timings = {'decode_s': decode_s,
                             'vocode_s': time.perf_counter() - start}
        return mels, attn, audios

    def _passes_gates(self, out_lengths, token_lengths, min_fpt_ratio, max_fpt_ratio, what):
        for i, n_tokens in enumerate(token_lengths):
            ratio = float(out_lengths[i]) / max(n_tokens, 1)
            if not (min_fpt_ratio < ratio < max_fpt_ratio):
                logger.info('%s chunk %d rejected (frames/token %.2f); falling back '
                            'to the retry path', what, i, ratio)
                return False
        return True

    def _synthesize_and_vocode(self, encoded, vocoder, *, max_length = 10.,
                               min_fpt_ratio = 2., max_fpt_ratio = 10.,
                               vocoder_config = {}, vocoder_batch = None,
                               fetch_attention = True, ** kwargs):
        """Decode → vocode with the vocoder queued on the device mel before
        any host read.  Returns (mels, attention, audios), or None on a
        frames-per-token gate failure: the caller's retry path then decodes
        again, chunk by chunk."""
        if kwargs.pop('win_len', None) or vocoder_config.get('win_len'):
            raise NotImplementedError('windowed vocoding is not ported yet: see ROADMAP.md')

        if len(encoded) == 1:
            return self._tts_one_launch(
                encoded, vocoder, max_length = max_length, min_fpt_ratio = min_fpt_ratio,
                max_fpt_ratio = max_fpt_ratio, vocoder_config = vocoder_config,
                fetch_attention = fetch_attention, ** kwargs)

        tokens = pad_batch(encoded, pad_value = self.blank_token_idx)
        clock = _Clock(self.device)
        clock.mark()
        with Timer('compiled_infer'):
            outputs = self.compiled_infer(tokens, max_length = max_length, ** kwargs)
        clock.mark()

        vkwargs = {** kwargs, ** vocoder_config}
        for k in _DECODE_ONLY:
            if k not in vocoder_config:
                vkwargs.pop(k, None)
        if vocoder_batch is None:
            vocoder_batch = vkwargs.get('vocoder_batch') or 8
        # the vocoder launches are queued before the gate reads the lengths
        audio_dev = [vocoder.compiled_infer(outputs.mel[lo: lo + vocoder_batch], ** vkwargs)
                     for lo in range(0, len(encoded), vocoder_batch)]
        clock.mark()

        out_lengths = outputs.lengths.cpu().numpy()
        decode_s, vocode_s = clock.seconds()
        self.last_timings = {'decode_s': decode_s, 'vocode_s': vocode_s}
        if not self._passes_gates(out_lengths, [len(e) for e in encoded],
                                  min_fpt_ratio, max_fpt_ratio, 'pipelined'):
            return None

        mel_host = outputs.mel.cpu().numpy()
        attn_host = outputs.attention_weights.cpu().numpy() if fetch_attention else None
        audio_host = [a.cpu().numpy() for a in audio_dev]
        rate = vocoder.upsample_rate
        mels, attn, audios = [], [], []
        for i in range(len(encoded)):
            out_len = max(1, int(out_lengths[i]))
            mels.append(mel_host[i, :out_len])
            attn.append(attn_host[i, :out_len] if attn_host is not None else None)
            audios.append(audio_host[i // vocoder_batch][i % vocoder_batch, : out_len * rate])
        return mels, attn, audios

    def _tts_one_launch(self, encoded, vocoder, *, max_length = 10.,
                        min_fpt_ratio = 2., max_fpt_ratio = 10., vocoder_config = {},
                        fetch_attention = False, ** kwargs):
        """The single-sentence path over `compiled_tts`: decode → vocode →
        int16 queued on the device, then one wait and the reads.  The audio
        crosses to the host in 16 bits and is divided by 32767 there.
        Returns (mels, attention, audios), or None on a frames-per-token
        gate failure."""
        tokens = pad_batch(encoded, pad_value = self.blank_token_idx)
        clock = _Clock(self.device)
        with Timer('compiled_tts'):
            a16_dev, lengths_dev, mel_dev, attn_dev = self.compiled_tts(
                tokens, vocoder, max_length = max_length, vocoder_config = vocoder_config,
                clock = clock, ** kwargs)

        out_lengths = lengths_dev.cpu().numpy()
        decode_s, vocode_s = clock.seconds()
        self.last_timings = {'decode_s': decode_s, 'vocode_s': vocode_s}
        if not self._passes_gates(out_lengths, [len(e) for e in encoded],
                                  min_fpt_ratio, max_fpt_ratio, 'one-launch'):
            return None

        a16 = a16_dev.cpu().numpy()
        mel_host = mel_dev.cpu().numpy()
        attn_host = attn_dev.cpu().numpy() if fetch_attention else None
        rate = vocoder.upsample_rate
        mels, attn, audios = [], [], []
        for i in range(len(encoded)):
            out_len = max(1, int(out_lengths[i]))
            mels.append(mel_host[i, :out_len])
            attn.append(attn_host[i, :out_len] if attn_host is not None else None)
            audios.append(a16[i, : out_len * rate].astype(np.float32) / 32767.)
        return mels, attn, audios

    def _synthesize_chunks(self, encoded, *, max_length, max_trial, min_fpt_ratio,
                           max_fpt_ratio, batch_chunks = True, fetch_attention = True,
                           ** kwargs):
        """Decode every chunk, batched, with per-chunk ratio-gated retries;
        a retry draws fresh prenet dropout from the caller's generator.
        Returns (mels, attention) lists trimmed to each chunk's length
        (attention entries are None unless `fetch_attention`)."""
        n = len(encoded)
        lengths = [len(e) for e in encoded]
        mels, attn = [None] * n, [None] * n
        trials = max(1, max_trial)

        pending = list(range(n))
        for trial in range(trials):
            if not pending: break
            groups = [pending] if batch_chunks and len(pending) > 1 \
                else [[i] for i in pending]
            still_failing = []
            for group in groups:
                tokens = pad_batch([encoded[i] for i in group],
                                   pad_value = self.blank_token_idx)
                with Timer('compiled_infer'):
                    outputs = self.compiled_infer(tokens, max_length = max_length, ** kwargs)
                out_lengths = outputs.lengths.cpu().numpy()
                mel_host = outputs.mel.cpu().numpy()
                attn_host = outputs.attention_weights.cpu().numpy() \
                    if fetch_attention else None
                for row, i in enumerate(group):
                    ratio = float(out_lengths[row]) / max(lengths[i], 1)
                    ok = min_fpt_ratio < ratio < max_fpt_ratio
                    if ok or trial == trials - 1 or mels[i] is None:
                        # at least one frame, so that vocoding keeps a valid shape
                        out_len = max(1, int(out_lengths[row]))
                        mels[i] = mel_host[row, :out_len]
                        attn[i] = attn_host[row, :out_len] if attn_host is not None else None
                    if not ok:
                        logger.info('chunk %d attempt %d rejected (frames/token %.2f)',
                                    i, trial + 1, ratio)
                        still_failing.append(i)
            if still_failing and trial == trials - 1:
                logger.warning('%d chunk(s) failed %d retries; keeping last output',
                               len(still_failing), max_trial)
            pending = still_failing
        return mels, attn

    def _vocode_chunks(self, vocoder, mels, *, batch_chunks = True, vocoder_batch = None,
                       ** kwargs):
        """Vocode chunk mels: in padded sub-batches of `vocoder_batch` when
        their lengths are close (bounded padding waste), else one by one."""
        if kwargs.pop('win_len', None):
            raise NotImplementedError('windowed vocoding is not ported yet: see ROADMAP.md')
        for k in _DECODE_ONLY:
            kwargs.pop(k, None)
        if vocoder_batch is None: vocoder_batch = 8
        use_batch = (len(mels) > 1 and batch_chunks
                     and min(m.shape[0] for m in mels) >= max(m.shape[0] for m in mels) // 2)
        if not use_batch:
            return [vocoder(mel, ** kwargs)[0] for mel in mels]
        rate = vocoder.upsample_rate
        audios = []
        for start in range(0, len(mels), vocoder_batch):
            group = mels[start: start + vocoder_batch]
            batch = pad_batch(group, pad_value = self.pad_mel_value)
            audio = vocoder.compiled_infer(batch, ** kwargs).cpu().numpy()
            audios.extend(audio[i, : m.shape[0] * rate] for i, m in enumerate(group))
        return audios

    def predict_batched(self,
                        texts,
                        *,
                        batch_size = 8,
                        vocoder = None,
                        max_length = 10.,
                        max_text_length = -1,
                        max_trial = 5,
                        min_fpt_ratio = 2.,
                        max_fpt_ratio = 10.,
                        vocoder_config = {},
                        fetch_attention = None,
                        ** kwargs
                       ):
        """Synthesize `texts`: all chunks of up to `batch_size` texts decode
        as one batch, and vocoding is batched the same way.  Returns one
        dict per text, as `infer` does, under the same attention-fetch
        contract and ratio gates.  `last_timings` holds the decode and
        vocode seconds of the last group."""
        texts = [t.get('text', t.get('content')) if isinstance(t, dict) else t
                 for t in texts]
        fa_sequential = True if fetch_attention is None else fetch_attention
        fa_pipelined = False if fetch_attention is None else fetch_attention

        results = []
        for group_start in range(0, len(texts), batch_size):
            group = texts[group_start: group_start + batch_size]
            flat, owners, metas = [], [], []
            for idx, text in enumerate(group):
                splitted, encoded = self._split_and_encode(text, max_text_length)
                metas.append(splitted)
                flat.extend(encoded)
                owners.extend([idx] * len(encoded))

            mels, attns, audios = [], [], []
            if flat:
                mels, attns, audios = self._synthesize(
                    flat, vocoder, max_length = max_length,
                    max_trial = max_trial, min_fpt_ratio = min_fpt_ratio,
                    max_fpt_ratio = max_fpt_ratio, vocoder_config = vocoder_config,
                    fa_sequential = fa_sequential, fa_pipelined = fa_pipelined, ** kwargs)

            for idx, text in enumerate(group):
                splitted = metas[idx]
                rows = [i for i, o in enumerate(owners) if o == idx]
                output = {
                    'text': text,
                    'cleaned': '\n\n'.join(splitted) if len(splitted) > 1
                               else (splitted[0] if splitted else ''),
                    'splitted': splitted,
                    'mel': [mels[i] for i in rows],
                    'attention': [attns[i] for i in rows],
                }
                if vocoder is not None:
                    output.update(self._audio_infos([audios[i] for i in rows]))
                results.append(output)
        return results

    @timer(name = 'predict')
    def predict(self, inputs, *, batch_size = None, ** kwargs):
        """One output dict per text.  A list with ``batch_size > 1`` is
        synthesized in cross-text batches (`predict_batched`); otherwise
        each text goes through `infer` on its own."""
        if isinstance(inputs, (str, dict)): inputs = [inputs]
        if batch_size and batch_size > 1 and isinstance(inputs, (list, tuple)):
            return self.predict_batched(list(inputs), batch_size = batch_size, ** kwargs)
        return [self.infer(text, ** kwargs) for text in inputs]
