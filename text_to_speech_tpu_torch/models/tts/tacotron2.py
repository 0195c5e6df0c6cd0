"""Tacotron-2 task model: text → mel (→ waveform via a vocoder).

Counterpart of ``text_to_speech_tpu/models/tts/tacotron2.py``: loading a
saved model, `clean_text` / `encode_text`, `compiled_infer` with the ×64
token padding and max-length bucketing, and the two synthesis flows:

  - `infer` (one text; what `predict` runs, on its `Stream` thread, without
    a `batch_size`): a single chunk goes through `_tts_one_launch` →
    `compiled_tts`, decode → vocode → 16-bit quantisation queued on the
    device with no host read in between; several chunks decode as one batch
    in `_synthesize_and_vocode`, and with a `win_len` the vocoder cuts the
    windows of the decoded mels on the device
    (`WaveGlow.vocode_windowed_from_device`; a `win_len` never takes the
    one-launch path, and a vocoder without that method, such as `HiFiGAN`,
    takes the sequential path, which vocodes each whole mel).  A frames-per-token ratio outside its gates falls to
    `_synthesize_chunks`, which retries the failing chunks with fresh prenet
    dropout, then `_vocode_chunks` (windowed: `vocode_windowed_batch`).
  - `predict_batched` (lists with ``batch_size > 1``): the chunks of several
    texts share one decode batch, through the same helpers.

Both take the inference callbacks (`get_inference_callbacks`: audio and mel
savers, the ``map.json`` prediction cache, playback, user functions and
queues); a text in the cache is answered from it without decoding.
`stream` runs `predict` over a queue or an iterator.

The decoder is the fused kernel (`arch.infer_fused`) or the plain loop
(`arch.infer`), chosen in `_use_fused_decoder`.

The JAX package's spans (`loggers`) time the flows on the host, around
dispatch: `predict`, `inference` (`infer`) with `processing` (cleaning and
tokenizing), `compiled_tts` (the one-launch path) and `compiled_infer`
(each other decode).

Training (`models.base_model.TrainableModel`): `create` makes a new model
as the JAX package's constructor does (a language, the hparams, a seed:
random weights, saved under ``<root>/<name>/``; with ``pretrained_name``
a saved model's weights transferred onto them, which
``from_pretrained(name, pretrained_name)`` runs); `prepare_data`, with the
group-rate inputs of a reduction factor, `filter_data`,
`get_padding_values` and `collate` feed `fit` (`train.trainer.fit`:
`TacotronLoss`, teacher forcing, `mixed_precision_ok`).

`save` writes the JAX package's directory layout, which both packages
load; `from_nvidia_pretrained` imports an NVIDIA Tacotron-2 checkpoint
(`models.tts_checkpoints`) and saves it, as the JAX package builds its
``en`` default ``pretrained_tacotron2``.

Speaker embeddings (`embeddings`, for a speaker-conditioned architecture;
`SV2TTSTacotron2` resolves them from tables, files or audio): a (D,) vector
or one row per chunk of the decode batch, broadcast to every decode, and
on the retry path each chunk keeps its row.
"""

import logging
import os
import shutil
import time

import numpy as np
import torch

from ...devices import default_device
from ...init import init_tacotron2
from ...loggers import Timer, timer
from ...ops.audio_io import load_mel
from ...ops.decoder_kernel import kernel_weights_only, pack_decoder_weights
from ...ops.stft import MelSTFT
from ...text import (
    Tokenizer, default_english_tokenizer, get_tokenizer, split_text, split_sentences)
from ...utils.callbacks import (
    AudioSaver, SpectrogramSaver, JSONSaver, AudioPlayer, FunctionCallback,
    QueueCallback, apply_callbacks,
)
from ...utils.file_utils import load_json
from ...utils.sequence_utils import pad_batch, pad_to_multiple
from ...weights import cast_tree, tacotron2_from_jax, tree_to, tree_to_jax
from ..base_model import BaseModel, TrainableModel, transfer_trees
from ..saving import load_model_files, model_dir
from ..tacotron2_arch import Tacotron2 as Tacotron2Arch
from ..tts_checkpoints import (
    _load_state_dict, convert_nvidia_tacotron2, tacotron2_config_from_state_dict)

logger = logging.getLogger(__name__)

DEFAULT_MAX_TEXT_LENGTH = 150
DEFAULT_MAX_MEL_LENGTH = 1024

# decode options that the vocoder must not see: they would change its own
# padding
_DECODE_ONLY = ('padding_multiple', 'use_fused_decoder', 'attn_mask_win_len',
                'attn_mask_offset', 'early_stopping', 'embeddings')


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


class Tacotron2(TrainableModel, BaseModel):
    arch_class = Tacotron2Arch
    _default_loss = 'TacotronLoss'
    mixed_precision_ok = True
    # constructor options of the task (the rest of `create`'s keywords are
    # the architecture's)
    _task_keys = ('pad_mel_value', 'max_input_length', 'max_output_length')

    def __init__(self, params, state, *, tokenizer, name = 'tacotron2',
                 device = None, rate = 22050, mel_fn = 'TacotronSTFT', lang = 'en',
                 pad_mel_value = -11., max_input_length = DEFAULT_MAX_TEXT_LENGTH,
                 max_output_length = DEFAULT_MAX_MEL_LENGTH, root = None, ** arch_config):
        """`params`, `state`: the port's trees (`weights.tacotron2_from_jax`).
        `mel_fn`: the mel front end the model was trained on (a `MelSTFT`,
        its config or class name, made at `rate`), saved with the model.
        `root`: the directory holding ``<name>/``, whose ``predictions/``
        the inference callbacks write by default (the pretrained-models root
        unless given)."""
        self.name = name
        self.root = root
        self.folder = model_dir(name, root = root)
        self.device = default_device(device)
        self.tokenizer = tokenizer
        self.arch = self.arch_class(** arch_config)
        self.params = params
        self.state = tree_to(state, self.device)
        if isinstance(mel_fn, str) and not os.path.isfile(mel_fn):
            mel_fn = MelSTFT.create(mel_fn, sampling_rate = rate)
        self.mel_fn = MelSTFT.create(mel_fn)
        self.rate = self.mel_fn.rate
        self.lang = lang
        self.pad_mel_value = pad_mel_value
        self.max_input_length = max_input_length
        self.max_output_length = max_output_length
        self.last_timings = {}

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        self._params = tree_to(params, self.device)
        self._weights_changed()

    @classmethod
    def from_jax(cls, params, state, ** kwargs):
        """From the JAX package's (params, state) trees (numpy arrays)."""
        return cls(* tacotron2_from_jax(params, state), ** kwargs)

    @classmethod
    def load_saved(cls, name, *, root = None, device = None, ** kwargs):
        """Load a saved model (the JAX package's directory layout);
        `kwargs` go to the constructor."""
        files = load_model_files(name, root = root)
        saving = os.path.join(files['dir'], 'saving')
        arch = {k: v for k, v in files['architecture'].items() if k != 'architecture'}
        config = files['config'].get('config', {})
        return cls.from_jax(
            files['params'], files['state'], name = name, device = device, root = root,
            tokenizer = Tokenizer.load_from_file(os.path.join(saving, 'tokenizer.json')),
            mel_fn = load_json(os.path.join(saving, 'mel_fn.json')),
            lang = config.get('lang', 'en'),
            pad_mel_value = config.get('pad_mel_value', -11.),
            max_input_length = config.get('max_input_length', DEFAULT_MAX_TEXT_LENGTH),
            max_output_length = config.get('max_output_length', DEFAULT_MAX_MEL_LENGTH),
            ** arch, ** kwargs)

    @classmethod
    def from_nvidia_pretrained(cls, checkpoint, *, name = 'pretrained_tacotron2', lang = 'en',
                               config = None, root = None, device = None, ** kwargs):
        """Import an NVIDIA-layout Tacotron-2 checkpoint (a state dict, or a
        ``.pt`` / ``.pth`` / ``.safetensors`` file) as `name` under `root`,
        as the JAX package's `from_nvidia_pretrained` does: the sizes come
        from the tensors' shapes, the vocabulary from the tokenizer (the
        English symbols with ``english_cleaners`` unless `tokenizer` is
        given), `config` overrides what the shapes cannot say (rates,
        flags); the model is saved, so that ``tts(lang = 'en', root = root)``
        finds it."""
        sd = _load_state_dict(checkpoint)
        inferred = tacotron2_config_from_state_dict(sd)
        inferred.pop('vocab_size', None)
        inferred.update(config or {})
        tokenizer = kwargs.pop('tokenizer', None) or default_english_tokenizer()
        model = cls.from_jax(
            * convert_nvidia_tacotron2(sd), name = name, lang = lang, root = root,
            device = device, tokenizer = tokenizer,
            ** {'pad_token': tokenizer.blank_token_idx, 'vocab_size': len(tokenizer),
                ** inferred, ** kwargs})
        model.save()
        return model

    @classmethod
    def create(cls, lang = 'en', *, name = None, seed = 0, root = None, device = None,
               tokenizer = None, mel_fn = 'TacotronSTFT', pretrained_name = None, ** kwargs):
        """A new model with random weights, the JAX package's constructor
        (``Tacotron2(lang, name = ..., ** hparams)``): the tokenizer from
        `tokenizer` or `lang` (`text.get_tokenizer`), the mel front end
        `mel_fn` (a `MelSTFT`, its config or class name), the architecture
        from the hparams in `kwargs` (its vocabulary, pad token and mel
        channels from the tokenizer and the mel front end), the task's own
        options (``_task_keys``) to the constructor, weights from the port's
        `init` seeded with `seed`, or, with `pretrained_name`, those weights
        with the saved model `pretrained_name`'s transferred onto them
        (`base_model.transfer_trees`).  The model is saved under
        ``<root>/<name>/`` (the constructor's default name unless given),
        where `from_pretrained` finds it."""
        tokenizer = get_tokenizer(tokenizer, lang = lang)
        mel_fn = MelSTFT.create(mel_fn)
        task = {k: kwargs.pop(k) for k in cls._task_keys if k in kwargs}
        arch = cls.arch_class(** {'pad_token': tokenizer.blank_token_idx,
                                  'vocab_size': tokenizer.vocab_size,
                                  'n_mel_channels': mel_fn.n_mel_channels, ** kwargs})
        with Timer('random init'):
            params, state = cls._random_trees(arch.hp, seed)
        if pretrained_name:
            params, state = transfer_trees(pretrained_name, params, state, root = root)
        if name: task['name'] = name
        model = cls.from_jax(params, state, tokenizer = tokenizer, lang = lang, root = root,
                             device = device, mel_fn = mel_fn, ** task, ** arch.get_config())
        with Timer('save'):
            model.save()
        return model

    @staticmethod
    def _random_trees(hp, seed):
        return init_tacotron2(hp, seed = seed)

    # -- saving ----------------------------------------------------------------

    def get_config(self):
        """The constructor's config that ``config.json`` holds."""
        return {'lang': self.lang, 'audio_format': 'mel', 'pad_mel_value': self.pad_mel_value,
                'max_input_length': self.max_input_length,
                'max_output_length': self.max_output_length}

    def get_saving_objects(self):
        return {'tokenizer.json': self.tokenizer, 'mel_fn.json': self.mel_fn}

    def jax_trees(self):
        trees = {'params': tree_to_jax(self.params)}
        if self.state: trees['state'] = tree_to_jax(self.state)
        return trees

    # -- text ------------------------------------------------------------------

    @property
    def blank_token_idx(self):
        return self.tokenizer.blank_token_idx

    def clean_text(self, text, ** kwargs):
        return self.tokenizer.clean_text(text, ** kwargs)

    def encode_text(self, text, ** kwargs):
        if isinstance(text, dict):
            text = text.get('text', text.get('content'))
        return self.tokenizer.encode(text, ** kwargs)

    prepare_input = encode_text

    # -- data processing (training) --------------------------------------------

    def get_audio(self, data):
        """The mel (frames, n_mel) of a row, filename or array, computed on
        the model's device, as numpy."""
        return load_mel(data, self.mel_fn, device = self.device).cpu().numpy()

    def prepare_output(self, data):
        """mel (T, n_mel) → (the mel after a leading zero frame, the gate:
        1 at the last frame)."""
        mel = np.pad(self.get_audio(data), [(1, 0), (0, 0)])
        gate = np.zeros((mel.shape[0],), np.float32)
        gate[-1] = 1.
        return mel, gate

    def prepare_data(self, data):
        """The teacher-forcing pair ((tokens, mel[:-1], steps), (mel[1:],
        gate[1:])).  With a reduction factor r > 1 the inputs are at group
        rate: step g reads ``mel[g r]`` (the frame before its first target)
        and `steps` counts the groups; the mel and the gate are padded to
        whole groups (with ``pad_mel_value`` and 1) and the targets stay at
        frame rate."""
        tokens = self.prepare_input(data)
        mel, gate = self.prepare_output(data)
        r = self.arch.hp.n_frames_per_step
        if r == 1:
            return (tokens, mel[:-1], len(mel) - 1), (mel[1:], gate[1:])
        n_groups = -(-(len(mel) - 1) // r)
        pad = 1 + n_groups * r - len(mel)
        if pad > 0:
            mel = np.pad(mel, ((0, pad), (0, 0)), constant_values = self.pad_mel_value)
            gate = np.concatenate([gate, np.ones((pad,), gate.dtype)])
        return (tokens, mel[0: n_groups * r: r], n_groups), (mel[1:], gate[1:])

    def filter_data(self, inputs, outputs):
        r = self.arch.hp.n_frames_per_step
        return (len(inputs[0]) <= self.max_input_length
                and inputs[-1] * r <= self.max_output_length)

    def get_padding_values(self):
        return ((self.blank_token_idx, self.pad_mel_value, 0), (self.pad_mel_value, 1.))

    def collate(self, batch):
        """`prepare_data` outputs → the padded numpy batch ((tokens, mel_in,
        steps), (mel_out, gate))."""
        inputs, outputs = zip(* batch)
        pad_in, pad_out = self.get_padding_values()
        tokens = pad_batch([i[0] for i in inputs], pad_value = pad_in[0])
        mel_in = pad_batch([i[1] for i in inputs], pad_value = pad_in[1])
        lengths = np.asarray([i[2] for i in inputs], np.int32)
        mel_out = pad_batch([o[0] for o in outputs], pad_value = pad_out[0])
        gate = pad_batch([o[1] for o in outputs], pad_value = pad_out[1])
        return (tokens, mel_in, lengths), (mel_out, gate)

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
        if dtype not in self._derived:
            dec = self.params['decoder']
            packed = pack_decoder_weights(
                cast_tree(dec, dtype) if dtype is not None else dec,
                n_mel = self.arch.hp.n_mel_channels, dtype = dtype or torch.float32)
            if self.device.type == 'cuda':
                packed = kernel_weights_only(packed)
            self._derived[dtype] = packed
        return self._derived[dtype]

    def _max_frames(self, n_tokens, max_length, padding_multiple, *, within_position = True):
        """The frame buffer of a parallel subclass (FastSpeech-2, VITS):
        `max_length` (a float: a multiple of the padded token count) clamped
        to `max_output_length` and `max_position`, rounded up to
        `padding_multiple`, and, `within_position`, clamped below
        `max_position` again, where a positional table over the frames ends."""
        hp = self.arch.hp
        if max_length is None:
            max_length = hp.max_frames
        elif isinstance(max_length, float):
            max_length = int(n_tokens * max_length)
        max_frames = int(min(max_length, self.max_output_length, hp.max_position))
        max_frames = -(-max_frames // padding_multiple) * padding_multiple
        if within_position and max_frames > hp.max_position:
            max_frames = (hp.max_position // padding_multiple) * padding_multiple
        return max_frames

    @staticmethod
    def _speaker_rows(embeddings, n):
        """A (D,) embedding or (n, D) rows → (n, D) float32 numpy rows (None
        stays None)."""
        if embeddings is None: return None
        embeddings = np.asarray(embeddings, np.float32)
        return np.broadcast_to(embeddings, (n, embeddings.shape[-1]))

    def compiled_infer(self,
                       tokens,
                       *,
                       embeddings = None,
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
        `_bucket`, on the decoder route `_use_fused_decoder` picks;
        `embeddings`: the speaker, (D,) or one row per text."""
        tokens, max_length = self._bucket(tokens, max_length, padding_multiple)
        spk = self._speaker_rows(embeddings, tokens.shape[0])
        options = dict(
            speaker_embedding = None if spk is None else torch.tensor(spk, device = self.device),
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

    def precompile_for_stream(self, ** kwargs):
        """Warm the decode at the stream's padding buckets (64 and 128
        tokens) with one short text each, before a `stream` starts."""
        for key in ('max_trial', 'padding_multiple', 'play', 'display',
                    'save', 'save_mel', 'save_audio'):
            kwargs.pop(key, None)
        for multiple in (64, 128):
            self.infer('precompile warmup', max_trial = 1,
                       padding_multiple = multiple, ** kwargs)

    @timer(name = 'inference')
    def infer(self,
              text,
              *,
              embeddings = None,
              callbacks = None,
              predicted = None,
              overwrite = False,
              return_output = True,
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
        times, and the last output is kept.  A `win_len` (top level or in
        `vocoder_config`, with its `hop_len`) vocodes in windows.

        A text found in `predicted` (the ``map.json`` cache) is answered
        from it, unless `overwrite`: its entry goes through the `callbacks`
        unsaved and is returned.  Otherwise the output goes through the
        callbacks, which record it in `predicted`.

        `embeddings`: the speaker of a speaker-conditioned model, (D,) or a
        row per chunk.

        Returns {'text', 'cleaned', 'splitted', 'mel' and 'attention' (one
        entry per chunk), and with a vocoder 'audio', 'rate', 'time'}, or
        with ``return_output=False`` the text's cache entry.  Attention maps
        are fetched by default on the sequential (retry) path; on the paths
        that queue the vocoder behind the decoder only when callbacks are
        given, unless `fetch_attention` says otherwise."""
        if isinstance(text, dict):
            text = text.get('text', text.get('content'))

        predicted = predicted if predicted is not None else {}
        if predicted and not overwrite and text in predicted:
            if callbacks:
                apply_callbacks(callbacks, predicted[text], {}, save = False)
            return predicted[text]

        with Timer('processing'):
            splitted, encoded = self._split_and_encode(text, max_text_length)

        fa_sequential = True if fetch_attention is None else fetch_attention
        fa_pipelined = bool(callbacks) if fetch_attention is None else fetch_attention

        mels, attn_weights, audios = [], [], []
        if encoded:
            mels, attn_weights, audios = self._synthesize(
                encoded, vocoder, max_length = max_length, max_trial = max_trial,
                min_fpt_ratio = min_fpt_ratio, max_fpt_ratio = max_fpt_ratio,
                vocoder_config = vocoder_config, batch_chunks = batch_chunks,
                fa_sequential = fa_sequential, fa_pipelined = fa_pipelined,
                embeddings = embeddings, ** kwargs)

        output = self._output(text, splitted, mels, attn_weights)
        if vocoder is not None:
            output.update(self._audio_infos(audios, silence_time))
        if callbacks:
            self._record(text, output, callbacks, predicted)
        if return_output:
            return output
        return predicted.get(text, {k: v for k, v in output.items()
                                    if k not in ('mel', 'attention')})

    @staticmethod
    def _output(text, splitted, mels, attention):
        return {'text': text,
                'cleaned': '\n\n'.join(splitted) if len(splitted) > 1 else (
                    splitted[0] if splitted else ''),
                'splitted': splitted, 'mel': mels, 'attention': attention}

    @staticmethod
    def _record(text, output, callbacks, predicted):
        """A new text's cache entry (its output without the arrays), then
        every callback on the output."""
        if text not in predicted:
            predicted[text] = {k: v for k, v in output.items()
                               if k not in ('mel', 'attention', 'audio')}
        apply_callbacks(callbacks, predicted[text], output, save = True)

    def _audio_infos(self, audios, silence_time = 0.15):
        """'audio' (the chunks' audio joined), 'rate' and 'time'; without
        audio, `silence_time` seconds of silence."""
        if audios:
            audio = audios[0] if len(audios) == 1 else np.concatenate(audios, axis = 0)
            return {'audio': audio, 'rate': self.rate, 'time': len(audio) / self.rate}
        audio = np.zeros((int(silence_time * self.rate),), np.float32)
        return {'audio': audio, 'rate': self.rate, 'time': silence_time}

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
        any host read.  With a `win_len` (top level or in `vocoder_config`)
        the vocoder cuts the windows of the decoded mels on the device once
        the gate has read the lengths (`vocode_windowed_from_device`), and a
        single chunk does not take the one-launch path.  Returns (mels,
        attention, audios), or None to leave it to the caller's sequential
        path, which decodes again, chunk by chunk: on a frames-per-token gate
        failure, with a `win_len` for a vocoder that cannot cut windows on
        the device (`HiFiGAN`, `Vocos`), or for one without `compiled_infer`,
        as the JAX package does.  The one-launch path needs the vocoder's
        `device_vocoder_fn`."""
        win_len = kwargs.pop('win_len', None) or vocoder_config.get('win_len')
        if win_len and not hasattr(vocoder, 'vocode_windowed_from_device'):
            return None
        if not hasattr(vocoder, 'compiled_infer'):
            return None
        if len(encoded) == 1 and not win_len and hasattr(vocoder, 'device_vocoder_fn'):
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
        vkwargs.pop('win_len', None)
        hop_len = vkwargs.pop('hop_len', -64)
        # a top-level `vocoder_batch` wins on both routes; with none, the
        # windowed route keeps the vocoder's own policy (`_auto_vocoder_batch`)
        if vocoder_batch is not None:
            vkwargs['vocoder_batch'] = vocoder_batch
        else:
            vocoder_batch = vkwargs.get('vocoder_batch') or 8
        if not win_len:
            # the vocoder launches are queued before the gate reads the lengths
            audio_dev = [vocoder.compiled_infer(outputs.mel[lo: lo + vocoder_batch], ** vkwargs)
                         for lo in range(0, len(encoded), vocoder_batch)]

        out_lengths = outputs.lengths.cpu().numpy()
        if not self._passes_gates(out_lengths, [len(e) for e in encoded],
                                  min_fpt_ratio, max_fpt_ratio, 'pipelined'):
            return None
        if win_len:
            audios = vocoder.vocode_windowed_from_device(
                outputs.mel, out_lengths, win_len = win_len, hop_len = hop_len, ** vkwargs)
        clock.mark()
        decode_s, vocode_s = clock.seconds()
        self.last_timings = {'decode_s': decode_s, 'vocode_s': vocode_s}

        mel_host = outputs.mel.cpu().numpy()
        attn_host = outputs.attention_weights.cpu().numpy() if fetch_attention else None
        rate = vocoder.upsample_rate
        mels, attn = [], []
        if not win_len:
            audio_host = [a.cpu().numpy() for a in audio_dev]
            audios = [audio_host[i // vocoder_batch][i % vocoder_batch,
                                                     : max(1, int(out_lengths[i])) * rate]
                      for i in range(len(encoded))]
        for i in range(len(encoded)):
            out_len = max(1, int(out_lengths[i]))
            mels.append(mel_host[i, :out_len])
            attn.append(attn_host[i, :out_len] if attn_host is not None else None)
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
        (attention entries are None unless `fetch_attention`).  Each chunk
        keeps its row of the `embeddings` through its retries."""
        n = len(encoded)
        lengths = [len(e) for e in encoded]
        spk = self._speaker_rows(kwargs.pop('embeddings', None), n)
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
                    outputs = self.compiled_infer(
                        tokens, max_length = max_length,
                        embeddings = None if spk is None else spk[group], ** kwargs)
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
        """Vocode chunk mels: with a `win_len`, every chunk's windows in
        shared batches (`vocode_windowed_batch`, where the vocoder has it;
        `vocoder_batch` None: the vocoder's own policy), or chunk by chunk
        without `batch_chunks`; else in padded sub-batches of
        `vocoder_batch` when their lengths are close (bounded padding
        waste), or one by one (a vocoder that returns one waveform for a 2-D
        mel gives it as it is)."""
        for k in _DECODE_ONLY:
            kwargs.pop(k, None)
        if len(mels) > 1 and batch_chunks and kwargs.get('win_len') \
                and hasattr(vocoder, 'vocode_windowed_batch'):
            return vocoder.vocode_windowed_batch(
                mels, pad_value = self.pad_mel_value, vocoder_batch = vocoder_batch, ** kwargs)
        if vocoder_batch is None: vocoder_batch = 8
        use_batch = (len(mels) > 1 and batch_chunks and kwargs.get('win_len') is None
                     and min(m.shape[0] for m in mels) >= max(m.shape[0] for m in mels) // 2)
        if not use_batch:
            audios = [np.asarray(vocoder(mel, ** kwargs)) for mel in mels]
            return [audio[0] if audio.ndim == 2 else audio for audio in audios]
        rate = vocoder.upsample_rate
        audios = []
        for start in range(0, len(mels), vocoder_batch):
            group = mels[start: start + vocoder_batch]
            batch = pad_batch(group, pad_value = self.pad_mel_value)
            audio = vocoder.compiled_infer(batch, ** kwargs).cpu().numpy()
            audios.extend(audio[i, : m.shape[0] * rate] for i, m in enumerate(group))
        return audios

    def get_inference_callbacks(self,
                                *,
                                vocoder = None,
                                save = None,
                                save_mel = None,
                                save_audio = None,
                                directory = None,
                                mel_dir = None,
                                audio_dir = None,
                                mel_filename = 'mel-{}.npy',
                                audio_filename = 'audio-{}.mp3',
                                play = False,
                                display = None,
                                post_processing = None,
                                save_in_parallel = False,
                                ** _):
        """(predicted, callbacks) for `predict`, as in the JAX package: with
        a vocoder the audio is saved unless ``save=False`` (without one, the
        mels), under `directory` (by default `pred_dir`), whose ``map.json``
        is `predicted`; without ``ffmpeg`` on the host an audio format other
        than WAV is written as WAV.  With a vocoder and nothing saved, the
        audio is displayed unless played.  `post_processing`: functions
        called on each output, or queues that receive it."""
        if vocoder is None:
            play, display, save_audio = False, False, False
        elif save_audio is None:
            save_audio = save is not False
        if save is None: save = bool(directory) or vocoder is None
        if save_mel is None: save_mel = save and vocoder is None

        save = save_mel or save_audio
        if vocoder is not None:
            if save:
                save_audio = True
            elif display is None:
                display = not play

        predicted, callbacks = {}, []
        if save:
            if directory is None: directory = self.pred_dir
            map_file = os.path.join(directory, 'map.json')
            predicted = load_json(map_file, default = {})

            if save_mel:
                if mel_dir is None: mel_dir = os.path.join(directory, 'mels')
                callbacks.append(SpectrogramSaver(
                    file_format = os.path.join(mel_dir, mel_filename),
                    save_in_parallel = save_in_parallel,
                ))
            if save_audio:
                if audio_dir is None: audio_dir = os.path.join(directory, 'audios')
                ext = audio_filename.rsplit('.', 1)[-1].lower()
                if ext != 'wav' and shutil.which('ffmpeg') is None:
                    logger.info('ffmpeg unavailable: saving audio as .wav instead of .%s', ext)
                    audio_filename = audio_filename.rsplit('.', 1)[0] + '.wav'
                callbacks.append(AudioSaver(
                    file_format = os.path.join(audio_dir, audio_filename),
                    save_in_parallel = save_in_parallel,
                ))
            callbacks.append(JSONSaver(
                data = predicted, filename = map_file, primary_key = 'text',
                save_in_parallel = save_in_parallel,
            ))

        if display or play:
            callbacks.append(AudioPlayer(display = bool(display), play = bool(play)))

        if post_processing is not None:
            if not isinstance(post_processing, list):
                post_processing = [post_processing]
            for fn in post_processing:
                if callable(fn):
                    callbacks.append(FunctionCallback(fn))
                elif hasattr(fn, 'put'):
                    callbacks.append(QueueCallback(fn))
        return predicted, callbacks

    def predict_batched(self,
                        texts,
                        *,
                        batch_size = 8,
                        callbacks = None,
                        overwrite = False,
                        vocoder = None,
                        embeddings = None,
                        max_length = 10.,
                        max_text_length = -1,
                        max_trial = 5,
                        min_fpt_ratio = 2.,
                        max_fpt_ratio = 10.,
                        vocoder_config = {},
                        return_output = True,
                        fetch_attention = None,
                        ** kwargs
                       ):
        """Synthesize `texts`: all chunks of up to `batch_size` texts decode
        as one batch, and vocoding is batched the same way.  Returns one
        dict per text, as `infer` does, under the same attention-fetch
        contract, ratio gates, callbacks and cache (a cached text is not
        decoded).  `embeddings`: the speaker, (D,) for every text or one
        row per text.  `last_timings` holds the decode and vocode seconds
        of the last group."""
        spk = None if embeddings is None else np.asarray(embeddings, np.float32)
        per_text = spk is not None and spk.ndim == 2 and spk.shape[0] == len(texts)
        if callbacks is None:
            predicted, callbacks = self.get_inference_callbacks(vocoder = vocoder, ** kwargs)
        else:
            predicted = {}
        texts = [t.get('text', t.get('content')) if isinstance(t, dict) else t
                 for t in texts]
        fa_sequential = True if fetch_attention is None else fetch_attention
        fa_pipelined = bool(callbacks) if fetch_attention is None else fetch_attention

        results = []
        for group_start in range(0, len(texts), batch_size):
            group = texts[group_start: group_start + batch_size]
            flat, owners, metas = [], [], []
            for idx, text in enumerate(group):
                if not overwrite and text in predicted:
                    metas.append(None)      # answered from the cache below
                    continue
                splitted, encoded = self._split_and_encode(text, max_text_length)
                metas.append(splitted)
                flat.extend(encoded)
                owners.extend([idx] * len(encoded))

            mels, attns, audios = [], [], []
            if flat:
                mels, attns, audios = self._synthesize(
                    flat, vocoder, max_length = max_length,
                    embeddings = spk[[group_start + i for i in owners]] if per_text else spk,
                    max_trial = max_trial, min_fpt_ratio = min_fpt_ratio,
                    max_fpt_ratio = max_fpt_ratio, vocoder_config = vocoder_config,
                    fa_sequential = fa_sequential, fa_pipelined = fa_pipelined, ** kwargs)

            for idx, text in enumerate(group):
                if metas[idx] is None:
                    if callbacks:
                        apply_callbacks(callbacks, predicted[text], {}, save = False)
                    results.append(predicted[text])
                    continue
                rows = [i for i, o in enumerate(owners) if o == idx]
                output = self._output(text, metas[idx], [mels[i] for i in rows],
                                      [attns[i] for i in rows])
                if vocoder is not None:
                    output.update(self._audio_infos([audios[i] for i in rows]))
                if callbacks:
                    self._record(text, output, callbacks, predicted)
                results.append(output if return_output else predicted.get(text, {}))

        for cb in callbacks:
            if hasattr(cb, 'join'): cb.join()
        return results

    @timer(name = 'predict')
    def predict(self, inputs, *, batch_size = None, ** kwargs):
        """One output dict per text.  A list with ``batch_size > 1`` is
        synthesized in cross-text batches (`predict_batched`); otherwise
        each text goes through `infer` (`BaseModel.predict`)."""
        if isinstance(inputs, (str, dict)): inputs = [inputs]
        if batch_size and batch_size > 1 and isinstance(inputs, (list, tuple)):
            return self.predict_batched(list(inputs), batch_size = batch_size, ** kwargs)
        return super().predict(inputs, ** kwargs)

    def stream(self, stream, *, vocoder, ** kwargs):
        """`predict` over a queue (ended by `None`) or an iterator of texts,
        after `precompile_for_stream`."""
        self.precompile_for_stream(vocoder = vocoder, ** kwargs)
        return super().stream(stream, vocoder = vocoder, ** kwargs)
