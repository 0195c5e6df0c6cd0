"""Audio files and playback.

Counterpart of ``text_to_speech_tpu/ops/audio_io.py``, on numpy and scipy.
Reading, for the training data and the speaker encoder (`read_audio`,
`load_audio`, `load_mel`): PCM and
IEEE-float WAV (``scipy.io.wavfile``; the standard library's ``wave`` reads
PCM only), channels averaged to mono, FFT resampling
(``scipy.signal.resample``, the JAX package's default), and the JAX
package's normalization (`audio_processing.normalize_audio`).  Writing, for
the inference callbacks: the `register_writer` registry, `write_wav`,
`write_ffmpeg` (mp3, m4a, ogg, flac, opus through an ``ffmpeg`` on the
host) and `write_audio`.  Playback: `play_audio` through ``ffplay`` or
``aplay``, which logs a warning and returns False on a host with neither,
and `display_audio` (an IPython widget in a notebook, else playback).
Reading other codecs, noise reduction and silence trimming are not ported:
`load_mel` raises when asked for them.
"""

import logging
import os
import shutil
import subprocess

import numpy as np

from . import audio_processing
from .audio_processing import normalize_audio, resample_audio

logger = logging.getLogger(__name__)

_write_fns = {}


def register_writer(*exts):
    def deco(fn):
        for e in exts: _write_fns[e] = fn
        return fn
    return deco


def read_wav(filename):
    """(rate, samples) of a WAV file; samples (N,) or (N, channels) in the
    file's own type."""
    from scipy.io import wavfile
    return wavfile.read(filename)


def read_audio(data, *, rate = None, target_rate = None, normalize = True):
    """A WAV filename or a raw array (with its `rate`) → (rate, mono audio),
    resampled to `target_rate` (FFT) and, with `normalize`, normalized to
    float32."""
    if isinstance(data, str):
        if not data.lower().endswith('.wav'):
            raise ValueError('only WAV files are read by the port, got {!r}'.format(data))
        rate, audio = read_wav(data)
    else:
        if rate is None:
            raise ValueError('`rate` is required when passing raw audio')
        audio = np.asarray(data)
    if audio.ndim == 2:
        audio = audio.mean(axis = 1)
    if target_rate and target_rate != rate:
        audio, rate = resample_audio(audio, rate, target_rate)
    return rate, normalize_audio(audio) if normalize else audio


def load_audio(data, rate, ** kwargs):
    """A filename, a raw array or a dataset row → the 1-D waveform at
    `rate`.  A row names its audio under 'audio', 'wavs_<rate>', 'filename'
    or 'audio_filename', and may give its rate under 'rate'."""
    if isinstance(data, dict):
        if 'audio' in data:
            key = 'audio'
        elif 'wavs_{}'.format(rate) in data:
            key = 'wavs_{}'.format(rate)
        else:
            key = 'filename' if 'filename' in data else 'audio_filename'
        if 'rate' in data: kwargs.setdefault('rate', data['rate'])
        data = data[key]
    kwargs.setdefault('rate', rate)
    return read_audio(data, target_rate = rate, ** kwargs)[1]


def load_mel(data, stft_fn, *, device = None, trim_mode = None, trim_silence = False,
             reduce_noise = False, ** kwargs):
    """A mel spectrogram (frames, n_mels), float32 on `device` (the CPU by
    default): read from a ``.npy`` file or a row's 'mel', taken as given
    when it is an array of `stft_fn`'s width, else computed by `stft_fn` on
    `device` from the audio `load_audio` reads at its rate."""
    if trim_mode or trim_silence or reduce_noise:
        raise NotImplementedError('silence trimming and noise reduction are not ported '
                                  '(ROADMAP.md, queue 1, the periphery)')
    import torch
    if isinstance(data, str) and data.endswith('.npy'):
        mel = np.load(data)
    elif isinstance(data, dict) and 'mel' in data:
        mel = data['mel']
        if isinstance(mel, str): mel = np.load(mel)
    elif getattr(data, 'ndim', 0) == 2 and data.shape[1] == stft_fn.n_mel_channels:
        mel = data
    else:
        audio = load_audio(data, stft_fn.rate, ** kwargs)
        with torch.no_grad():
            return stft_fn(torch.as_tensor(np.asarray(audio, np.float32), device = device))[0]
    return torch.as_tensor(np.asarray(mel, np.float32), device = device)


@register_writer('wav')
def write_wav(filename, audio, rate, ** kwargs):
    from scipy.io import wavfile
    wavfile.write(filename, rate, audio)


def _ffmpeg_available():
    return shutil.which('ffmpeg') is not None


@register_writer('mp3', 'm4a', 'ogg', 'flac', 'opus')
def write_ffmpeg(filename, audio, rate, ** kwargs):
    if not _ffmpeg_available():
        raise RuntimeError('ffmpeg is required to write {!r} but was not found'.format(filename))
    audio = audio_processing.convert_audio_dtype(np.asarray(audio), np.float32)
    subprocess.run(
        ['ffmpeg', '-y', '-v', 'quiet', '-f', 'f32le', '-ar', str(rate), '-ac', '1',
         '-i', 'pipe:0', filename],
        input = audio.astype('<f4').tobytes(), check = True,
    )


def write_audio(filename, audio, rate, *, normalize = False, makedirs = True, ** kwargs):
    ext = filename.split('.')[-1].lower()
    if ext not in _write_fns:
        raise ValueError('Unsupported audio extension {!r} (known: {})'.format(
            ext, tuple(_write_fns)
        ))
    if makedirs:
        d = os.path.dirname(filename)
        if d: os.makedirs(d, exist_ok = True)
    audio = np.asarray(audio)
    if normalize:
        audio = normalize_audio(audio, max_val = 1.)
    _write_fns[ext](filename, audio, rate, ** kwargs)
    return filename


def play_audio(audio, rate = 22050, *, blocking = True, ** kwargs):
    """Play audio through a host player (ffplay/aplay) when one exists."""
    import tempfile
    player = shutil.which('ffplay') or shutil.which('aplay')
    if player is None:
        logger.warning('No audio player available on this host (ffplay/aplay)')
        return False
    with tempfile.NamedTemporaryFile(suffix = '.wav', delete = False) as f:
        path = f.name
    try:
        write_audio(path, audio_processing.convert_audio_dtype(
            np.asarray(audio), np.int16
        ), rate)
        cmd = [player, '-nodisp', '-autoexit', path] if 'ffplay' in player else [player, path]
        proc = subprocess.Popen(cmd, stdout = subprocess.DEVNULL, stderr = subprocess.DEVNULL)
        if blocking: proc.wait()
        return True
    finally:
        if blocking and os.path.exists(path): os.remove(path)


def display_audio(audio, rate = 22050, ** kwargs):
    """Render an IPython audio widget in notebooks, else fall back to playback."""
    try:
        from IPython.display import Audio, display
        display(Audio(np.asarray(audio), rate = rate))
        return True
    except Exception:
        return play_audio(audio, rate, ** kwargs)
