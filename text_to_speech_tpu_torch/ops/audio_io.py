"""Audio reading for the training data: WAV files and raw arrays → mono
float32 at the model's rate.

Counterpart of what ``text_to_speech_tpu/ops/audio_io.py`` gives
`WaveGlow.prepare_data` (`read_audio`, `load_audio`), on numpy and scipy:
PCM and IEEE-float WAV (``scipy.io.wavfile``; the standard library's
``wave`` reads PCM only), channels averaged to mono, FFT resampling
(``scipy.signal.resample``, the JAX package's default), and the JAX
package's normalization (DC offset removed, peak scaled to 1).  Other
codecs (through ffmpeg), noise reduction and silence trimming are not
ported.
"""

import numpy as np


def read_wav(filename):
    """(rate, samples) of a WAV file; samples (N,) or (N, channels) in the
    file's own type."""
    from scipy.io import wavfile
    return wavfile.read(filename)


def resample_audio(audio, rate, target_rate):
    """FFT resampling to `target_rate` → (audio, target_rate)."""
    if rate == target_rate: return audio, rate
    from scipy.signal import resample
    return resample(audio, int(len(audio) / rate * target_rate)), target_rate


def normalize_audio(audio, max_val = 1.):
    """Remove the DC offset and scale the peak to `max_val` → float32."""
    audio = audio - np.mean(audio)
    peak = np.max(np.abs(audio))
    if peak <= 1e-9: return audio.astype(np.float32)
    return (audio * (max_val / peak)).astype(np.float32)


def read_audio(data, *, rate = None, target_rate = None):
    """A WAV filename or a raw array (with its `rate`) → (rate, mono audio),
    resampled to `target_rate` and normalized, float32."""
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
    return rate, normalize_audio(audio)


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
