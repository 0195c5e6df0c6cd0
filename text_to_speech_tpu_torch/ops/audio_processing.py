"""Resampling, sample formats and normalization.

Counterpart of `resample_audio`, `convert_audio_dtype` and
`normalize_audio` in ``text_to_speech_tpu/ops/audio_processing.py``.
Silence trimming and noise reduction are not ported.
"""

import numpy as np


def resample_audio(audio, rate, target_rate, method = 'fft'):
    """`audio` resampled to `target_rate` → (audio, target_rate).

    - ``'fft'`` (default): ``scipy.signal.resample``, the JAX package's
      default;
    - ``'sinc'``: the native Kaiser-windowed polyphase resampler
      (`native.resample`, float32), the data loader pool's.
    """
    if rate == target_rate: return audio, rate
    if method == 'sinc':
        from .. import native
        return native.resample(np.asarray(audio, np.float32), rate, target_rate), target_rate
    if method != 'fft':
        raise ValueError('Unknown resampling method {!r} (known: fft, sinc)'.format(method))
    from scipy.signal import resample
    return resample(audio, int(len(audio) / rate * target_rate)), target_rate


def convert_audio_dtype(audio, dtype):
    """Convert between integer/float sample formats with max-value scaling."""
    dtype = np.dtype(dtype)
    if audio.dtype == dtype: return audio
    if np.issubdtype(audio.dtype, np.floating):
        if np.issubdtype(dtype, np.floating):
            return audio.astype(dtype)
        return (audio * np.iinfo(dtype).max).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        return (audio / np.iinfo(audio.dtype).max).astype(dtype)
    return (audio / np.iinfo(audio.dtype).max * np.iinfo(dtype).max).astype(dtype)


def normalize_audio(audio, max_val = 1., dtype = None):
    """Remove DC offset and scale the peak to `max_val` (float32 output when
    `max_val <= 1`, int16-style otherwise)."""
    if dtype is None:
        dtype = np.float32 if max_val <= 1. else np.int16
    audio = audio - np.mean(audio)
    peak = np.max(np.abs(audio))
    if peak <= 1e-9: return audio.astype(dtype)
    return (audio * (max_val / peak)).astype(dtype)
