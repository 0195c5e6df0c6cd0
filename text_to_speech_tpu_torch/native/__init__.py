"""The host audio DSP library, built with ``g++`` at first use and loaded
with `ctypes`.

Counterpart of ``text_to_speech_tpu/native/__init__.py``, with its own copy
of the C++ source (``audio_native.cpp``): `pcm16_to_f32`, `f32_to_pcm16`,
`normalize`, `resample` (Kaiser-windowed sinc, polyphase), `frame_rms`,
`trim_bounds` and `overlap_stitch`, numpy in and numpy out.  A library is
compiled into ``build/native/<name>-<hash>.so`` at the root of the checkout,
keyed by the hash of its sources, with the JAX package's flags (``-O3
-march=native``), so the two builds give the same bits on one machine.
Nothing is built when the module is imported.  Where ``g++`` is missing or
fails, `get_library` warns once and returns None, and each wrapper computes
with numpy / scipy instead.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'audio_native.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build', 'native')
CXX_FLAGS = ['-O3', '-march=native', '-shared', '-fPIC']

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def build_native_library(src, name, deps = ()):
    """Compile `src` (and the files it includes, `deps`, which join the
    hash) into ``BUILD_DIR`` → the ``.so`` path, or None when ``g++``
    fails."""
    digest = hashlib.sha256()
    for path in (src, * deps):
        with open(path, 'rb') as f:
            digest.update(f.read())
    so_path = os.path.join(BUILD_DIR, '{}-{}.so'.format(name, digest.hexdigest()[:16]))
    if os.path.exists(so_path):
        return so_path
    tmp = '{}.{}.tmp'.format(so_path, os.getpid())
    try:
        os.makedirs(BUILD_DIR, exist_ok = True)
        subprocess.run(['g++', * CXX_FLAGS, '-o', tmp, src], check = True,
                       capture_output = True, timeout = 120)
        os.replace(tmp, so_path)
    except (OSError, subprocess.SubprocessError) as err:
        logger.debug('native build of %s failed: %s', name, err)
        return None
    return so_path


def get_library():
    """The loaded library, or None when it cannot be built."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = build_native_library(_SRC, 'audio_native')
        if so_path is None:
            logger.warning('native audio library unavailable; using numpy fallbacks')
            _build_failed = True
            return None
        lib = ctypes.CDLL(so_path)
        i64, i32, f32p, i16p, i64p = (
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64))
        lib.pcm16_to_f32.argtypes = [i16p, f32p, i64]
        lib.pcm16_to_f32.restype = None
        lib.f32_to_pcm16.argtypes = [f32p, i16p, i64]
        lib.f32_to_pcm16.restype = None
        lib.normalize_audio.argtypes = [f32p, i64, ctypes.c_float]
        lib.normalize_audio.restype = None
        lib.resample_sinc.restype = i64
        lib.resample_sinc.argtypes = [f32p, i64, f32p, i32, i32, i32]
        lib.frame_rms.restype = i64
        lib.frame_rms.argtypes = [f32p, i64, f32p, i32, i32]
        lib.trim_bounds.argtypes = [f32p, i64, i32, i32, ctypes.c_float, i64p, i64p]
        lib.trim_bounds.restype = None
        lib.overlap_stitch.restype = i64
        lib.overlap_stitch.argtypes = [f32p, i32, i64, i64p, f32p]
        _lib = lib
        return _lib


def available():
    return get_library() is not None


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pcm16_to_f32(data):
    data = np.ascontiguousarray(data, dtype = np.int16)
    lib = get_library()
    if lib is None:
        return data.astype(np.float32) / 32768.
    out = np.empty(data.shape, np.float32)
    lib.pcm16_to_f32(data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out),
                     data.size)
    return out


def f32_to_pcm16(data):
    data = np.ascontiguousarray(data, dtype = np.float32)
    lib = get_library()
    if lib is None:
        return np.clip(data * 32767., -32768, 32767).astype(np.int16)
    out = np.empty(data.shape, np.int16)
    lib.f32_to_pcm16(_fptr(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                     data.size)
    return out


def normalize(data, max_val = 1.):
    """Remove the DC offset and scale the peak to `max_val`."""
    data = np.ascontiguousarray(data, dtype = np.float32).copy()
    lib = get_library()
    if lib is None:
        data = data - data.mean()
        peak = np.abs(data).max()
        return data if peak <= 1e-9 else data * (max_val / peak)
    lib.normalize_audio(_fptr(data), data.size, ctypes.c_float(max_val))
    return data


def resample(data, in_rate, out_rate, half_taps = 32):
    """Kaiser-windowed sinc resampling (the data pipeline's path; the FFT
    path, equal to the JAX package's default, is `ops.audio_processing`'s
    ``'fft'``)."""
    data = np.ascontiguousarray(data, dtype = np.float32)
    if in_rate == out_rate: return data
    lib = get_library()
    out_n = int(len(data) * out_rate / in_rate)
    if lib is None:
        from math import gcd
        from scipy.signal import resample_poly
        g = gcd(in_rate, out_rate)
        return resample_poly(data, out_rate // g, in_rate // g).astype(np.float32)[:out_n]
    out = np.empty(out_n + 8, np.float32)
    n = lib.resample_sinc(_fptr(data), len(data), _fptr(out), in_rate, out_rate, half_taps)
    return out[:n]


def frame_rms(data, frame_length, hop_length):
    data = np.ascontiguousarray(data, dtype = np.float32)
    n_frames = max(1, 1 + (len(data) - frame_length) // hop_length)
    lib = get_library()
    if lib is None:
        idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)
        idx = np.minimum(idx, len(data) - 1)
        return np.sqrt(np.mean(data[idx] ** 2, axis = 1)).astype(np.float32)
    out = np.empty(n_frames, np.float32)
    lib.frame_rms(_fptr(data), len(data), _fptr(out), frame_length, hop_length)
    return out


def trim_bounds(data, frame_length, hop_length, threshold = 0.1):
    """(start, end) sample bounds of the region whose frame RMS reaches
    `threshold` of the largest."""
    data = np.ascontiguousarray(data, dtype = np.float32)
    lib = get_library()
    if lib is None:
        rms = frame_rms(data, frame_length, hop_length)
        if rms.max() <= 1e-9: return 0, 0
        frames = np.where(rms >= threshold * rms.max())[0]
        if len(frames) == 0: return 0, 0
        return int(frames[0] * hop_length), \
            int(min(len(data), frames[-1] * hop_length + frame_length))
    start, end = ctypes.c_int64(), ctypes.c_int64()
    lib.trim_bounds(_fptr(data), len(data), frame_length, hop_length,
                    ctypes.c_float(threshold), ctypes.byref(start), ctypes.byref(end))
    return start.value, end.value


def overlap_stitch(parts, overlaps):
    """Stitch windowed vocoder parts (n_parts, part_len), trimming half of
    each junction's overlap from either side."""
    parts = np.ascontiguousarray(parts, dtype = np.float32)
    overlaps = np.ascontiguousarray(overlaps, dtype = np.int64)
    n_parts, part_len = parts.shape
    if len(overlaps) < n_parts - 1:
        raise ValueError('{} overlaps for {} parts'.format(len(overlaps), n_parts))
    lib = get_library()
    if lib is None:
        pieces = []
        for i in range(n_parts):
            lo = 0 if i == 0 else int(overlaps[i - 1]) // 2
            hi = part_len if i == n_parts - 1 else part_len - int(overlaps[i]) // 2
            pieces.append(parts[i, lo:hi])
        return np.concatenate(pieces)
    out = np.empty(n_parts * part_len, np.float32)
    n = lib.overlap_stitch(_fptr(parts), n_parts, part_len,
                           overlaps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _fptr(out))
    return out[:n]
