"""The native audio loader: a C++ worker pool that decodes WAV files below
the interpreter lock (``dataloader_native.cpp``).

Counterpart of ``text_to_speech_tpu/native/data_loader.py``.  Each worker
parses the RIFF container, converts PCM 16/24/32-bit or IEEE-float samples
to float32, resamples to a target rate with the Kaiser-windowed sinc of
`native.resample` and peak-normalizes.  What the decoder refuses (stereo,
other codecs and containers, unreadable files) comes back with a status
code, and `load_audio_batch` reads those rows with the Python reader
(`ops.audio_io.read_audio`, FFT resampling), as does every row when the
library cannot be built.

`AudioLoaderPool` is the handle over the pool; `load_audio_batch` keeps
the input order, and its ``native_rows`` counts the rows the pool decoded.
"""

import ctypes
import logging
import os
import threading

import numpy as np

from . import build_native_library

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'dataloader_native.cpp')
_DEP = os.path.join(_HERE, 'audio_native.cpp')

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

#: the status codes of dataloader_native.cpp
LOAD_OK, ERR_OPEN, ERR_FORMAT, ERR_DATA = 0, -1, -2, -3


def get_library():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = build_native_library(_SRC, 'dataloader_native', deps = (_DEP,))
        if so_path is None:
            logger.warning('native data loader unavailable; '
                           'audio loads stay on the python readers')
            _build_failed = True
            return None
        lib = ctypes.CDLL(so_path)
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [i32, i32]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_submit.restype = None
        lib.loader_submit.argtypes = [ctypes.c_void_p, i64, ctypes.c_char_p, i32, i32]
        lib.loader_next.restype = i64
        lib.loader_next.argtypes = [ctypes.c_void_p, f32pp, ctypes.POINTER(i64),
                                    ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.loader_free.restype = None
        lib.loader_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available():
    return get_library() is not None


class AudioLoaderPool:
    """Handle over the C++ worker pool.  ``submit(ticket, path, ...)``, then
    `next` → ``(ticket, audio or None, rate, status)`` in the order the
    decodes finish (re-key by ticket).  At most `capacity` decoded results
    wait unread; a worker parks until `next` takes one."""

    def __init__(self, n_workers = 2, capacity = 16):
        lib = get_library()
        if lib is None:
            raise RuntimeError('native data loader unavailable')
        self._lib = lib
        self._handle = lib.loader_create(int(n_workers), int(capacity))
        self._open = True

    def submit(self, ticket, path, *, target_rate = 0, normalize = True):
        self._lib.loader_submit(self._handle, int(ticket), os.fspath(path).encode(),
                                int(target_rate or 0), int(bool(normalize)))

    def next(self):
        """Blocking pop of one finished decode."""
        data = ctypes.POINTER(ctypes.c_float)()
        n, rate, status = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
        ticket = self._lib.loader_next(self._handle, ctypes.byref(data), ctypes.byref(n),
                                       ctypes.byref(rate), ctypes.byref(status))
        audio = None
        if bool(data):
            if status.value == LOAD_OK:
                audio = np.ctypeslib.as_array(data, shape = (n.value,)).copy()
            self._lib.loader_free(data)
        return ticket, audio, rate.value, status.value

    def close(self):
        if self._open:
            self._open = False
            self._lib.loader_destroy(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, * exc):
        self.close()

    def __del__(self):
        if getattr(self, '_open', False):
            self.close()


class DecodedBatch(list):
    """``[(audio, rate), ...]`` in the input order; ``native_rows`` is the
    number of rows the C++ pool decoded (the rest went through Python)."""

    native_rows = 0


def load_audio_batch(paths, *, target_rate = None, normalize = True, n_workers = None,
                     pool = None):
    """Decode `paths` in parallel → ``[(audio, rate), ...]`` in their order.

    WAV rows decode on the pool (`pool`, or one made for the call with
    `n_workers` workers); stereo, non-WAV and unreadable rows, and every row
    when the library is unavailable, go through the Python reader with the
    same resampling target and normalization."""
    paths = list(paths)
    results = DecodedBatch([None] * len(paths))
    own_pool = None
    if pool is None and available():
        own_pool = pool = AudioLoaderPool(
            n_workers = n_workers or min(4, max(1, os.cpu_count() or 1)))
    try:
        if pool is not None:
            pending = 0
            for i, path in enumerate(paths):
                if str(path).lower().endswith('.wav'):
                    pool.submit(i, path, target_rate = target_rate or 0,
                                normalize = normalize)
                    pending += 1
            for _ in range(pending):
                ticket, audio, rate, status = pool.next()
                if status == LOAD_OK:
                    results[ticket] = (audio, rate)
                    results.native_rows += 1
    finally:
        if own_pool is not None:
            own_pool.close()

    for i, path in enumerate(paths):
        if results[i] is None:
            from ..ops.audio_io import read_audio
            rate, audio = read_audio(str(path), target_rate = target_rate,
                                     normalize = normalize)
            results[i] = (np.asarray(audio), rate)
    return results
