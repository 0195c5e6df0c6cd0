"""ctypes bindings for the C++ serving scheduler (``serving_native.cpp``).

Counterpart of ``text_to_speech_tpu/native/scheduler.py``, with its own copy
of the C++ source.  `RequestScheduler` keeps the queue, the dynamic-batching
window, priorities, abort and latency accounting in native code (below the
interpreter lock); the Python side maps the scheduler's ids to request
payloads.  The library is built with ``g++`` at first use into
``build/native/`` (`native.build_native_library`), never when this module is
imported.  Without a compiler the scheduler runs on `_PyScheduler`, a
Python twin with the same semantics, which ``force_python=True`` also
selects; ``RequestScheduler.native`` says which one serves.
"""

import ctypes
import logging
import os
import threading
import time

from . import build_native_library

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'serving_native.cpp')

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def get_library():
    """The loaded library, or None when it cannot be built."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = build_native_library(_SRC, 'serving_native')
        if so_path is None:
            logger.warning('native serving scheduler unavailable; '
                           'using the Python implementation')
            _build_failed = True
            return None
        lib = ctypes.CDLL(so_path)
        i64, i64p, dbl = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                          ctypes.c_double)
        lib.serving_engine_create.restype = ctypes.c_void_p
        lib.serving_engine_create.argtypes = []
        lib.serving_engine_destroy.restype = None
        lib.serving_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.serving_engine_submit.restype = i64
        lib.serving_engine_submit.argtypes = [ctypes.c_void_p, i64]
        lib.serving_engine_abort.restype = ctypes.c_int
        lib.serving_engine_abort.argtypes = [ctypes.c_void_p, i64]
        lib.serving_engine_collect.restype = ctypes.c_int
        lib.serving_engine_collect.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_int, dbl, dbl]
        lib.serving_engine_collect_nowait.restype = ctypes.c_int
        lib.serving_engine_collect_nowait.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_int]
        lib.serving_engine_complete.restype = None
        lib.serving_engine_complete.argtypes = [ctypes.c_void_p, i64]
        lib.serving_engine_pending.restype = i64
        lib.serving_engine_pending.argtypes = [ctypes.c_void_p]
        lib.serving_engine_stat.restype = i64
        lib.serving_engine_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.serving_engine_mean_s.restype = dbl
        lib.serving_engine_mean_s.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.serving_engine_wake.restype = None
        lib.serving_engine_wake.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    return get_library() is not None


class RequestScheduler:
    """Priority request queue + dynamic-batching window.

    - `submit(priority=0) -> id`: ids increase monotonically; dequeue order
      is (priority desc, FIFO within priority);
    - `collect(max_out, first_timeout, batch_wait) -> [ids]`: blocks up to
      `first_timeout` s for a first request, then gathers until full or
      `batch_wait` s after the first take;
    - `collect_nowait(max_out)`: non-blocking (continuous admission);
    - `abort(id)`: True iff the request was still queued;
    - `complete(id)`: stamps end-to-end latency;
    - `stats`: dict of counters + mean waits.
    """

    STATS = ('submitted', 'collected', 'aborted', 'completed', 'batches')

    def __init__(self, force_python = False):
        self._lib = None if force_python else get_library()
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.serving_engine_create())
        else:
            self._py = _PyScheduler()
        self.native = self._lib is not None

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.serving_engine_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def submit(self, priority = 0):
        if self._lib is None:
            return self._py.submit(priority)
        return int(self._lib.serving_engine_submit(self._handle, priority))

    def abort(self, request_id):
        if self._lib is None:
            return self._py.abort(request_id)
        return bool(self._lib.serving_engine_abort(self._handle, request_id))

    def collect(self, max_out, first_timeout = 0.1, batch_wait = 0.01):
        if self._lib is None:
            return self._py.collect(max_out, first_timeout, batch_wait)
        out = (ctypes.c_int64 * max_out)()
        n = self._lib.serving_engine_collect(
            self._handle, out, max_out,
            ctypes.c_double(first_timeout), ctypes.c_double(batch_wait))
        return [int(out[i]) for i in range(n)]

    def collect_nowait(self, max_out):
        if self._lib is None:
            return self._py.collect_nowait(max_out)
        out = (ctypes.c_int64 * max_out)()
        n = self._lib.serving_engine_collect_nowait(self._handle, out, max_out)
        return [int(out[i]) for i in range(n)]

    def complete(self, request_id):
        if self._lib is None:
            return self._py.complete(request_id)
        self._lib.serving_engine_complete(self._handle, request_id)

    def pending(self):
        if self._lib is None:
            return self._py.pending()
        return int(self._lib.serving_engine_pending(self._handle))

    def wake(self):
        """Unblock a concurrent `collect` (engine shutdown)."""
        if self._lib is None:
            return self._py.wake()
        self._lib.serving_engine_wake(self._handle)

    @property
    def stats(self):
        if self._lib is None:
            return self._py.stats()
        out = {name: int(self._lib.serving_engine_stat(self._handle, i))
               for i, name in enumerate(self.STATS)}
        out['mean_queue_wait_s'] = float(
            self._lib.serving_engine_mean_s(self._handle, 0))
        out['mean_latency_s'] = float(
            self._lib.serving_engine_mean_s(self._handle, 1))
        return out


class _PyScheduler:
    """Pure-Python twin with the same semantics (also the executable spec
    of the C++ core: the tests run one script through both)."""

    def __init__(self):
        self._time = time.monotonic
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue = {}                 # (-prio, id) -> submitted_s
        self._in_flight = {}
        self._next_id = 0
        self._woken = False
        self._counters = dict.fromkeys(RequestScheduler.STATS, 0)
        self._wait_s = 0.
        self._latency_s = 0.

    def submit(self, priority = 0):
        with self._cv:
            rid = self._next_id
            self._next_id += 1
            self._queue[(-priority, rid)] = self._time()
            self._counters['submitted'] += 1
            self._cv.notify()
            return rid

    def abort(self, request_id):
        with self._lock:
            for key in list(self._queue):
                if key[1] == request_id:
                    del self._queue[key]
                    self._counters['aborted'] += 1
                    return True
            return False

    def _take(self, max_out):
        taken = []
        t = self._time()
        for key in sorted(self._queue):
            if len(taken) >= max_out:
                break
            submitted = self._queue.pop(key)
            self._wait_s += t - submitted
            self._in_flight[key[1]] = submitted
            self._counters['collected'] += 1
            taken.append(key[1])
        return taken

    def collect(self, max_out, first_timeout = 0.1, batch_wait = 0.01):
        ready = lambda: bool(self._queue) or self._woken
        with self._cv:
            if not self._queue:
                self._cv.wait_for(ready, first_timeout)
                if self._woken:
                    self._woken = False
                    return []
                if not self._queue:
                    return []
            taken = self._take(max_out)
            deadline = self._time() + batch_wait
            while len(taken) < max_out:
                remaining = deadline - self._time()
                if remaining <= 0 or not self._cv.wait_for(ready, remaining):
                    break
                if self._woken:
                    self._woken = False
                    break
                taken.extend(self._take(max_out - len(taken)))
            if taken:
                self._counters['batches'] += 1
            return taken

    def collect_nowait(self, max_out):
        with self._lock:
            return self._take(max_out)

    def complete(self, request_id):
        with self._lock:
            submitted = self._in_flight.pop(request_id, None)
            if submitted is None:
                return
            self._latency_s += self._time() - submitted
            self._counters['completed'] += 1

    def pending(self):
        with self._lock:
            return len(self._queue)

    def wake(self):
        with self._cv:
            self._woken = True      # consumed by the next (or current) collect
            self._cv.notify_all()

    def stats(self):
        with self._lock:
            out = dict(self._counters)
            out['mean_queue_wait_s'] = (
                self._wait_s / out['collected'] if out['collected'] else 0.)
            out['mean_latency_s'] = (
                self._latency_s / out['completed'] if out['completed'] else 0.)
            return out
