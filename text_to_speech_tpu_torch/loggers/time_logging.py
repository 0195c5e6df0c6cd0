"""Hierarchical wall-clock tracing.

Counterpart of ``text_to_speech_tpu/loggers/time_logging.py``: a ``@timer``
decorator and a ``Timer`` context manager push named spans into a
per-thread tree that can be printed as an indented report.  Spans take the
host's clock around dispatch and never synchronise the device: work queued
on a card inside a span may still run after it closes.  Device times come
from `torch.profiler` (`start_profiler_trace`) or CUDA events.
"""

import os
import time
import logging
import tempfile
import functools
import threading

import torch
import torch.profiler

logger = logging.getLogger(__name__)

TIME_LEVEL = 15          # between DEBUG (10) and INFO (20)
TIME_DEBUG_LEVEL = 13


class TimerSpan:
    __slots__ = ('name', 'total', 'count', 'children', 'parent', '_start')

    def __init__(self, name, parent = None):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children = {}
        self.parent = parent
        self._start = None

    def child(self, name):
        if name not in self.children:
            self.children[name] = TimerSpan(name, parent = self)
        return self.children[name]

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self.count += 1
            self._start = None

    def report(self, indent = 0):
        lines = []
        if self.name is not None:
            lines.append('{}- {} : {:.3f}s ({} exec{})'.format(
                '  ' * indent, self.name, self.total, self.count,
                's' if self.count > 1 else ''
            ))
        for c in self.children.values():
            lines.extend(c.report(indent + (self.name is not None)))
        return lines


class RootTimer:
    """Thread-aware span tree: each thread gets its own root, so concurrent
    pipelines (e.g. the `Stream` workers) never contend or interleave."""

    def __init__(self):
        self._local = threading.local()
        self._roots = {}
        self._lock = threading.Lock()

    def _root(self):
        if not hasattr(self._local, 'root'):
            root = TimerSpan(None)
            self._local.root = root
            self._local.current = root
            with self._lock:
                self._roots[threading.current_thread().name] = root
        return self._local.root

    def push(self, name):
        self._root()
        span = self._local.current.child(name)
        span.start()
        self._local.current = span
        return span

    def pop(self):
        span = self._local.current
        span.stop()
        if span.parent is not None:
            self._local.current = span.parent
        return span

    def report(self):
        lines = []
        with self._lock:
            for thread_name, root in self._roots.items():
                if root.children:
                    lines.append('Timers (thread {}):'.format(thread_name))
                    lines.extend(root.report())
        return '\n'.join(lines)

    def reset(self):
        with self._lock:
            self._roots.clear()
        self._local = threading.local()


ROOT_TIMER = RootTimer()


class Timer:
    """Context manager measuring a named span: ``with Timer('encode'): ...``"""

    def __init__(self, name, root = None, log_level = TIME_DEBUG_LEVEL):
        self.name = name
        self.root = root if root is not None else ROOT_TIMER
        self.log_level = log_level
        self._span = None

    def __enter__(self):
        self._span = self.root.push(self.name)
        return self

    def __exit__(self, *exc):
        span = self.root.pop()
        if logger.isEnabledFor(self.log_level):
            logger.log(self.log_level, '%s took %.3fs', self.name, span.total)
        return False


def timer(fn = None, *, name = None):
    """Decorator timing each call of `fn` under span `name` (default: fn name)."""
    def wrapper(func):
        span_name = name if name is not None else func.__name__

        @functools.wraps(func)
        def inner(*args, **kwargs):
            with Timer(span_name):
                return func(*args, **kwargs)
        inner.timer_name = span_name
        return inner

    if fn is not None:
        return wrapper(fn)
    return wrapper


def timer_report():
    return ROOT_TIMER.report()


def reset_timers():
    ROOT_TIMER.reset()


_PROFILER = {}


def start_profiler_trace(log_dir = None):
    """Start a `torch.profiler` trace of the host and, where a card is
    present, its CUDA activity; `stop_profiler_trace` writes it to
    ``<log_dir>/trace.json`` (Chrome trace format).  `log_dir` defaults to
    ``torch_trace`` in the temporary directory."""
    if _PROFILER:
        raise RuntimeError('a profiler trace is already running')
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), 'torch_trace')
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities = activities)
    profiler.start()
    _PROFILER.update(profiler = profiler, log_dir = log_dir)
    return log_dir


def stop_profiler_trace():
    """Stop the trace and write it; returns the trace's path."""
    if not _PROFILER:
        raise RuntimeError('no profiler trace is running')
    profiler, log_dir = _PROFILER.pop('profiler'), _PROFILER.pop('log_dir')
    profiler.stop()
    os.makedirs(log_dir, exist_ok = True)
    path = os.path.join(log_dir, 'trace.json')
    profiler.export_chrome_trace(path)
    return path
