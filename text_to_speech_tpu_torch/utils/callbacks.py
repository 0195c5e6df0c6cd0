"""Inference callbacks: file savers, the ``map.json`` cache, playback, user
hooks.

Counterpart of ``text_to_speech_tpu/utils/callbacks.py``: `Callback` (with
its condition and initializers), `FileSaver` with indexed filename formats
and optional background-thread saving (`save_in_parallel`, waited for by
`join`), `AudioSaver`, `SpectrogramSaver`, `JSONSaver` (the ``map.json``
prediction cache), `AudioPlayer`, `FunctionCallback`, `QueueCallback` and
`apply_callbacks`.  The callbacks that plot or show images (`ImageSaver`,
`SpectrogramDisplayer`, `ImageDisplayer`, `BoxesDisplayer`,
`OCRDisplayer`) are not ported.

Callbacks run on the host, on the arrays a prediction already fetched.
"""

import os
import logging
import threading

import numpy as np

logger = logging.getLogger(__name__)


class Callback:
    """Base inference callback: called with the accumulated `infos` dict and
    the raw `output` dict of one prediction."""

    def __init__(self, cond = None, initializers = None, name = None):
        self.cond = cond
        self.name = name or self.__class__.__name__
        self._initializers = initializers or []
        self._initialized = False
        self._threads = []

    def initialize(self):
        for fn in self._initializers: fn()
        self._initialized = True

    def __call__(self, infos, output, ** kwargs):
        if not self._initialized: self.initialize()
        if self.cond is not None and not self.cond(infos, output): return infos
        return self.apply(infos, output, ** kwargs)

    def apply(self, infos, output, ** kwargs):
        raise NotImplementedError()

    def join(self):
        for t in self._threads: t.join()
        self._threads = []

    def _maybe_threaded(self, fn, parallel):
        if not parallel:
            fn()
            return
        t = threading.Thread(target = fn, daemon = True)
        t.start()
        self._threads.append(t)


class FileSaver(Callback):
    """Saves one artifact per prediction under an auto-indexed filename
    (``file_format`` with a `{}` placeholder)."""

    def __init__(self, file_format, *, data_key, info_key = None,
                 save_in_parallel = False, ** kwargs):
        super().__init__(** kwargs)
        self.file_format = file_format
        self.data_key = data_key
        self.info_key = info_key or data_key
        self.save_in_parallel = save_in_parallel
        self._index = 0
        self._lock = threading.Lock()
        directory = os.path.dirname(file_format)
        if directory: os.makedirs(directory, exist_ok = True)

    def next_filename(self):
        with self._lock:
            while True:
                filename = self.file_format.format(self._index)
                self._index += 1
                if not os.path.exists(filename):
                    return filename

    def apply(self, infos, output, ** kwargs):
        if self.data_key not in output: return infos
        data = output[self.data_key]
        filename = self.next_filename()
        self._maybe_threaded(
            lambda: self.save(filename, data, output), self.save_in_parallel
        )
        infos[self.info_key] = filename
        return infos

    def save(self, filename, data, output):
        raise NotImplementedError()


class AudioSaver(FileSaver):
    def __init__(self, file_format, rate_key = 'rate', ** kwargs):
        super().__init__(file_format, data_key = 'audio', ** kwargs)
        self.rate_key = rate_key

    def save(self, filename, data, output):
        from ..ops.audio_io import write_audio
        write_audio(filename, np.asarray(data), output.get(self.rate_key, 22050))


class SpectrogramSaver(FileSaver):
    def __init__(self, file_format, ** kwargs):
        super().__init__(file_format, data_key = 'mel', ** kwargs)

    def save(self, filename, data, output):
        if isinstance(data, (list, tuple)):
            data = np.concatenate([np.asarray(m) for m in data], axis = 0) if len(data) else np.zeros((0,))
        np.save(filename, np.asarray(data))


class JSONSaver(Callback):
    """Maintains the ``map.json`` prediction cache: ``{primary_key: infos}``."""

    def __init__(self, data, filename, *, primary_key = 'text',
                 save_in_parallel = False, ** kwargs):
        super().__init__(** kwargs)
        self.data = data
        self.filename = filename
        self.primary_key = primary_key
        self.save_in_parallel = save_in_parallel
        self._lock = threading.Lock()

    def apply(self, infos, output, save = True, ** kwargs):
        key = output.get(self.primary_key, infos.get(self.primary_key))
        if key is None: return infos
        with self._lock:
            self.data[key] = {
                k: v for k, v in {** output, ** infos}.items()
                if _json_friendly(v)
            }
        if save:
            self._maybe_threaded(self._save, self.save_in_parallel)
        return infos

    def _save(self):
        from .file_utils import dump_json
        with self._lock:
            snapshot = dict(self.data)
        dump_json(self.filename, snapshot, indent = 2)


class AudioPlayer(Callback):
    def __init__(self, play = True, display = False, rate_key = 'rate', ** kwargs):
        super().__init__(** kwargs)
        self.play = play
        self.display = display
        self.rate_key = rate_key

    def apply(self, infos, output, ** kwargs):
        if 'audio' not in output: return infos
        from ..ops.audio_io import play_audio, display_audio
        audio, rate = output['audio'], output.get(self.rate_key, 22050)
        if self.display:
            display_audio(audio, rate)
        elif self.play:
            play_audio(audio, rate)
        return infos


class FunctionCallback(Callback):
    def __init__(self, fn, ** kwargs):
        super().__init__(** kwargs)
        self.fn = fn

    def apply(self, infos, output, ** kwargs):
        self.fn(output)
        return infos


class QueueCallback(Callback):
    def __init__(self, queue, ** kwargs):
        super().__init__(** kwargs)
        self.queue = queue

    def apply(self, infos, output, ** kwargs):
        self.queue.put(output)
        return infos


def apply_callbacks(callbacks, infos, output, *, save = True):
    """Run each callback in order, threading the `infos` dict through.
    A raising callback is logged and removed."""
    infos = dict(infos) if infos else {}
    for cb in list(callbacks):
        try:
            result = cb(infos, output, save = save)
            if isinstance(result, dict): infos = result
        except Exception:
            logger.exception('callback %s failed; removing it', getattr(cb, 'name', cb))
            callbacks.remove(cb)
    return infos


def _json_friendly(value):
    if isinstance(value, (str, int, float, bool, type(None))): return True
    if isinstance(value, (list, tuple)):
        return all(_json_friendly(v) for v in value)
    if isinstance(value, dict):
        return all(_json_friendly(v) for v in value.values())
    if isinstance(value, np.number): return True
    return False
