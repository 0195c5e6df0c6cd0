"""Counterpart of `create_iterable` in
``text_to_speech_tpu/utils/generic_utils.py``."""

import queue


def create_iterable(generator, timeout = None):
    """Normalize `generator` into an iterable.

    Accepts: iterables, callables returning iterables, and queue.Queue-like
    objects (drained until a `None` sentinel, with optional `timeout`).
    """
    if isinstance(generator, queue.Queue) or (hasattr(generator, 'get') and not isinstance(generator, dict)):
        def _queue_iterator():
            while True:
                try:
                    item = generator.get(timeout = timeout)
                except queue.Empty:
                    return
                if item is None:
                    return
                yield item
        return _queue_iterator()
    if callable(generator) and not hasattr(generator, '__iter__'):
        return generator()
    return generator
