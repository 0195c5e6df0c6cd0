"""Threaded producer/consumer pipeline for streaming inference.

Counterpart of ``text_to_speech_tpu/utils/stream.py``: the `Stream` class,
`AsyncResult`, `PriorityQueue` and the control tokens.  The host pipeline
overlaps text preprocessing, kernel launches and the file/audio callbacks:
while one text decodes and vocodes on the card, the callbacks of the
previous one run on the host.

A `Stream`'s producer runs on a long-lived daemon thread that an earlier
stream has left idle, where the JAX package starts a new thread: a thread's
first calls on a CUDA device pay its per-thread set-up, about 20 ms of a
one-sentence `tts()` at NVIDIA width on an H100
(``benchmarks/torch_port_stream_overhead.py``).
"""

import heapq
import logging
import threading
import queue as _queue

from concurrent.futures import ThreadPoolExecutor

from .generic_utils import create_iterable

logger = logging.getLogger(__name__)

_idle_producers = []            # task queues of the idle producer threads
_idle_lock = threading.Lock()


def _run_on_producer_thread(task, then):
    """Run `task` on an idle producer thread, or on a new one; `then` runs
    once the thread is idle again, so that a stream started after it
    finds the thread."""
    with _idle_lock:
        tasks = _idle_producers.pop() if _idle_producers else None
    if tasks is None:
        tasks = _queue.SimpleQueue()

        def loop():
            while True:
                task, then = tasks.get()
                try:
                    task()
                finally:
                    with _idle_lock:
                        _idle_producers.append(tasks)
                    then()

        threading.Thread(target = loop, daemon = True, name = 'stream-producer').start()
    tasks.put((task, then))


class StreamToken:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return '<{}>'.format(self.name)


STOP = StreamToken('stop')
KEEP_ALIVE = StreamToken('keep_alive')
IS_RUNNING = StreamToken('is_running')


class AsyncResult:
    """A thread-safe future: `get()` blocks until `set_result`/`set_exception`."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exception = None

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_exception(self, exc):
        self._exception = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def get(self, timeout = None):
        if not self._event.wait(timeout):
            raise TimeoutError('AsyncResult.get timed out')
        if self._exception is not None:
            raise self._exception
        return self._result

    result = get


class PriorityQueue:
    """Thread-safe priority buffer; `get` pops the lowest priority first,
    FIFO within equal priorities."""

    def __init__(self):
        self._heap = []
        self._counter = 0
        self._cond = threading.Condition()

    def put(self, item, priority = 0):
        with self._cond:
            heapq.heappush(self._heap, (priority, self._counter, item))
            self._counter += 1
            self._cond.notify()

    def get(self, timeout = None):
        with self._cond:
            if not self._cond.wait_for(lambda: self._heap, timeout = timeout):
                raise _queue.Empty()
            return heapq.heappop(self._heap)[2]

    def qsize(self):
        with self._cond:
            return len(self._heap)

    def empty(self):
        return self.qsize() == 0


class Stream:
    """Apply `fn` to each item of `inputs` on worker thread(s), yielding
    results as they complete (in submission order).

    - ``workers = 0``: synchronous (inline) execution.
    - ``workers = 1``: one producer thread + prefetch buffer.
    - ``workers = N``: thread pool, results re-ordered to submission order.

    Control tokens in the input stream: `STOP` ends the stream; `KEEP_ALIVE`
    is skipped.  Callbacks: `start_callback`, `item_callback(result)`,
    `stop_callback`.  A callback raising is logged and the callback removed.
    An error of `fn` ends the stream and is raised to the consumer.
    """

    def __init__(self,
                 fn,
                 inputs = None,
                 *,
                 workers = 1,
                 max_buffer = 8,
                 start_callback = None,
                 item_callback = None,
                 stop_callback = None,
                 ** kwargs
                ):
        self.fn = fn
        self.inputs = inputs
        self.workers = workers
        self.max_buffer = max_buffer
        self.kwargs = kwargs

        self._callbacks = {
            'start': list(_as_list(start_callback)),
            'item': list(_as_list(item_callback)),
            'stop': list(_as_list(stop_callback)),
        }
        self._stopped = threading.Event()

    # -- callback handling -----------------------------------------------------

    def _run_callbacks(self, kind, *args):
        for cb in list(self._callbacks[kind]):
            try:
                cb(*args)
            except Exception:
                logger.exception('%s callback failed; removing it', kind)
                self._callbacks[kind].remove(cb)

    # -- iteration -------------------------------------------------------------

    def _iter_inputs(self):
        for item in create_iterable(self.inputs):
            if item is STOP or (isinstance(item, StreamToken) and item.name == 'stop'):
                return
            if isinstance(item, StreamToken):
                continue
            yield item
            if self._stopped.is_set():
                return

    def items(self):
        """Generator over results (submission order)."""
        self._run_callbacks('start')
        try:
            if self.workers <= 0:
                for item in self._iter_inputs():
                    result = self.fn(item, ** self.kwargs)
                    self._run_callbacks('item', result)
                    yield result
            else:
                yield from self._items_threaded()
        finally:
            self._stopped.set()
            self._run_callbacks('stop')

    def _items_threaded(self):
        buffer = _queue.Queue(maxsize = self.max_buffer)
        DONE = StreamToken('done')
        finished = threading.Event()

        def producer():
            try:
                if self.workers == 1:
                    for item in self._iter_inputs():
                        try:
                            buffer.put(('ok', self.fn(item, ** self.kwargs)))
                        except Exception as e:
                            buffer.put(('err', e))
                else:
                    with ThreadPoolExecutor(max_workers = self.workers) as pool:
                        futures = [
                            pool.submit(self.fn, item, ** self.kwargs)
                            for item in self._iter_inputs()
                        ]
                        for fut in futures:
                            try:
                                buffer.put(('ok', fut.result()))
                            except Exception as e:
                                buffer.put(('err', e))
            finally:
                buffer.put(('done', DONE))

        _run_on_producer_thread(producer, finished.set)

        while True:
            kind, value = buffer.get()
            if kind == 'done':
                break
            if kind == 'err':
                self._stopped.set()
                # drain while the producer winds down: a full buffer would
                # otherwise block it, and this wait, for ever
                while not finished.is_set():
                    try:
                        buffer.get(timeout = 0.05)
                    except _queue.Empty:
                        pass
                raise value
            self._run_callbacks('item', value)
            yield value
        finished.wait()

    def stop(self):
        self._stopped.set()

    def __iter__(self):
        return self.items()

    def __call__(self, item, ** kwargs):
        """Submit one item asynchronously; returns an AsyncResult."""
        result = AsyncResult()

        def run():
            try:
                result.set_result(self.fn(item, ** {** self.kwargs, ** kwargs}))
            except Exception as e:
                result.set_exception(e)

        threading.Thread(target = run, daemon = True).start()
        return result


def _as_list(x):
    if x is None: return []
    if isinstance(x, (list, tuple)): return list(x)
    return [x]
