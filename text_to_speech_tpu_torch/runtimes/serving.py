"""Batched streaming inference server (host-side request engines and the
steppers that drive the models through them).

Counterpart of ``text_to_speech_tpu/runtimes/serving.py``:

  - `ServingEngine`: dynamic batching of whole requests into one
    ``batch_fn`` call (`make_tts_batch_fn` builds one on a Tacotron-2
    task model);
  - `ContinuousServingEngine`: in-flight batching, the decode advancing in
    chunks and new requests admitted into free rows at every chunk
    boundary, with admission prefetch (``admit_ahead``), batched admission
    and finish (``start_many`` / ``finish_many``, each falling back to the
    per-request calls), finish on a worker thread, abort at a chunk
    boundary, `warmup` over the pow2 batch buckets and completion events;
  - `make_tacotron_stepper`: the (start, step, finish) functions of a
    Tacotron-2 task model: encode at admission, the active batch kept on
    the device between chunks (one `decode_chunk` call and two small reads
    a chunk), token buckets with re-bucketing of live rows, gate
    completion, the masked postnet and, with ``stream_audio``, audio
    emitted at every chunk boundary through the vocoder;
  - `make_vits_stepper`: a VITS task model's latent stage at admission and
    windowed waveform decode, optionally pipelined (the next chunk queued
    before the previous one is read from pinned host memory).

Both engines keep their queue in `native.scheduler.RequestScheduler` (the
C++ core; `native_scheduler=False` selects its Python twin).  The device
work is the models' own: on a card the Tacotron-2 stepper decodes on the
fused decoder kernel (`ops.decoder_kernel.decoder_steps`, one launch a
chunk for each group of at most 8 rows) wherever its envelope holds, and
its streamed audio goes through the vocoder's WN-block kernel.

``mesh=`` (a `parallel.Mesh`, one process per device) serves across
devices through `mesh_stepper`: a controller and its followers.  The mesh's
first rank runs the engine (and the HTTP server); its start / step / finish
calls broadcast their host arguments over the mesh, every rank runs the
single-device stepper on the rows it owns (a request's row stays on the
rank that admitted it, its encode and device state included), and the
per-row results and callbacks gather back to the controller.  The other
ranks run `step_fn.follow()` until the controller's engine stops.
"""

import collections
import itertools
import logging
import threading
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from ..native.scheduler import RequestScheduler
from ..parallel import collectives, data_axes, shard_params
from ..utils.sequence_utils import pad_batch
from ..utils.stream import AsyncResult

logger = logging.getLogger(__name__)



class InferenceRequest:
    _ids = itertools.count()

    def __init__(self, inputs, *, callback = None, ** kwargs):
        self.request_id = next(InferenceRequest._ids)
        self.inputs = inputs
        self.callback = callback
        self.kwargs = kwargs
        self.result = AsyncResult()
        self.aborted = threading.Event()
        self._on_abort = None

    def abort(self):
        self.aborted.set()
        if self._on_abort is not None:
            self._on_abort(self)


def warm_thread(device):
    """Pay a new thread's first CUDA calls (the per-thread cuBLAS and cuDNN
    handles) with a tiny product and convolution on `device`; nothing on
    the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return
    with torch.no_grad():
        x = torch.ones((8, 8), device = device)
        F.conv1d((x @ x)[None], x[:, :, None])
    torch.cuda.synchronize(device)


class _SchedulerMixin:
    """Shared request bookkeeping over the C++ `RequestScheduler`
    (``native/serving_native.cpp``; its Python twin has the same
    semantics).  Queue order, the dynamic-batching window, priorities,
    queued-abort and latency accounting run native-side; the id → request
    map stays here."""

    def _init_scheduler(self, force_python = False):
        self._sched = RequestScheduler(force_python = force_python)
        self._pending = {}                  # scheduler id -> request
        self._pending_cv = threading.Condition()

    def _count(self, key):
        """One more in ``stats[key]``: submitting and aborting threads count
        beside the loop thread, so the read-modify-write takes the lock."""
        with self._pending_cv:
            self.stats[key] += 1

    def _enqueue(self, request, priority = 0):
        rid = self._sched.submit(priority)
        request.request_id = rid
        with self._pending_cv:
            self._pending[rid] = request
            self._pending_cv.notify_all()
        request._on_abort = self._abort_queued
        return request

    def _abort_queued(self, request):
        """Queued requests are removed scheduler-side and failed now; a
        collected request is handled by the engine loop."""
        if self._sched.abort(request.request_id):
            with self._pending_cv:
                self._pending.pop(request.request_id, None)
            self._count('aborted')
            request.result.set_exception(
                RuntimeError('request {} aborted'.format(request.request_id)))

    def _resolve(self, ids):
        """id -> request.  A collected id may briefly precede its map entry
        (submit() makes the id collectable before the submitting thread
        registers the payload), so missing ids are awaited: the entry is
        sure to arrive, because only queued requests can be aborted."""
        out = []
        with self._pending_cv:
            for rid in ids:
                if self._pending_cv.wait_for(lambda: rid in self._pending, timeout = 5.):
                    out.append(self._pending.pop(rid))
                else:                       # defensive: never expected
                    logger.error('collected id %s has no pending request', rid)
        return out

    def _finish(self, request, output = None, error = None):
        """Terminal bookkeeping for a COLLECTED request: latency stamp on
        every path (success, failure, late abort), then resolve the
        AsyncResult.  Idempotent: a second call (the async-finish guard
        error-finishing a batch whose leading rows already resolved) is a
        no-op, so a mid-batch failure never double-completes."""
        if request.result.done():
            return
        self._sched.complete(request.request_id)
        if error is not None:
            request.result.set_exception(error)
        else:
            request.result.set_result(output)

    @property
    def scheduler_stats(self):
        """Native-side counters: mean queue wait / end-to-end latency."""
        return self._sched.stats

    @property
    def native_scheduler(self):
        """True when the C++ scheduler core serves (not its Python twin)."""
        return self._sched.native


class ServingEngine(_SchedulerMixin):
    """Dynamic-batching engine around a ``batch_fn``.

    ``batch_fn(list_of_inputs, **kwargs) -> list_of_outputs``: typically a
    closure over a task model's `compiled_infer` with padded batching
    (`make_tts_batch_fn`).

    - requests accumulate up to `max_batch_size` or `max_wait_ms` (the
      window is kept by the C++ scheduler core);
    - higher-``priority`` requests dequeue first (FIFO within a priority);
    - per-request callbacks stream results as they complete;
    - `submit` returns the request (with an AsyncResult); `abort()`able while
      queued.
    """

    def __init__(self, batch_fn, *, max_batch_size = 8, max_wait_ms = 10.,
                 name = 'serving', native_scheduler = True):
        self.batch_fn = batch_fn
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.name = name
        self._init_scheduler(force_python = not native_scheduler)
        self._thread = None
        self._running = threading.Event()
        self.stats = {'requests': 0, 'batches': 0, 'aborted': 0}

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        if self._running.is_set(): return self
        self._running.set()
        self._thread = threading.Thread(target = self._loop, daemon = True, name = self.name)
        self._thread.start()
        return self

    def stop(self):
        self._running.clear()
        self._sched.wake()
        try:
            self._stop_loop()
        finally:
            # a mesh stepper's followers leave their loop with the engine
            close = getattr(getattr(self, 'step_fn', None), 'close', None)
            if close is not None:
                close()

    def _stop_loop(self):
        if self._thread:
            self._thread.join(timeout = 10)

    def __enter__(self):
        return self.start()

    def __exit__(self, * exc):
        self.stop()

    # -- API -------------------------------------------------------------------

    def submit(self, inputs, *, callback = None, priority = 0, ** kwargs):
        request = InferenceRequest(inputs, callback = callback, ** kwargs)
        self._count('requests')
        return self._enqueue(request, priority)

    def infer(self, inputs, *, timeout = None, ** kwargs):
        """Blocking convenience wrapper."""
        return self.submit(inputs, ** kwargs).result.get(timeout = timeout)

    def warmup(self, sample_inputs, *, batch_sizes = None):
        """Run `batch_fn` at the batch sizes live traffic takes (default:
        the pow2 buckets up to `max_batch_size`) before accepting traffic,
        so that the first live requests find the kernels built and the
        allocator's blocks cached.  Call BEFORE `start()`.  Returns elapsed
        seconds."""
        if self._running.is_set():
            raise RuntimeError('warmup() must run before start()')
        if not isinstance(sample_inputs, (list, tuple)):
            sample_inputs = [sample_inputs]
        if batch_sizes is None:
            batch_sizes = _pow2_buckets(self.max_batch_size)
        t0 = time.perf_counter()
        for sample in sample_inputs:
            for b in batch_sizes:
                self.batch_fn([sample] * b)
        return time.perf_counter() - t0

    # -- engine loop -----------------------------------------------------------

    def _collect_batch(self):
        ids = self._sched.collect(self.max_batch_size, first_timeout = 0.1,
                                  batch_wait = self.max_wait_ms / 1000.)
        return self._resolve(ids)

    def _loop(self):
        while self._running.is_set():
            batch = self._collect_batch()
            if not batch: continue
            live = []
            for request in batch:
                if request.aborted.is_set():
                    self._count('aborted')
                    self._finish(request, error = RuntimeError(
                        'request {} aborted'.format(request.request_id)))
                else:
                    live.append(request)
            if not live: continue

            self.stats['batches'] += 1
            try:
                # pad the batch to a pow2 bucket (duplicating one row) so
                # batch_fn only ever sees the shapes warmup() ran
                inputs = [r.inputs for r in live]
                inputs += [inputs[0]] * (_pow2(len(inputs)) - len(inputs))
                outputs = self.batch_fn(inputs)
            except Exception as e:
                logger.exception('batch_fn failed')
                for request in live:
                    self._finish(request, error = e)
                continue

            for request, output in zip(live, outputs):
                if request.callback is not None:
                    try:
                        request.callback(output, request.request_id)
                    except Exception:
                        logger.exception('request callback failed')
                self._finish(request, output)


class ContinuousServingEngine(_SchedulerMixin):
    """In-flight (continuous) batching: the decode advances in bounded
    chunks, and NEW requests are admitted into free batch rows at every
    chunk boundary, so a request submitted mid-decode does not wait for the
    whole prior batch to finish (plain `ServingEngine` only batches while
    queued).

    Contract (model-agnostic; see `make_tacotron_stepper` for the TTS one):
      - ``start_fn(inputs, **kwargs) -> state``  (admit: encode, init carry)
      - ``step_fn(states) -> (new_states, done_flags)``  (one chunk for the
        whole active batch)
      - ``finish_fn(state) -> output``  (collect result, e.g. postnet+vocode)

    Optional attributes of the functions: ``start_fn.start_many(inputs,
    kwargs_list)`` and ``start_fn.batchable_kwargs`` (batched admission),
    ``finish_fn.finish_many(states)`` and ``finish_fn.async_ok`` (batched
    finish, on a worker thread), ``step_fn.warm_thread()`` (run once on
    each thread of the engine when it starts: the steppers pay a new
    thread's first CUDA calls there, so the first live request does not).

    Per-request wall-clock latency is recorded in ``stats['latencies']``,
    (wall time, audio samples) of each resolved request in
    ``stats['completions']``."""

    def __init__(self, start_fn, step_fn, finish_fn = None, *,
                 max_batch_size = 8, name = 'serving-cb',
                 native_scheduler = True, async_admission = True,
                 async_finish = None, admit_ahead = None):
        self.start_fn = start_fn
        self.step_fn = step_fn
        self.finish_fn = finish_fn or (lambda state: state)
        self.max_batch_size = max_batch_size
        # admission PREFETCH: keep up to `admit_ahead` requests pre-admitted
        # (state built, encode done) BEYOND the batch, so a slot freed by a
        # completing row refills at the very next chunk boundary instead of
        # idling while the admission worker runs.  Prefetched requests were
        # already dequeued, so a later higher-priority submit overtakes only
        # the still-queued tail: bounded priority inversion, the standard
        # continuous-batching trade.  0 disables.
        if admit_ahead is None:
            admit_ahead = getattr(start_fn, 'admit_ahead', max(1, max_batch_size // 2))
        self._admit_ahead = int(admit_ahead)
        # pacing: once the ready pool is non-empty and the batch can stay
        # full, top up only in bursts of >= half the prefetch depth: each
        # admission burst is one encode on the device the chunk loop runs
        # on, so many 1-row top-ups steal more device time than a few
        # batched ones
        self._admit_burst = max(1, self._admit_ahead // 2)
        self.name = name
        self._init_scheduler(force_python = not native_scheduler)
        self._thread = None
        self._admit_pool = None
        self._finish_pool = None
        self._async_admission = bool(async_admission)
        # finish (postnet + vocode + fetch) on a worker thread, overlapped
        # with the decode loop.  None = auto: enabled when the stepper marks
        # its finish_fn thread-safe (`finish_fn.async_ok`; a finish that
        # shares mutable chunk state with step_fn, like the VITS stepper's
        # parked-fetch buffer, must NOT set it).
        self._async_finish = async_finish
        self._running = threading.Event()
        # bounded: a long-running server must not grow per-request state.
        # step_s/admit_s/finish_s + rows_stepped expose the loop's time
        # split and batch occupancy
        self.stats = {'requests': 0, 'chunks': 0, 'aborted': 0,
                      'step_s': 0., 'admit_s': 0., 'finish_s': 0.,
                      'rows_stepped': 0,
                      'latencies': collections.deque(maxlen = 10_000),
                      # (wall time, audio samples) per resolved request
                      'completions': collections.deque(maxlen = 10_000)}

    def start(self):
        if self._running.is_set(): return self
        self._running.set()
        warm = getattr(self.step_fn, 'warm_thread', None)
        if self._async_admission and self._admit_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            # ONE worker: admissions stay serialized with each other but
            # overlap the loop thread's step_fn launches
            self._admit_pool = ThreadPoolExecutor(
                max_workers = 1, thread_name_prefix = self.name + '-admit')
        use_async_finish = self._async_finish
        if use_async_finish is None:
            use_async_finish = bool(getattr(self.finish_fn, 'async_ok', False))
        if use_async_finish and self._finish_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            # ONE worker: finishes stay ordered with each other but overlap
            # the loop thread's decode chunks
            self._finish_pool = ThreadPoolExecutor(
                max_workers = 1, thread_name_prefix = self.name + '-finish')
        warmed = threading.Event()
        self._thread = threading.Thread(target = self._loop, args = (warm, warmed),
                                        daemon = True, name = self.name)
        self._thread.start()
        if warm is not None:
            try:
                # the pools' one thread each is made by this submit and kept
                for pool in (self._admit_pool, self._finish_pool):
                    if pool is not None:
                        pool.submit(warm).result()
                warmed.wait()
                if self._warm_error is not None:
                    raise self._warm_error
            except Exception:
                self.stop()
                raise
        return self

    def stop(self):
        self._running.clear()
        self._sched.wake()
        try:
            self._stop_loop()
        finally:
            # a mesh stepper's followers leave their loop with the engine
            close = getattr(getattr(self, 'step_fn', None), 'close', None)
            if close is not None:
                close()

    def _stop_loop(self):
        if self._thread:
            self._thread.join(timeout = 10)
            if self._thread.is_alive():
                # the loop thread outlived the timed join: tearing the pools
                # down now would race its next submit (RuntimeError on a
                # shut-down executor, unresolved request futures).  Leave the
                # pools up: the daemon thread still drains through them, and
                # _finish_completed falls back to sync finish if a submit
                # ever hits a closed pool.
                logger.warning('%s loop thread did not exit within 10s; '
                               'keeping worker pools alive', self.name)
                return
        if self._admit_pool is not None:
            self._admit_pool.shutdown(wait = True)
            self._admit_pool = None
        if self._finish_pool is not None:
            # drain queued finishes so every submitted request resolves
            self._finish_pool.shutdown(wait = True)
            self._finish_pool = None

    def __enter__(self):
        return self.start()

    def __exit__(self, * exc):
        self.stop()

    def submit(self, inputs, *, callback = None, priority = 0, ** kwargs):
        request = InferenceRequest(inputs, callback = callback, ** kwargs)
        request.submitted_at = time.perf_counter()
        self._count('requests')
        return self._enqueue(request, priority)

    def infer(self, inputs, *, timeout = None, ** kwargs):
        return self.submit(inputs, ** kwargs).result.get(timeout = timeout)

    def warmup(self, sample_inputs, *, batch_sizes = None, max_chunks = 1000, ** kwargs):
        """Run the stepper at every pow2 active-batch bucket before accepting
        traffic: `start_fn` (or `start_many`), `step_fn` to completion and
        `finish_fn` (or `finish_many`) once per bucket, so that the first
        live requests find the kernels built and the allocator's blocks
        cached.

        Call BEFORE `start()`.  `sample_inputs` should cover the
        input-length buckets expected live (e.g. a short and a long text:
        the steppers pad tokens to `token_multiple`).  Each bucket's batch
        runs to completion, which leaves the stepper's device batch clean.
        Returns elapsed seconds."""
        if self._running.is_set():
            raise RuntimeError('warmup() must run before start()')
        if not isinstance(sample_inputs, (list, tuple)):
            sample_inputs = [sample_inputs]
        if batch_sizes is None:
            batch_sizes = _pow2_buckets(self.max_batch_size)
        start_many = getattr(self.start_fn, 'start_many', None)
        finish_many = getattr(self.finish_fn, 'finish_many', None)
        t0 = time.perf_counter()
        for sample in sample_inputs:
            for b in batch_sizes:
                if start_many is not None and b > 1:
                    states = start_many([sample] * b, [kwargs] * b)
                else:
                    states = [self.start_fn(sample, ** kwargs) for _ in range(b)]
                for _ in range(max_chunks):
                    states, done = self.step_fn(states)
                    if all(done):
                        break
                if finish_many is not None and b > 1:
                    finish_many(states)
                else:
                    for st in states:
                        self.finish_fn(st)
        return time.perf_counter() - t0

    def _collect_live(self, free, block):
        """Pull up to `free` queued requests and drop already-aborted ones."""
        if block:
            ids = self._sched.collect(free, first_timeout = 0.05, batch_wait = 0.)
        else:
            ids = self._sched.collect_nowait(free)
        live = []
        for request in self._resolve(ids):
            if request.aborted.is_set():
                self._count('aborted')
                self._finish(request, error = RuntimeError(
                    'request {} aborted'.format(request.request_id)))
                continue
            live.append(request)
        return live

    def _start_requests(self, live):
        """Admit a burst → [(request, state)] (failures resolved inline).

        Batched admission: one start_many call for the whole burst when
        the stepper offers it (per-request start_fn serializes a device
        call and a blocking read per request).  Requests with custom kwargs
        beyond the batchable ones keep the single path.  Runs on the
        admission worker thread when admissions overlap stepping (see
        `_loop`)."""
        start_many = getattr(self.start_fn, 'start_many', None)
        batchable_keys = getattr(self.start_fn, 'batchable_kwargs', ('on_audio',))
        batchable = [r for r in live if set(r.kwargs) <= set(batchable_keys)] \
            if start_many is not None else []
        singles = [r for r in live if r not in batchable]

        admitted = []
        t0 = time.perf_counter()
        if len(batchable) > 1:
            try:
                states = start_many([r.inputs for r in batchable],
                                    [r.kwargs for r in batchable])
                if len(states) != len(batchable):
                    # zip() would silently drop the tail request, which would
                    # then never resolve: treat as a failed batch
                    raise RuntimeError('start_many returned {} states for {} requests'
                                       .format(len(states), len(batchable)))
                admitted.extend(zip(batchable, states))
                batchable = []
            except Exception:
                logger.exception('start_many failed; falling back to per-request admission')
        for request in batchable + singles:
            try:
                state = self.start_fn(request.inputs, ** request.kwargs)
            except Exception as e:
                logger.exception('start_fn failed')
                self._finish(request, error = e)
                continue
            admitted.append((request, state))
        self.stats['admit_s'] += time.perf_counter() - t0
        return admitted

    def _loop(self, warm = None, warmed = None):
        self._warm_error = None
        if warm is not None:
            try:
                warm()
            except Exception as e:
                self._warm_error = e
                return
            finally:
                warmed.set()
        slots = []          # [(request, state)]: the active batch rows
        ready = []          # pre-admitted rows awaiting a free slot
        # admissions OVERLAP stepping: while the device runs chunk k, the
        # admission worker prepares the next burst's states
        inflight = None     # (future, n_requests) on the admission worker
        while self._running.is_set():
            if inflight is not None and inflight[0].done():
                ready.extend(inflight[0].result())
                inflight = None
            # freed slots refill at once from the ready pool (the admission
            # was already paid, overlapped with earlier chunks)
            while ready and len(slots) < self.max_batch_size:
                slots.append(ready.pop(0))
            reserved = inflight[1] if inflight is not None else 0
            short = self.max_batch_size - len(slots) - len(ready) - reserved
            # a single burst is capped at max_batch: start_many pads to pow2
            # row buckets and warmup() runs them only up to max_batch
            want = min(short + self._admit_ahead, self.max_batch_size)
            # admit when the batch cannot stay full without it (short > 0)
            # or a paced top-up burst is due (see _admit_burst)
            if inflight is None and want > 0 and (
                    short > 0 or not ready or want >= self._admit_burst):
                live = self._collect_live(want, block = not slots)
                if live:
                    if self._admit_pool is not None and slots:
                        inflight = (self._admit_pool.submit(self._start_requests, live),
                                    len(live))
                    else:
                        ready.extend(self._start_requests(live))
                        while ready and len(slots) < self.max_batch_size:
                            slots.append(ready.pop(0))
            if not slots:
                if inflight is not None:
                    ready.extend(inflight[0].result())
                    inflight = None
                    while ready and len(slots) < self.max_batch_size:
                        slots.append(ready.pop(0))
                continue
            live = [(r, s) for r, s in slots if not r.aborted.is_set()]
            discard = getattr(self.finish_fn, 'discard', None)
            for request, state in slots:
                if request.aborted.is_set():
                    if discard is not None:
                        discard(state)
                    self._count('aborted')
                    self._finish(request, error = RuntimeError(
                        'request {} aborted'.format(request.request_id)))
            if not live:
                slots = []
                continue
            self.stats['chunks'] += 1
            self.stats['rows_stepped'] += len(live)
            t0 = time.perf_counter()
            try:
                states, done = self.step_fn([s for _, s in live])
            except Exception as e:
                logger.exception('step_fn failed')
                for request, _ in live:
                    self._finish(request, error = e)
                slots = []
                if getattr(e, 'fatal', False):
                    # the stepper cannot serve again (a mesh rank failed):
                    # stop, and fail what is queued rather than leave it
                    self._running.clear()
                    for request in self._resolve(self._sched.collect_nowait(1 << 30)):
                        self._finish(request, error = e)
                continue
            finally:
                dt = time.perf_counter() - t0
                self.stats['step_s'] += dt
                # chunk cost per pow2 row bucket: {bucket: (chunks, seconds)}
                bucket = _pow2(len(live))
                by = self.stats.setdefault('chunk_s_by_rows', {})
                n, total = by.get(bucket, (0, 0.))
                by[bucket] = (n + 1, total + dt)
            slots = []
            completed = []
            for (request, _), state, is_done in zip(live, states, done):
                if not is_done:
                    slots.append((request, state))
                else:
                    completed.append((request, state))
            if completed:
                self._finish_completed(completed)

        # shutdown: requests whose admission was still in flight (or parked
        # in the ready pool) must not hang their callers
        if inflight is not None:
            try:
                ready.extend(inflight[0].result(timeout = 30))
            except Exception:
                logger.exception('in-flight admission failed at shutdown')
        for request, _ in ready:
            self._finish(request, error = RuntimeError('engine stopped during admission'))

    def _finish_completed(self, completed):
        if self._finish_pool is not None:
            try:
                self._finish_pool.submit(self._finish_guarded, completed)
                return
            except RuntimeError:
                # pool already shut down (stop() raced the loop's last
                # chunk): resolve inline so no request future hangs
                pass
        self._finish_completed_sync(completed)

    def _finish_guarded(self, completed):
        """Worker-thread wrapper: an unexpected error must resolve every
        request (an unobserved future would hang the callers)."""
        try:
            self._finish_completed_sync(completed)
        except Exception as e:
            logger.exception('async finish failed')
            for request, _ in completed:
                self._finish(request, error = e)

    def _finish_completed_sync(self, completed):
        """Resolve this chunk's finished rows.  When several rows complete
        at the same boundary and the stepper offers
        ``finish_fn.finish_many``, ONE batched finish call serves them all;
        a wrong-length or failing batch falls back to per-request
        finishes."""
        finish_many = getattr(self.finish_fn, 'finish_many', None)
        t0 = time.perf_counter()
        outputs = None
        if finish_many is not None and len(completed) > 1:
            try:
                outputs = finish_many([s for _, s in completed])
                if len(outputs) != len(completed):
                    raise RuntimeError('finish_many returned {} outputs for {} states'
                                       .format(len(outputs), len(completed)))
            except Exception:
                logger.exception('finish_many failed; falling back to per-request finish')
                outputs = None
        for i, (request, state) in enumerate(completed):
            if outputs is not None:
                output = outputs[i]
            else:
                try:
                    output = self.finish_fn(state)
                except Exception as e:
                    logger.exception('finish_fn failed')
                    self._finish(request, error = e)
                    continue
            now = time.perf_counter()
            self.stats['latencies'].append(now - getattr(request, 'submitted_at', now))
            audio = output.get('audio') if isinstance(output, dict) else None
            self.stats['completions'].append((now, 0 if audio is None else len(audio)))
            if request.callback is not None:
                try:
                    request.callback(output, request.request_id)
                except Exception:
                    logger.exception('request callback failed')
            self._finish(request, output)
        self.stats['finish_s'] += time.perf_counter() - t0


def _pow2_buckets(max_batch_size):
    """[1, 2, 4, ..., pow2 ≥ max_batch_size]: the batch shapes the engines
    run at (see `_pow2`; both the steppers and `ServingEngine._loop` pad
    collected batches to pow2, so a non-pow2 `max_batch_size` still rounds
    up)."""
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b <<= 1
    buckets.append(b)
    return buckets


def _bucket(n, n_data = 1):
    """Padded ACTIVE-BATCH size for `n` rows over `n_data` data shards:
    ``n_data * pow2(ceil(n / n_data))``, always divisible by `n_data`; with
    one shard plain pow2 bucketing (each rank of a `mesh_stepper` pads its
    own rows so)."""
    return n_data * _pow2(max(1, -(-n // n_data)))


def _pow2(n):
    """Next power of two ≥ n.  The steppers pad the ACTIVE BATCH to pow2
    buckets, so the kernels launch at a few row counts (those `warmup`
    runs) and not at every active-set size.  Pad rows duplicate row 0
    (valid compute, no empty masks) and exist only inside the stacked
    device batch; per-request results index real rows only."""
    p = 1
    while p < n:
        p <<= 1
    return p


def _tree_map(fn, * trees):
    """`fn` over the leaves of nested tuples of tensors (the cell state)."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, * leaves) for leaves in zip(* trees))
    return fn(* trees)


def _encode_tokens(model, texts, token_multiple):
    """Texts → one (n, S) token batch, S the longest padded to
    `token_multiple` with the model's blank token."""
    toks = [np.asarray(model.encode_text(t)) for t in texts]
    s = -(-max(len(t) for t in toks) // token_multiple) * token_multiple
    return np.stack([np.pad(t, (0, s - len(t)), constant_values = model.blank_token_idx)
                     for t in toks])


def _pad_rows_pow2(tokens):
    """A token batch padded to a pow2 row bucket with copies of row 0."""
    n = tokens.shape[0]
    bucket = _bucket(n, 1)
    if bucket > n:
        tokens = np.concatenate([tokens, np.broadcast_to(tokens[:1],
                                                         (bucket - n,) + tokens.shape[1:])])
    return tokens


class MeshStepperError(RuntimeError):
    """A rank of a mesh stepper failed: the mesh cannot serve again
    (``fatal``: the engine stops)."""
    fatal = True


#: the per-request callbacks a stepper calls; on a mesh they run on the
#: controller, replayed from the owner's calls
_CALLBACKS = ('on_audio', 'on_token')


def sync_weights(mesh, * models):
    """Every rank's `models` (task models with ``params`` / ``state``) set
    to the weights of the mesh's first rank (`parallel.shard_params`)."""
    for m in models:
        if m is None or not hasattr(m, 'set_weights'):
            continue
        state = getattr(m, 'state', None)
        m.set_weights(shard_params(m.params, mesh),
                      shard_params(state, mesh) if state else None)


def mesh_stepper(mesh, local, *, capacity = None):
    """(start_fn, step_fn, finish_fn) serving across the ranks of `mesh`
    (a controller and its followers) with `local`, this rank's
    single-device (start_fn, step_fn, finish_fn), built on its device.

    The mesh's first rank is the controller: its functions, called by the
    engine (on any of its threads; the calls are serialized), broadcast
    their host arguments over the mesh, run the local stepper on the rows
    this rank owns, and gather every rank's per-row results.  Every other
    rank calls ``step_fn.follow()``, which runs the same operations until
    the controller's ``step_fn.close()`` (the engine's `stop`).  A request's
    row is owned by the data shard with the fewest live rows when it is
    admitted (at most `capacity` each) and stays there: its admission
    (encode, prefill) runs on that rank and its device state never moves.
    Ranks that differ only along non-data axes are replicas.  Callbacks
    (``on_audio``, ``on_token``) run on the controller, in the owner's
    order; other keywords must pickle.  A rank without rows in a chunk
    skips it.  An exception on any rank fails the operation on every rank:
    the controller raises `MeshStepperError` (the engine stops) and the
    followers leave their loop with it; a request that a stepper refuses at
    admission fails alone."""
    start_local, step_local, finish_local = local
    group = mesh.group(mesh.axis_names)
    src = mesh.first_rank
    controller = mesh.rank == src
    axes = data_axes(mesh)
    n_data = mesh.axis_size(axes)
    me = mesh.axis_index(axes)
    lock = threading.Lock()
    seq = itertools.count()
    chan = {'error': None, 'closed': False}
    owner = {}                  # seq -> data shard (every rank)
    rows = {}                   # seq -> local state (the owner's ranks)
    load = [0] * n_data         # live rows a shard (controller)
    live = {}                   # seq -> proxy state (controller)
    outbox = []                 # (seq, callback, args) of this rank's calls
    stats = {'admitted': 0, 'chunks': 0, 'rows_stepped': 0}     # this rank's rows

    def recorder(sid, name):
        return lambda * args: outbox.append((sid, name, args))

    def handle(op, payload):
        del outbox[:]
        out = {}
        if op == 'start':
            mine = []
            for sid, shard, inputs, kwargs, names in payload:
                owner[sid] = shard
                if shard == me:
                    kwargs = dict(kwargs, ** {n: recorder(sid, n) for n in names})
                    mine.append((sid, inputs, kwargs))
            start_many = getattr(start_local, 'start_many', None)
            states = None
            if len(mine) > 1 and start_many is not None:
                try:
                    states = start_many([m[1] for m in mine], [m[2] for m in mine])
                except Exception:
                    logger.exception('start_many failed; admitting one by one')
            for i, (sid, inputs, kwargs) in enumerate(mine):
                try:
                    rows[sid] = states[i] if states is not None \
                        else start_local(inputs, ** kwargs)
                    stats['admitted'] += 1
                    out[sid] = None
                except Exception as e:
                    out[sid] = e
        elif op == 'step':
            mine = [sid for sid in payload if owner[sid] == me]
            if mine:
                stats['chunks'] += 1
                stats['rows_stepped'] += len(mine)
                states, done = step_local([rows[sid] for sid in mine])
                for sid, st, d in zip(mine, states, done):
                    rows[sid] = st
                    out[sid] = bool(d)
        elif op == 'finish':
            mine = [sid for sid in payload if owner[sid] == me]
            finish_many = getattr(finish_local, 'finish_many', None)
            if len(mine) > 1 and finish_many is not None:
                results = finish_many([rows[sid] for sid in mine])
            else:
                results = [finish_local(rows[sid]) for sid in mine]
            out.update(zip(mine, results))
            for sid in payload:
                rows.pop(sid, None)
                owner.pop(sid, None)
        elif op == 'discard':
            for sid in payload:
                rows.pop(sid, None)
                owner.pop(sid, None)
        else:
            raise ValueError('unknown mesh stepper operation {!r}'.format(op))
        return out, list(outbox)

    def run(op, payload):
        """One operation on this rank, and every rank's outcome."""
        try:
            mine = (True, handle(op, payload))
        except Exception:
            mine = (False, 'rank {}: {}'.format(mesh.rank, traceback.format_exc()))
        outs = collectives.all_gather_objects(mine, group)
        failed = [o[1] for o in outs if not o[0]]
        if failed:
            chan['error'] = '\n'.join(failed)
            raise MeshStepperError('mesh stepper operation {!r} failed:\n{}'.format(
                op, chan['error']))
        results, calls = {}, []
        for _, (out, outbox_r) in outs:
            for sid, value in out.items():
                results.setdefault(sid, value)
            calls.extend(outbox_r)
        return results, calls

    def call(op, payload):
        if not controller:
            raise RuntimeError('rank {} follows the mesh: only rank {} calls the stepper'
                               .format(mesh.rank, src))
        with lock:
            if chan['error'] is not None:
                raise MeshStepperError('the mesh stepper failed earlier:\n' + chan['error'])
            if chan['closed']:
                raise RuntimeError('the mesh stepper is closed')
            collectives.broadcast_object((op, payload), src, group)
            results, calls = run(op, payload)
        # a call may deliver other rows' parts too (a flush of a shared chunk)
        for sid, name, args in calls:
            fn = live[sid]['_callbacks'].get(name) if sid in live else None
            if fn is not None:
                try:
                    fn(* args)
                except Exception:
                    logger.exception('%s callback failed', name)
        return results

    def start_many(inputs_list, kwargs_list):
        proxies, payload = [], []
        for inputs, kwargs in zip(inputs_list, kwargs_list):
            free = [d for d in range(n_data) if capacity is None or load[d] < capacity]
            if not free:
                raise RuntimeError('every shard of the mesh holds {} rows'.format(capacity))
            shard = min(free, key = lambda d: load[d])
            load[shard] += 1
            sid = next(seq)
            callbacks = {n: kwargs[n] for n in _CALLBACKS if kwargs.get(n) is not None}
            rest = {k: v for k, v in kwargs.items() if k not in callbacks}
            proxies.append({'_seq': sid, '_owner': shard, '_callbacks': callbacks,
                            'inputs': inputs})
            live[sid] = proxies[-1]
            payload.append((sid, shard, inputs, rest, tuple(callbacks)))
        try:
            results = call('start', payload)
        except Exception:
            for p in proxies:
                release(p)
            raise
        out = []
        for p in proxies:
            if results.get(p['_seq']) is not None:
                release(p)
                out.append(results[p['_seq']])
            else:
                out.append(p)
        return out

    def start_fn(inputs, ** kwargs):
        st = start_many([inputs], [kwargs])[0]
        if isinstance(st, Exception):
            raise st
        return st

    def batched_start(inputs_list, kwargs_list):
        states = start_many(inputs_list, kwargs_list)
        bad = [st for st in states if isinstance(st, Exception)]
        if bad:
            # the engine admits the burst one by one: each refusal fails alone
            discard_many([st for st in states if not isinstance(st, Exception)])
            raise bad[0]
        return states

    def release(p):
        if live.pop(p['_seq'], None) is not None:
            load[p['_owner']] -= 1

    def step_fn(states):
        done = call('step', [p['_seq'] for p in states])
        return states, [done[p['_seq']] for p in states]

    def finish_many(states):
        try:
            results = call('finish', [p['_seq'] for p in states])
        finally:
            for p in states:
                release(p)
        return [results[p['_seq']] for p in states]

    def finish_fn(st):
        return finish_many([st])[0]

    def discard_many(states):
        if states:
            try:
                call('discard', [p['_seq'] for p in states])
            finally:
                for p in states:
                    release(p)

    def follow():
        """The follower's loop: run the controller's operations until it
        closes the stepper; raises `MeshStepperError` when an operation
        fails on any rank."""
        if controller:
            raise RuntimeError('rank {} is the controller'.format(mesh.rank))
        while True:
            op, payload = collectives.broadcast_object(None, src, group)
            if op == 'stop':
                return
            run(op, payload)

    def close():
        """Release the followers (the controller; idempotent)."""
        if not controller:
            return
        with lock:
            if chan['closed'] or chan['error'] is not None:
                return
            chan['closed'] = True
            collectives.broadcast_object(('stop', None), src, group)

    start_fn.start_many = batched_start
    start_fn.batchable_kwargs = getattr(start_local, 'batchable_kwargs', ('on_audio',))
    if capacity is not None:
        # sticky rows: a request admitted ahead of a free slot could land
        # on a full shard
        start_fn.admit_ahead = 0
    finish_fn.finish_many = finish_many
    finish_fn.discard = lambda st: discard_many([st])
    finish_fn.async_ok = getattr(finish_local, 'async_ok', False)
    step_fn.follow = follow
    step_fn.close = close
    step_fn.controller = controller
    step_fn.local = local
    step_fn.stats = stats
    if hasattr(step_local, 'warm_thread'):
        step_fn.warm_thread = step_local.warm_thread
    if hasattr(step_local, 'fused'):
        step_fn.fused = step_local.fused
    return start_fn, step_fn, finish_fn


def make_tacotron_stepper(model, *, chunk = 64, token_multiple = 64,
                          max_steps = None, vocoder = None,
                          stream_audio = False, stream_context = 32,
                          stream_lookahead = None, mesh = None,
                          transfer_dtype = 'float32', use_fused_decoder = None,
                          ** infer_kwargs):
    """(start_fn, step_fn, finish_fn) driving a `Tacotron2` task model
    through `arch.decode_chunk`: per-request encode at admission, shared
    padded decode chunks, gate-based completion, postnet (+ optional
    vocoder) at finish.

    The decode route is chosen once, as `tts()` chooses it
    (`Tacotron2._use_fused_decoder`): on a card, and when
    ``arch.supports_fused_decoder`` holds for the token buckets (multiples
    of `token_multiple`), every chunk runs on the fused decoder kernel
    (`decoder_steps`, one launch of `chunk` steps for each group of at most
    8 rows, its dropout keyed by one seed drawn for the stepper and the
    absolute step); elsewhere on the plain loop.  ``use_fused_decoder``
    forces it (True outside the envelope raises; on CPU tensors the kernel
    route runs its plain version).  `infer_kwargs` go to `decode_chunk`
    (``deterministic``, ``generator``, ``speaker_embedding``).

    Rows pad to a common token bucket; a longer request admitted mid-flight
    re-buckets the running rows by zero-padding their memory and
    alignments, a finished longest request by slicing them (positions
    beyond a row's tokens carry zero attention under the masked softmax,
    so both are exact).

    ``stream_audio=True`` (requires ``vocoder``) emits AUDIO INCREMENTALLY:
    at every decode chunk boundary the newly completed mel frames are
    postnet-ed and vocoded with `stream_context` frames of left context
    (covering the postnet and vocoder receptive fields) and handed to the
    request's ``on_audio(chunk_ndarray)`` callback: time-to-first-audio is
    one encode + one decode chunk + one small vocode instead of the whole
    utterance.  Non-final emissions hold back `stream_lookahead` frames
    (default: the postnet half receptive field) so every emitted frame has
    full future context; the final flush emits the exact remainder.  The
    finished result carries ``audio`` (the concatenated stream) and
    ``first_audio_s`` (wall seconds from admission to first audio).

    A reduction factor r > 1 emits r frames per step: all frame
    bookkeeping (``steps``, emission windows) is in FRAMES, `max_steps` in
    decode steps.

    ``mesh`` (a `parallel.Mesh`; every rank calls this with the same
    arguments) serves across its data shards through `mesh_stepper`: the
    model and the vocoder move to the rank's device and take the first
    rank's weights, and each rank runs this stepper on its own rows (K3's
    row groups of at most 8 and the emissions' vocoder calls are each
    rank's)."""
    if mesh is not None:
        for m in (model, vocoder):
            if hasattr(m, 'to'):
                m.to(mesh.device)
        sync_weights(mesh, model, vocoder)
        return mesh_stepper(mesh, make_tacotron_stepper(
            model, chunk = chunk, token_multiple = token_multiple, max_steps = max_steps,
            vocoder = vocoder, stream_audio = stream_audio, stream_context = stream_context,
            stream_lookahead = stream_lookahead, transfer_dtype = transfer_dtype,
            use_fused_decoder = use_fused_decoder, ** infer_kwargs))
    arch = model.arch
    device = model.device
    n_mel = arch.hp.n_mel_channels
    r = arch.hp.n_frames_per_step
    limit = max_steps or arch.hp.max_decoder_steps
    threshold = arch.hp.gate_threshold
    if stream_audio and vocoder is None:
        raise ValueError('stream_audio requires a vocoder')
    if stream_lookahead is None:
        # postnet half receptive field: each emitted frame must have its
        # full future context before its audio is finalized
        stream_lookahead = arch.hp.postnet_n_conv * (arch.hp.postnet_kernel_size // 2)

    decode_kwargs = dict(infer_kwargs)
    # every token bucket is a multiple of token_multiple: the envelope is
    # decided once for all of them
    fused = model._use_fused_decoder(1, token_multiple, use_fused_decoder)
    if fused:
        deterministic = decode_kwargs.get('deterministic')
        if deterministic is None:
            deterministic = arch.hp.prenet_deterministic
        generator = decode_kwargs.pop('generator', None)
        seed = torch.zeros((1,), dtype = torch.int64)
        if not deterministic:
            seed = torch.randint(0, 2 ** 62, (1,), dtype = torch.int64, generator = generator,
                                 device = generator.device if generator is not None else 'cpu')
        decode_kwargs['seed'] = seed.to(device)

    def _decode(frame, cell, mem, pm, mask, off):
        # the packed decoder is looked up each chunk (cached per set of
        # weights), so that new weights reach a running stepper
        packed = dict(weights = model._decoder_weights(None)) if fused else {}
        return arch.decode_chunk(model.params, frame, cell, mem, pm, mask, n_steps = chunk,
                                 step_offset = off, ** decode_kwargs, ** packed)

    def _encode(tokens):
        tokens = torch.as_tensor(tokens, dtype = torch.long, device = device)
        enc_out, mask = arch.encode(model.params, model.state, tokens)
        memory, pm = arch.process_memory(model.params['decoder'], enc_out, mask)
        return memory, pm, mask

    # ALL finish/emission postnet calls go through the MASKED variant:
    # per-row lengths keep padded frames exactly zero between layers, so
    # any padded batch postnets as its unpadded runs (multi-layer SAME
    # convs are not pad-invariant otherwise)
    def _postnet_masked(dec, mask):
        dec = torch.as_tensor(dec, dtype = torch.float32, device = device)
        mask = torch.as_tensor(mask, device = device)
        return arch.postnet(model.params, model.state, dec, mask = mask)[0].cpu().numpy()

    # The ACTIVE BATCH lives on the device between chunks (frame, cell
    # state, memory/pm/mask stacks) and is restacked only on admission /
    # removal / re-bucket events: the steady-state chunk is ONE decode_chunk
    # call plus two small device → host reads (frames, gates).
    batch = {'ids': (), 's': 0, 'frame': None, 'cell': None,
             'mem': None, 'pm': None, 'mask': None,
             # monotone step offset: every chunk draws fresh dropout masks,
             # so no row re-draws one of an earlier chunk regardless of how
             # far along its batch-mates are
             'rng_off': 0}
    # per-request identity for the device-batch cache: id(st) is unsafe
    # (CPython reuses freed dict addresses, so a new request could inherit
    # a finished one's rows); a monotonic sequence number never is
    seq = itertools.count()

    def _admit_state(text, memory_row, pm_row, mask_row, on_audio):
        return {
            'text': text, '_seq': next(seq),
            'memory': memory_row, 'pm': pm_row, 'mask': mask_row,
            'frames': [], 'steps': 0,
            'on_audio': on_audio, 'emitted': 0, 'audio_parts': [],
            't_start': time.perf_counter(), 't_first_audio': None,
        }

    def start_fn(text, on_audio = None, ** kwargs):
        with torch.no_grad():
            memory, pm, mask = _encode(_encode_tokens(model, [text], token_multiple))
        return _admit_state(text, memory[0], pm[0], mask[0], on_audio)

    def start_many(texts, kwargs_list):
        """Batched admission: one encode per burst, the token rows padded to
        a pow2 bucket."""
        tokens = _encode_tokens(model, texts, token_multiple)
        with torch.no_grad():
            memory, pm, mask = _encode(_pad_rows_pow2(tokens))
        return [_admit_state(texts[i], memory[i], pm[i], mask[i],
                             kwargs_list[i].get('on_audio'))
                for i in range(len(texts))]

    start_fn.start_many = start_many

    def _postnet_mel(decoder_output):
        # window lengths bucket to ×chunk; the mask keeps padded frames
        # exactly zero between layers, so pad-then-slice is exact
        n = decoder_output.shape[0]
        b = -(-n // chunk) * chunk
        padded = np.pad(decoder_output, ((0, b - n), (0, 0)))
        mask = np.arange(b) < n
        post = _postnet_masked(padded[None], mask[None])
        return decoder_output + post[0, :n]

    def _emit_window(st, final):
        """The (state, lo, hi) emission job for this chunk, or None (not
        streaming / not enough new frames yet).  [lo, hi) is the mel window
        to vocode: left context covers the postnet/vocoder receptive
        fields; a lookahead margin is held back until it has future
        context."""
        if not stream_audio:
            return None
        hi = st['steps'] if final else st['steps'] - stream_lookahead
        if hi <= st['emitted'] or (not final and hi - st['emitted'] < chunk * r):
            return None
        return (st, max(0, st['emitted'] - stream_context), hi)

    def _emit_batch(jobs):
        """Vocode and hand out the completed mel frames of ALL emitting
        rows in ONE postnet + ONE vocoder call: rows pad to a shared ×chunk
        length bucket and a pow2 batch bucket (zero-pad + slice is exact
        for the SAME-padded conv stacks, and the buckets bound the shapes
        the vocoder's kernel launches at)."""
        if not jobs:
            return
        rate = getattr(vocoder, 'upsample_rate', 256)
        mels = [np.concatenate(st['frames'], axis = 0)[lo: hi] for st, lo, hi in jobs]
        b = -(-max(m.shape[0] for m in mels) // chunk) * chunk
        stack = [np.pad(m, ((0, b - m.shape[0]), (0, 0))) for m in mels]
        stack += stack[:1] * (_pow2(len(stack)) - len(stack))
        dec = np.stack(stack)
        # masked postnet: see _postnet_mel; mixed-length rows must not leak
        # pad energy into their valid tails
        mask = np.zeros((dec.shape[0], b), bool)
        for j, m in enumerate(mels):
            mask[j, :m.shape[0]] = True
        mel = dec + _postnet_masked(dec, mask)
        # frames beyond each job's real length must read as SILENCE for the
        # vocoder (its own padding is pad_mel_value, ~log-mel silence):
        # dec+post(0) there would bleed pad energy into the tail of the
        # emitted slice through the upsampler's receptive field
        pad_value = getattr(vocoder, 'pad_mel_value', -11.)
        for j, m in enumerate(mels):
            mel[j, m.shape[0]:] = pad_value
        mel[len(mels):] = pad_value
        audio = np.asarray(vocoder(mel))
        if audio.ndim == 1:
            audio = audio[None]
        now = time.perf_counter()
        for j, (st, lo, hi) in enumerate(jobs):
            part = audio[j, (st['emitted'] - lo) * rate: (hi - lo) * rate]
            st['audio_parts'].append(part)
            st['emitted'] = hi
            if st['t_first_audio'] is None:
                st['t_first_audio'] = now
            if st['on_audio'] is not None:
                try:
                    st['on_audio'](part)
                except Exception:
                    logger.exception('on_audio callback failed')

    def _pad_row(t, s):
        pad = s - t.shape[0]
        if pad == 0:
            return t
        return F.pad(t, (0, 0) * (t.ndim - 1) + (0, pad))

    def _extract_cell(cell, i, s_old, s_new):
        """One row of a stacked cell state, alignment maps re-bucketed.

        Growth zero-pads; shrink (the batch's longest request finished)
        slices: exact either way, because positions beyond a row's real
        tokens carry zero attention under the masked softmax."""
        row = _tree_map(lambda leaf: leaf[i], cell)
        if s_new == s_old:
            return row
        attn_rnn, dec_rnns, context, (prev, cum) = row
        fit = (lambda a: F.pad(a, (0, s_new - s_old))) if s_new > s_old \
            else (lambda a: a[:s_new])
        return (attn_rnn, dec_rnns, context, (fit(prev), fit(cum)))

    def _rebuild(states, s):
        """Restack the device batch (admission / removal / re-bucket):
        surviving rows carry their post-step frame/cell out of the old
        stack; new rows start from zeros.  Event-rate cost only.  The batch
        dim pads to a pow2 bucket (`_pow2`) with copies of row 0."""
        old = {sid: i for i, sid in enumerate(batch['ids'])}
        rows_f, rows_c = [], []
        for st in states:
            i = old.get(st['_seq'])
            if i is not None:
                rows_f.append(batch['frame'][i])
                rows_c.append(_extract_cell(batch['cell'], i, batch['s'], s))
            else:
                # the feedback frame carries the whole r-frame group
                rows_f.append(torch.zeros((n_mel * r,), device = device))
                one = arch.init_cell_state(1, s, device = device)
                rows_c.append(_tree_map(lambda leaf: leaf[0], one))
        n_pad = _bucket(len(states), 1) - len(states)
        rows_f += rows_f[:1] * n_pad
        rows_c += rows_c[:1] * n_pad
        stack = lambda rows: torch.stack([_pad_row(t, s) for t in rows]
                                         + [_pad_row(rows[0], s)] * n_pad)
        batch['frame'] = torch.stack(rows_f).float()
        batch['cell'] = _tree_map(lambda * rows: torch.stack(rows), * rows_c)
        batch['mem'] = stack([st['memory'] for st in states])
        batch['pm'] = stack([st['pm'] for st in states])
        batch['mask'] = stack([st['mask'] for st in states])
        batch['ids'] = tuple(st['_seq'] for st in states)
        batch['s'] = s

    def step_fn(states):
        s = max(int(st['memory'].shape[0]) for st in states)
        ids = tuple(st['_seq'] for st in states)
        with torch.no_grad():
            if ids != batch['ids'] or s != batch['s']:
                _rebuild(states, s)
            off = batch['rng_off']
            batch['rng_off'] += chunk
            frames, gates, (frame, cell) = _decode(
                batch['frame'], batch['cell'], batch['mem'], batch['pm'], batch['mask'], off)
        batch['frame'] = frame
        batch['cell'] = cell
        frames_h = frames.float().cpu().numpy()          # one bulk read per chunk
        gates_h = gates.float().cpu().numpy()

        new_states, done, jobs = [], [], []
        for i, st in enumerate(states):
            fired = np.nonzero(gates_h[i] > threshold)[0]
            keep = int(fired[0]) + 1 if fired.size else chunk
            # unfold the kept groups to frame rate ((keep, r*n_mel) →
            # (keep*r, n_mel)); whole groups are kept on gate fire,
            # matching infer()'s lengths = steps * r
            st['frames'].append(frames_h[i, :keep].reshape(-1, n_mel))
            st['steps'] += keep * r
            is_done = bool(fired.size) or st['steps'] >= limit * r
            if not is_done:
                job = _emit_window(st, final = False)
                if job is not None:
                    jobs.append(job)
            new_states.append(st)
            done.append(is_done)
        _emit_batch(jobs)
        return new_states, done

    def _result(st, mel):
        result = {'text': st['text'], 'mel': mel, 'steps': st['steps']}
        if stream_audio:
            result['audio'] = np.concatenate(st['audio_parts']) if st['audio_parts'] \
                else np.zeros((0,), np.float32)
            result['rate'] = model.rate
            if st['t_first_audio'] is not None:
                result['first_audio_s'] = st['t_first_audio'] - st['t_start']
        return result

    def finish_fn(st):
        mel = _postnet_mel(np.concatenate(st['frames'], axis = 0))
        if stream_audio:
            job = _emit_window(st, final = True)
            if job is not None:
                _emit_batch([job])
        result = _result(st, mel)
        if vocoder is not None and not stream_audio:
            audio = np.asarray(vocoder(mel))
            result['audio'] = audio[0] if audio.ndim == 2 else audio
            result['rate'] = model.rate
        return result

    def finish_many(states):
        """Batched finish for rows completing at the same chunk boundary:
        ONE padded postnet call + ONE batched vocoder call for the whole
        group."""
        if stream_audio:
            jobs = [j for j in (_emit_window(st, final = True) for st in states)
                    if j is not None]
            _emit_batch(jobs)
            return [_result(st, _postnet_mel(np.concatenate(st['frames'], axis = 0)))
                    for st in states]

        decs = [np.concatenate(st['frames'], axis = 0) for st in states]
        # the longest row's ×chunk bucket, rows to a pow2 bucket
        b = -(-max(len(d) for d in decs) // chunk) * chunk
        rows = _pow2(len(decs))
        padded = np.zeros((rows, b, decs[0].shape[-1]), decs[0].dtype)
        mask = np.zeros((rows, b), bool)
        for i, d in enumerate(decs):
            padded[i, :len(d)] = d
            mask[i, :len(d)] = True
        post = _postnet_masked(padded, mask)
        results = [_result(st, d + post[i, :len(d)])
                   for i, (st, d) in enumerate(zip(states, decs))]
        if vocoder is not None and hasattr(vocoder, 'vocode_windowed_batch'):
            # cross-request WINDOW batching: bounded window shapes whatever
            # the utterance lengths, windows of the JAX package's (the
            # decode ceiling, at most 256 frames)
            ceiling = (-(-limit // chunk) + 1) * chunk * r
            audios = vocoder.vocode_windowed_batch(
                [res['mel'] for res in results], win_len = min(ceiling, 256), hop_len = -64,
                transfer_dtype = transfer_dtype)
            for result, audio in zip(results, audios):
                result['audio'] = audio
                result['rate'] = model.rate
        elif vocoder is not None:
            for result in results:
                a = np.asarray(vocoder(result['mel']))
                result['audio'] = a[0] if a.ndim == 2 else a
                result['rate'] = model.rate
        return results

    finish_fn.finish_many = finish_many
    # the non-streaming finish reads only per-row state the loop no longer
    # touches (done rows leave the slots before finishing): safe to overlap
    # with the decode loop on the engine's finish worker.  Streaming
    # finishes share the emission path with step_fn's per-chunk
    # _emit_batch bookkeeping; keep those inline.
    finish_fn.async_ok = not stream_audio
    step_fn.warm_thread = lambda: warm_thread(device)
    step_fn.fused = fused
    step_fn._batch = batch      # introspection (tests read the device batch)
    return start_fn, step_fn, finish_fn


def make_vits_stepper(model, *, window = 64, context = 16,
                      token_multiple = 64, max_frames = None,
                      dtype = None, pipeline = True,
                      transfer_dtype = 'float32', mesh = None,
                      ** infer_kwargs):
    """(start_fn, step_fn, finish_fn) driving a `VITS` task model through
    WINDOWED waveform decode: incremental streaming for the end-to-end
    family.

    Admission runs the latent stage once (`arch.infer_latent`: text encode
    → durations → expanded prior → reverse flow), leaving a per-request
    latent buffer `z` (max_frames, C) on the device.  Every engine chunk
    then decodes ONE `window` of frames for the whole active batch through
    the HiFi-GAN generator (`arch.decode_frames`) with `context` real frames
    of left/right overlap: the generator is fully convolutional, so
    windows with context ≥ its receptive field are exact, and the
    concatenated stream equals the one-shot decode.  First audio = one
    latent stage + one window decode instead of the whole utterance, and
    new requests are admitted at every window boundary.  `infer_kwargs` go
    to `infer_latent` (``noise_scale``, ``noise_scale_w``, ``d_control``,
    ``min_duration``, the speaker); a request's ``generator`` keyword (a
    `torch.Generator`) draws its noise.

    ``pipeline=True`` (default) software-pipelines the chunk loop: chunk
    k's decode is queued on the device's stream, then chunk k−1's audio,
    whose copy to pinned host memory was queued right behind it with an
    event, is read, so the host drains k−1 while the device computes k.
    Delivery of a chunk's audio (``audio_parts`` / ``on_audio``) lags one
    chunk behind its compute; freshly admitted streaming requests bypass
    the lag so time-to-first-audio is unchanged, and ``finish_fn`` flushes
    the tail, so the concatenated stream is the same either way.

    ``transfer_dtype='int16'`` quantizes each chunk to 16-bit PCM ON THE
    DEVICE before the device → host copy (2x fewer bytes than float32;
    delivered parts are reconstructed float32, max abs error 1/32767, the
    quantization a WAV container applies anyway).

    ``mesh`` (a `parallel.Mesh`) serves across its data shards through
    `mesh_stepper`, each rank decoding its own rows' windows (the model on
    the rank's device, with the first rank's weights); a request's noise is
    drawn on its owner's rank."""
    if mesh is not None:
        model.to(mesh.device)
        sync_weights(mesh, model)
        return mesh_stepper(mesh, make_vits_stepper(
            model, window = window, context = context, token_multiple = token_multiple,
            max_frames = max_frames, dtype = dtype, pipeline = pipeline,
            transfer_dtype = transfer_dtype, ** infer_kwargs))
    arch = model.arch
    device = model.device
    rate = arch.upsample_rate
    max_frames = max_frames or arch.hp.max_frames
    quantize = np.dtype(transfer_dtype) == np.int16
    span = window + 2 * context
    if max_frames < span:
        raise ValueError('max_frames ({}) < window + 2*context ({})'.format(max_frames, span))
    on_card = device.type == 'cuda'
    span_idx = torch.arange(span, device = device)
    out_idx = torch.arange(window * rate, device = device)

    def _latent(tokens, generator):
        with torch.no_grad():
            return arch.infer_latent(
                model._cast_params(dtype),
                torch.as_tensor(tokens, dtype = torch.long, device = device),
                max_frames = max_frames, dtype = dtype, generator = generator, ** infer_kwargs)

    def _decode(z_stack, starts_offs, cond_stack):
        """The window of each row (its start, its emitted slice's offset in
        `starts_offs` (2, B)) decoded, and the emitted slice gathered on the
        device: the copy to the host carries window*rate samples, not the
        span's."""
        with torch.no_grad():
            idx = (starts_offs[0][:, None] + span_idx)[..., None].expand(-1, -1, z_stack.shape[-1])
            win = torch.gather(z_stack, 1, idx)
            audio = arch.decode_frames(model._cast_params(dtype), win, cond_stack,
                                       dtype = dtype).float()
            out = torch.gather(audio, 1, starts_offs[1][:, None] * rate + out_idx)
            if quantize:
                out = torch.round(torch.clamp(out, -1., 1.) * 32767.).to(torch.int16)
        return out

    def _start_fetch(audio):
        """Queue the device → host copy of a chunk's audio: into pinned
        memory with an event on a card (no wait here), the tensor itself on
        the CPU."""
        if not on_card:
            return audio, None
        host = torch.empty(audio.shape, dtype = audio.dtype, pin_memory = True)
        host.copy_(audio, non_blocking = True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # the active batch's stacked latents live on the device between chunks;
    # restacked only when the active set changes (admission/removal)
    batch = {'ids': (), 'z': None, 'cond': None}
    # one in-flight chunk awaiting its read (pipeline mode): 'audio' is the
    # (host buffer, event) of its queued copy, 'deliveries' the
    # (state, row, frame_offset, frame_count) tuples it maps to
    pending = {'audio': None, 'deliveries': ()}

    def _deliver(st, part):
        st['audio_parts'].append(part)
        if st['t_first_audio'] is None:
            st['t_first_audio'] = time.perf_counter()
        if st['on_audio'] is not None:
            try:
                st['on_audio'](part)
            except Exception:
                logger.exception('on_audio callback failed')

    def _fetch_parts(fetch, deliveries):
        host, event = fetch
        if event is not None:
            event.synchronize()
        audio_h = host.numpy()
        for st, row, off, count in deliveries:
            part = audio_h[row, off * rate: (off + count) * rate]
            if quantize:
                part = part.astype(np.float32) / 32767.
            _deliver(st, part)

    def _flush():
        if pending['audio'] is None:
            return
        fetch, deliveries = pending['audio'], pending['deliveries']
        pending['audio'], pending['deliveries'] = None, ()
        _fetch_parts(fetch, deliveries)

    # monotonic per-request identity (id(st) is unsafe: CPython reuses
    # freed dict addresses, so a new request could inherit a finished one's
    # cached device rows)
    seq = itertools.count()

    def _make_state(text, z_row, cond_row, length, on_audio):
        return {
            'text': text, '_seq': next(seq),
            'z': z_row, 'cond': cond_row,
            'length': max(1, int(length)),
            'emitted': 0, 'audio_parts': [], 'on_audio': on_audio,
            't_start': time.perf_counter(), 't_first_audio': None,
        }

    def start_fn(text, on_audio = None, generator = None, ** kwargs):
        z, cond, lengths, _, _ = _latent(_encode_tokens(model, [text], token_multiple),
                                         generator)
        return _make_state(text, z[0], None if cond is None else cond[0],
                           lengths.cpu().numpy()[0], on_audio)

    def start_many(texts, kwargs_list, generator = None):
        """Batched admission: ONE latent stage + ONE bulk lengths read for a
        whole admission burst, the token rows padded to a pow2 bucket."""
        tokens = _encode_tokens(model, texts, token_multiple)
        z, cond, lengths, _, _ = _latent(_pad_rows_pow2(tokens), generator)
        lengths = lengths.cpu().numpy()
        return [_make_state(texts[i], z[i], None if cond is None else cond[i], lengths[i],
                            kwargs_list[i].get('on_audio'))
                for i in range(len(texts))]

    start_fn.start_many = start_many

    def step_fn(states):
        ids = tuple(st['_seq'] for st in states)
        if pending['deliveries']:
            # rows aborted since the chunk was parked must NOT be delivered
            # (the engine already resolved them with an error); requests
            # that finished normally were flushed by their finish_fn
            kept = tuple(d for d in pending['deliveries'] if d[0]['_seq'] in set(ids))
            if not kept:
                pending['audio'], pending['deliveries'] = None, ()
            else:
                pending['deliveries'] = kept
        if ids != batch['ids']:
            # batch dim pads to a pow2 bucket with copies of row 0
            rows = [st['z'] for st in states]
            rows += rows[:1] * (_bucket(len(rows), 1) - len(rows))
            batch['z'] = torch.stack(rows)
            conds = [st['cond'] for st in states]
            if conds[0] is None:
                batch['cond'] = None
            else:
                conds += conds[:1] * (batch['z'].shape[0] - len(conds))
                batch['cond'] = torch.stack(conds)
            batch['ids'] = ids

        starts, dev, offs, counts = [], [], [], []
        for st in states:
            e = st['emitted']
            s0 = min(max(e - context, 0), max_frames - span)
            starts.append(s0)
            # device-gather start within the span; its window*rate slice
            # must stay in bounds, so clamp to span-window: the residual
            # (only ever nonzero for the clamped tail of a max_frames-long
            # request) becomes the host-side delivery offset
            dev.append(min(e - s0, span - window))
            offs.append((e - s0) - dev[-1])
            counts.append(max(1, min(window, st['length'] - e)))
        n_pad = batch['z'].shape[0] - len(starts)
        starts_offs = torch.tensor([starts + starts[:1] * n_pad, dev + dev[:1] * n_pad],
                                   dtype = torch.long).to(device, non_blocking = True)
        # the eager (synchronous) read exists to keep time-to-first-audio at
        # one window: only STREAMING rows care, so one-shot load keeps the
        # pipeline parked
        fresh = any(st['emitted'] == 0 and st['on_audio'] is not None for st in states)
        fetch = _start_fetch(_decode(batch['z'], starts_offs, batch['cond']))
        # the new chunk is now queued; reading the PREVIOUS one here
        # overlaps its host work with this chunk's compute
        _flush()

        done = []
        for i, st in enumerate(states):
            st['emitted'] += counts[i]
            done.append(st['emitted'] >= st['length'])
        deliveries = tuple((st, i, offs[i], counts[i]) for i, st in enumerate(states))
        if pipeline and not fresh:
            pending['audio'] = fetch
            pending['deliveries'] = deliveries
        else:
            _fetch_parts(fetch, deliveries)
        return states, done

    # where the finish wall goes: tail-chunk flush (a read that waits for
    # everything queued ahead of it) vs pure host assembly
    stepper_stats = {'flush_s': 0., 'flushes': 0, 'assemble_s': 0.}

    def _assemble(st):
        t0 = time.perf_counter()
        audio = np.concatenate(st['audio_parts']) if st['audio_parts'] \
            else np.zeros((0,), np.float32)
        result = {'text': st['text'], 'audio': audio[: st['length'] * rate],
                  'rate': model.rate, 'frames': st['length']}
        if st['t_first_audio'] is not None:
            result['first_audio_s'] = st['t_first_audio'] - st['t_start']
        stepper_stats['assemble_s'] += time.perf_counter() - t0
        return result

    def _flush_for(states):
        if any(any(d[0] is st for d in pending['deliveries']) for st in states):
            t0 = time.perf_counter()
            _flush()                       # the tail chunk is still pending
            stepper_stats['flush_s'] += time.perf_counter() - t0
            stepper_stats['flushes'] += 1

    def finish_fn(st):
        _flush_for([st])
        return _assemble(st)

    def finish_many(states):
        """Group finish: ONE tail flush for the whole completing group,
        then pure host assembly."""
        _flush_for(states)
        return [_assemble(st) for st in states]

    finish_fn.finish_many = finish_many
    step_fn.warm_thread = lambda: warm_thread(device)
    step_fn._batch = batch      # introspection
    step_fn.stats = stepper_stats
    return start_fn, step_fn, finish_fn


def make_tts_batch_fn(model, *, vocoder = None, ** infer_kwargs):
    """batch_fn for a `Tacotron2` task model: encodes the texts, pads into
    one token batch, runs ONE `compiled_infer` decode, optionally vocodes,
    and splits per-request outputs."""

    def batch_fn(texts):
        encoded = [model.encode_text(t) for t in texts]
        tokens = pad_batch(encoded, pad_value = model.blank_token_idx)
        outputs = model.compiled_infer(tokens, ** infer_kwargs)
        lengths = outputs.lengths.cpu().numpy()
        mels = outputs.mel.cpu().numpy()
        results = []
        for i in range(len(texts)):
            mel = mels[i, :max(1, int(lengths[i]))]
            result = {'text': texts[i], 'mel': mel}
            if vocoder is not None:
                audio = np.asarray(vocoder(mel, ** infer_kwargs))
                result['audio'] = audio[0] if audio.ndim == 2 else audio
                result['rate'] = model.rate
            results.append(result)
        return results

    return batch_fn
