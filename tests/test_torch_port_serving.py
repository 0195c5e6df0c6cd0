"""Serving with continuous batching: the port's `runtimes.serving` and
`native.scheduler` against the JAX package's, on the CPU.

  - the request scheduler, native (the port's own copy of
    ``serving_native.cpp``) and its Python twin: one submission script gives
    the JAX scheduler's ids, order, aborts and counters, and each semantic
    case of the JAX package's tests holds;
  - both engines with fake start / step / finish functions, the cases of the
    JAX package's ``tests/test_serving.py``;
  - `Tacotron2.decode_chunk`: the plain route within 1e-5 of the JAX
    package's over two chunks with a carried state, and the fused decoder's
    route (on CPU tensors `decoder_steps` runs its plain version) within
    1e-5 of the plain route at B = 1, 4 and 16 (two row groups of 8);
  - the Tacotron-2 stepper: each request's mel equal, within 1e-4, to the
    JAX stepper's on the same schedule and to the one-shot `infer`, with
    three token buckets, one request admitted mid-flight (the bucket grows)
    and the longest finishing first (it shrinks), at r = 1 on both decode
    routes and at r = 2; the batched finish equal to the single one;
    `ServingEngine` over `make_tts_batch_fn` against the JAX batch_fn;
  - the stream through the engine (the fused route, a tiny WaveGlow with
    ``sigma=0``): the parts concatenate to ``audio``, exactly ``steps ×
    rate`` samples, the tail within 1e-3 of the offline vocode, and the
    emitter hands the vocoder mel silence past each row's frames;
  - the VITS stepper: the stream equal to one-shot `decode_frames` of the
    request's latent within 1e-6 (float32 convolutions blocked differently
    over a window and over the whole buffer; not to the bit on the CPU),
    pipelined or not, with ``transfer_dtype='int16'`` within 1/32767 of it,
    and batched admission equal to single.

The models are the JAX package's tiny ones (``tests/test_serving.py``), the
Tacotron-2 with a location kernel of 31 so that it is inside the fused
decoder's envelope; the JAX task model is saved and the port loads it by
name (`weights.tacotron2_from_jax`).  The gate is biased off (threshold
1.1), so every request runs to ``max_steps``, and the prenet is
deterministic: both packages draw different dropout.
"""

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax.numpy as jnp
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import Tacotron2 as JaxTacotron2
from text_to_speech_tpu.native.scheduler import RequestScheduler as JaxScheduler
from text_to_speech_tpu.runtimes.serving import make_tacotron_stepper as jax_tacotron_stepper
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.tts import VITS, WaveGlow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.native.scheduler import RequestScheduler, available
from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
from text_to_speech_tpu_torch.runtimes.serving import (
    ContinuousServingEngine, ServingEngine, _bucket, make_tacotron_stepper, make_tts_batch_fn,
    make_vits_stepper)

TACOTRON = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
                prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
                lsa_attention_kernel_size = 31, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                max_decoder_steps = 16)
WAVEGLOW = dict(n_flows = 2, wn_layers = 2, wn_channels = 16, upsample_width = 64,
                upsample_stride = 16, sigma = 0.)
VITS_HP = dict(inter_channels = 8, hidden_channels = 16, filter_channels = 32, n_heads = 2,
               n_text_layers = 1, posterior_layers = 2, flow_layers = 2, flow_wn_layers = 2,
               duration_filters = 16, upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
               upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
               resblock_dilation_sizes = ((1, 2),), max_frames = 64, max_position = 512)
#: three token buckets at token_multiple 8 (32, 8 and 16 tokens)
TEXTS = ['hello world this is a long one', 'test', 'third one']
TIMEOUT = 60.
#: windowed against one-shot `decode_frames`: the same float32 sums, but the
#: CPU's convolutions block a window of 40 frames and a buffer of 64 frames
#: differently, so the stream sits up to ~2e-7 from the one-shot decode
EXACT = 1e-6


# -- the request scheduler ---------------------------------------------------------

def _kinds():
    return ['native', 'python']


@pytest.fixture(params = _kinds())
def sched(request):
    if request.param == 'native' and not available():
        pytest.skip('no compiler for the native scheduler')
    s = RequestScheduler(force_python = request.param == 'python')
    assert s.native == (request.param == 'native')
    yield s
    s.close()


def _script(sched):
    """One submission script: ids, aborts, order, max_out, the empty wait
    and the counters (the timings differ from run to run)."""
    out = [[sched.submit(p) for p in (0, 5, 5, 1, 0, 2)]]
    ids = out[0]
    out.append(sched.abort(ids[3]))                 # queued: True
    out.append(sched.pending())
    out.append(sched.collect(3, 0.1, 0.))
    out.append(sched.abort(ids[1]))                 # collected: False
    out.append(sched.collect_nowait(8))
    out.append(sched.collect(4, 0.02, 0.))          # nothing left
    for rid in out[3]:
        sched.complete(rid)
    sched.complete(12345)                           # never collected: ignored
    stats = sched.stats
    out.append({k: stats[k] for k in RequestScheduler.STATS})
    return out


@pytest.mark.parametrize('kind', _kinds())
def test_scheduler_script_matches_jax(kind):
    if kind == 'native' and not available():
        pytest.skip('no compiler for the native scheduler')
    port = RequestScheduler(force_python = kind == 'python')
    ref = JaxScheduler(force_python = kind == 'python')
    assert port.native == ref.native == (kind == 'native')
    try:
        got, want = _script(port), _script(ref)
    finally:
        port.close()
        ref.close()
    assert got == want
    assert got[3] == [1, 2, 5] and got[5] == [0, 4]


class TestRequestScheduler:
    def test_fifo_within_priority(self, sched):
        ids = [sched.submit() for _ in range(4)]
        assert sched.collect(8, first_timeout = 0.1, batch_wait = 0.) == ids

    def test_priority_order(self, sched):
        a = sched.submit(priority = 0)
        b = sched.submit(priority = 5)
        c = sched.submit(priority = 5)
        d = sched.submit(priority = 1)
        assert sched.collect(8, 0.1, 0.) == [b, c, d, a]

    def test_collect_respects_max_out(self, sched):
        ids = [sched.submit() for _ in range(5)]
        assert sched.collect(2, 0.1, 0.) == ids[:2]
        assert sched.pending() == 3
        assert sched.collect_nowait(8) == ids[2:]

    def test_collect_times_out_empty(self, sched):
        t0 = time.perf_counter()
        assert sched.collect(4, first_timeout = 0.05, batch_wait = 0.) == []
        assert time.perf_counter() - t0 >= 0.04

    def test_batch_window_gathers_late_arrivals(self, sched):
        first = sched.submit()
        late = []

        def arrive_late():
            time.sleep(0.05)
            late.append(sched.submit())

        t = threading.Thread(target = arrive_late)
        t.start()
        got = sched.collect(2, first_timeout = 0.5, batch_wait = 0.5)
        t.join(timeout = 5)
        assert got == [first] + late     # window held open for the 2nd

    def test_abort_queued_only(self, sched):
        a = sched.submit()
        b = sched.submit()
        assert sched.abort(a) is True
        assert sched.collect(8, 0.1, 0.) == [b]
        assert sched.abort(b) is False   # already collected
        stats = sched.stats
        assert stats['aborted'] == 1 and stats['collected'] == 1

    def test_latency_stats(self, sched):
        a = sched.submit()
        time.sleep(0.01)
        assert sched.collect(1, 0.1, 0.) == [a]
        sched.complete(a)
        stats = sched.stats
        assert stats['completed'] == 1
        assert stats['mean_queue_wait_s'] >= 0.008
        assert stats['mean_latency_s'] >= stats['mean_queue_wait_s']

    def test_wake_unblocks_collect(self, sched):
        out = []
        t = threading.Thread(target = lambda: out.append(
            sched.collect(1, first_timeout = 5., batch_wait = 0.)))
        t.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        sched.wake()
        t.join(timeout = 2.)
        assert not t.is_alive(), 'wake() must unblock a pending collect'
        assert time.perf_counter() - t0 < 1., 'collect returned via timeout'
        assert out == [[]]


def test_engines_use_the_native_scheduler():
    """Both engines serve on the C++ core by default, on its twin when
    asked; `native_scheduler` says which."""
    if not available():
        pytest.skip('no compiler for the native scheduler')
    assert ServingEngine(lambda items: items).native_scheduler
    assert ContinuousServingEngine(lambda x: x, lambda s: (s, [True] * len(s))).native_scheduler
    assert not ServingEngine(lambda items: items, native_scheduler = False).native_scheduler


# -- the engines, with fake model functions ---------------------------------------------

class TestServingEngine:
    def test_batching_and_results(self):
        seen_batches = []

        def batch_fn(items):
            seen_batches.append(len(items))
            return [i * 10 for i in items]

        with ServingEngine(batch_fn, max_batch_size = 4, max_wait_ms = 50) as engine:
            requests = [engine.submit(i) for i in range(6)]
            results = [r.result.get(timeout = TIMEOUT) for r in requests]
        assert results == [0, 10, 20, 30, 40, 50]
        assert engine.stats['requests'] == 6
        assert max(seen_batches) > 1          # dynamic batching happened

    def test_streaming_callback(self):
        streamed = []
        done = threading.Event()

        def callback(out, rid):
            streamed.append((rid, out))
            if len(streamed) == 2:
                done.set()

        with ServingEngine(lambda items: [i + 1 for i in items], max_wait_ms = 5) as engine:
            engine.submit(1, callback = callback)
            engine.submit(2, callback = callback)
            assert done.wait(timeout = TIMEOUT)
        assert sorted(o for _, o in streamed) == [2, 3]

    def test_abort(self):
        def slow_batch(items):
            time.sleep(0.2)
            return items

        engine = ServingEngine(slow_batch, max_wait_ms = 1)
        request = engine.submit('x')
        request.abort()
        engine.start()
        try:
            with pytest.raises(RuntimeError):
                request.result.get(timeout = 5)
        finally:
            engine.stop()

    def test_error_isolated(self):
        def failing(items):
            raise RuntimeError('device exploded')

        with ServingEngine(failing, max_wait_ms = 1) as engine:
            req = engine.submit(1)
            with pytest.raises(RuntimeError):
                req.result.get(timeout = 5)

    def test_high_priority_jumps_queue(self):
        order = []

        def batch_fn(items):
            order.extend(items)
            return items

        engine = ServingEngine(batch_fn, max_batch_size = 2, max_wait_ms = 30.)
        # submitted before start, so the queue orders them without a race
        engine.submit('low-1', priority = 0)
        engine.submit('low-2', priority = 0)
        engine.submit('high', priority = 9)
        with engine:
            engine.submit('low-3', priority = 0).result.get(timeout = TIMEOUT)
        assert order[0] == 'high'
        assert engine.scheduler_stats['completed'] >= 4

    def test_enqueue_race_resolved(self):
        """A collected id whose payload registration is slightly delayed
        still resolves (the submit → register window)."""
        engine = ServingEngine(lambda items: items, max_batch_size = 4, max_wait_ms = 1.)
        orig_submit = engine._sched.submit

        def slow_submit(priority = 0):
            rid = orig_submit(priority)
            time.sleep(0.05)        # widen the submit->register window
            return rid

        engine._sched.submit = slow_submit
        with engine:
            assert engine.submit('payload').result.get(timeout = TIMEOUT) == 'payload'

    def test_complete_covers_failures(self):
        """Failed batches still stamp completion (no in-flight leak)."""
        def failing(items):
            raise ValueError('boom')

        engine = ServingEngine(failing, max_batch_size = 2, max_wait_ms = 1.)
        with engine:
            req = engine.submit('x')
            with pytest.raises(ValueError):
                req.result.get(timeout = TIMEOUT)
        stats = engine.scheduler_stats
        assert stats['completed'] == stats['collected'] == 1

    def test_live_batches_pad_to_pow2(self):
        seen = []

        def batch_fn(items):
            seen.append(len(items))
            return [i * 10 for i in items]

        with ServingEngine(batch_fn, max_batch_size = 8, max_wait_ms = 100) as engine:
            requests = [engine.submit(i) for i in range(3)]
            results = [r.result.get(timeout = TIMEOUT) for r in requests]
        assert sorted(results) == [0, 10, 20]
        assert all(b & (b - 1) == 0 for b in seen), seen

    def test_warmup_runs_pow2_buckets(self):
        seen = []

        def batch_fn(items):
            seen.append(len(items))
            return list(items)

        engine = ServingEngine(batch_fn, max_batch_size = 8)
        assert engine.warmup('x') >= 0.
        assert seen == [1, 2, 4, 8]
        with engine:
            with pytest.raises(RuntimeError):
                engine.warmup('x')


def _countdown(n):
    return {'remaining': n, 'n': n}


def _step_down(states, pause = 0.):
    if pause:
        time.sleep(pause)
    out = [dict(st, remaining = st['remaining'] - 1) for st in states]
    return out, [st['remaining'] <= 0 for st in out]


class TestContinuousServingEngine:
    def test_mid_decode_request_completes_first(self):
        two_chunks_done = threading.Event()
        order = []

        def step_fn(states):
            out, done = _step_down(states, 0.01)
            if any(st['n'] - st['remaining'] >= 2 for st in out):
                two_chunks_done.set()
            return out, done

        with ContinuousServingEngine(_countdown, step_fn, lambda st: st['n']) as engine:
            slow = engine.submit(50, callback = lambda o, r: order.append('slow'))
            assert two_chunks_done.wait(timeout = TIMEOUT)
            fast = engine.submit(3, callback = lambda o, r: order.append('fast'))
            assert fast.result.get(timeout = TIMEOUT) == 3
            assert slow.result.get(timeout = TIMEOUT) == 50
        assert order == ['fast', 'slow']
        assert len(engine.stats['latencies']) == 2

    def test_async_finish_overlaps_and_drains(self):
        finish_started = threading.Event()
        stepped_during_finish = threading.Event()

        def step_fn(states):
            if finish_started.is_set():
                stepped_during_finish.set()
            return _step_down(states, 0.005)

        def finish_fn(st):
            finish_started.set()
            time.sleep(0.2)                 # slow finish (postnet + vocode)
            return st['n']
        finish_fn.async_ok = True

        with ContinuousServingEngine(_countdown, step_fn, finish_fn,
                                     max_batch_size = 4) as engine:
            assert engine._finish_pool is not None
            fast = engine.submit(2)
            slow = engine.submit(30)
            assert fast.result.get(timeout = TIMEOUT) == 2
            assert stepped_during_finish.wait(timeout = TIMEOUT)
            assert slow.result.get(timeout = TIMEOUT) == 30
        assert engine._finish_pool is None  # stop() drained and closed it
        assert len(engine.stats['latencies']) == 2

    def test_warm_thread_runs_on_every_engine_thread(self):
        """`step_fn.warm_thread` runs once on the loop thread and on each
        worker before `start` returns (a new thread's first CUDA calls are
        paid there, not by the first request)."""
        names = []

        def step_fn(states):
            return _step_down(states)
        step_fn.warm_thread = lambda: names.append(threading.current_thread().name)

        def finish_fn(st):
            return st['n']
        finish_fn.async_ok = True

        engine = ContinuousServingEngine(_countdown, step_fn, finish_fn, name = 'warm')
        with engine:
            assert sorted(n.split('_')[0] for n in names) == ['warm', 'warm-admit',
                                                              'warm-finish']
            assert engine.infer(2, timeout = TIMEOUT) == 2
        assert len(names) == 3

        def failing():
            raise RuntimeError('no device')
        step_fn.warm_thread = failing
        engine = ContinuousServingEngine(_countdown, step_fn, finish_fn)
        with pytest.raises(RuntimeError, match = 'no device'):
            engine.start()
        assert not engine._thread.is_alive()

    def test_concurrent_submits_count_and_resolve(self):
        """More submitting threads than cores, the switch interval shortened:
        every request resolves once and none is lost from the counters."""
        n_threads, per_thread = 2 * (os.cpu_count() or 4), 20
        handles = []
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ContinuousServingEngine(_countdown, _step_down, lambda st: st['n'],
                                         max_batch_size = 4) as engine:
                threads = [threading.Thread(target = lambda: handles.extend(
                    engine.submit(1) for _ in range(per_thread))) for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout = TIMEOUT)
                assert not any(t.is_alive() for t in threads)
                assert [h.result.get(timeout = TIMEOUT) for h in handles] == \
                    [1] * (n_threads * per_thread)
        finally:
            sys.setswitchinterval(interval)
        assert engine.stats['requests'] == n_threads * per_thread
        assert engine.scheduler_stats['completed'] == n_threads * per_thread

    def test_completion_events_recorded(self):
        def finish_fn(st):
            return {'audio': np.zeros(100 * st['n'], np.float32)}

        with ContinuousServingEngine(_countdown, _step_down, finish_fn) as engine:
            for h in [engine.submit(n) for n in (1, 2, 3)]:
                h.result.get(timeout = TIMEOUT)
        events = sorted(engine.stats['completions'])
        assert [s for _, s in events] == [100, 200, 300]
        ts = [t for t, _ in events]
        assert all(b >= a for a, b in zip(ts, ts[1:]))

    def test_batched_admission_uses_start_many(self):
        calls = {'many': [], 'single': 0}
        gate = threading.Event()

        def start_fn(n, special = None, on_audio = None):
            calls['single'] += 1
            return _countdown(n)

        def start_many(inputs, kwargs_list):
            calls['many'].append(len(inputs))
            return [_countdown(n) for n in inputs]
        start_fn.start_many = start_many

        def step_fn(states):
            gate.wait(timeout = 5)      # hold chunk 1 until all submitted
            return _step_down(states)

        engine = ContinuousServingEngine(start_fn, step_fn, lambda st: st['n'],
                                         max_batch_size = 8)
        # the whole burst is queued BEFORE the loop starts, so the first
        # collect sees all of it
        reqs = [engine.submit(2) for _ in range(4)]
        special = engine.submit(2, special = 'x')       # non-batchable
        with engine:
            gate.set()
            assert [r.result.get(timeout = TIMEOUT) for r in reqs] == [2] * 4
            assert special.result.get(timeout = TIMEOUT) == 2
        assert sum(calls['many']) == 4 and all(n > 1 for n in calls['many'])
        assert calls['single'] == 1             # only the special one

    def test_batched_finish_uses_finish_many(self):
        calls = {'many': [], 'single': 0}

        def finish_fn(st):
            calls['single'] += 1
            return st['n']

        def finish_many(states):
            calls['many'].append(len(states))
            return [st['n'] for st in states]
        finish_fn.finish_many = finish_many

        engine = ContinuousServingEngine(_countdown, _step_down, finish_fn)
        reqs = [engine.submit(2) for _ in range(3)]     # all finish together
        with engine:
            assert [r.result.get(timeout = TIMEOUT) for r in reqs] == [2] * 3
        assert calls == {'many': [3], 'single': 0}

        # a short return falls back to per-request finishes, nothing lost
        calls['many'], calls['single'] = [], 0
        finish_fn.finish_many = lambda states: [st['n'] for st in states[:-1]]
        engine = ContinuousServingEngine(_countdown, _step_down, finish_fn)
        reqs = [engine.submit(2) for _ in range(3)]
        with engine:
            assert [r.result.get(timeout = TIMEOUT) for r in reqs] == [2] * 3
        assert calls['single'] == 3

    @pytest.mark.parametrize('start_many', ['short', 'raises'])
    def test_start_many_failure_falls_back(self, start_many):
        """start_many returning fewer states than requests, or raising, must
        not lose the burst: every request re-admits one by one."""
        def start_fn(n, on_audio = None):
            return _countdown(n)
        start_fn.start_many = (lambda inputs, kw: [_countdown(n) for n in inputs[:-1]]) \
            if start_many == 'short' else (lambda inputs, kw: 1 / 0)

        engine = ContinuousServingEngine(start_fn, lambda s: _step_down(s, 0.02),
                                         lambda st: st['n'])
        reqs = [engine.submit(2) for _ in range(3)]
        with engine:
            assert [r.result.get(timeout = TIMEOUT) for r in reqs] == [2] * 3

    @pytest.mark.parametrize('async_admission', [True, False])
    def test_async_admission_overlaps_stepping(self, async_admission):
        stepped_during_admit = threading.Event()
        admitting = threading.Event()

        def start_fn(n):
            if n == 99:                     # the second (slow) admission
                admitting.set()
                time.sleep(0.3)
            return {'remaining': 5 if n == 99 else n, 'n': n}

        def step_fn(states):
            if admitting.is_set():
                stepped_during_admit.set()
            return _step_down(states, 0.02)

        with ContinuousServingEngine(start_fn, step_fn, lambda st: st['n'],
                                     async_admission = async_admission) as engine:
            slow = engine.submit(30)
            time.sleep(0.1)                 # the batch is mid-decode
            fast = engine.submit(99)
            assert fast.result.get(timeout = TIMEOUT) == 99
            assert slow.result.get(timeout = TIMEOUT) == 30
        if async_admission:
            assert stepped_during_admit.is_set()

    def test_admission_prefetch_beyond_batch(self):
        started = []
        proceed = threading.Semaphore(0)    # each release = one chunk runs

        def start_fn(x):
            started.append(x)
            return {'x': x, 'left': 3}

        def step_fn(states):
            assert proceed.acquire(timeout = 10)
            out = [dict(st, left = st['left'] - 1) for st in states]
            return out, [st['left'] <= 0 for st in out]

        def wait_started(n):
            deadline = time.time() + 5
            while len(started) < n and time.time() < deadline:
                time.sleep(0.01)
            return len(started)

        engine = ContinuousServingEngine(start_fn, step_fn, lambda st: st['x'],
                                         max_batch_size = 2, admit_ahead = 3)
        rs = [engine.submit(i) for i in range(6)]   # queued before start
        with engine:
            assert wait_started(2) == 2     # one burst (capped) fills the slots
            proceed.release()
            assert wait_started(4) == 4     # a prefetch burst beyond the batch
            proceed.release()
            assert wait_started(5) == 5     # max_batch + admit_ahead
            assert len(started) == 5
            for _ in range(12):
                proceed.release()
            outs = [r.result.get(timeout = TIMEOUT) for r in rs]
        assert sorted(outs) == list(range(6)) and sorted(started) == list(range(6))

    def test_admission_burst_capped_at_max_batch(self):
        bursts = []

        def start_fn(x):
            return {'x': x}

        def start_many(items, kwargs_list):
            bursts.append(len(items))
            return [{'x': x} for x in items]

        start_fn.start_many = start_many
        start_fn.batchable_kwargs = ()

        def step_fn(states):
            time.sleep(0.005)
            return states, [True] * len(states)

        engine = ContinuousServingEngine(start_fn, step_fn, lambda st: st['x'],
                                         max_batch_size = 4, admit_ahead = 8)
        rs = [engine.submit(i) for i in range(24)]
        with engine:
            outs = [r.result.get(timeout = TIMEOUT) for r in rs]
        assert sorted(outs) == list(range(24))
        assert bursts and max(bursts) <= 4

    def test_admit_ahead_zero_keeps_old_semantics(self):
        started, gate = [], threading.Event()

        def start_fn(x):
            started.append(x)
            return {'x': x}

        def step_fn(states):
            gate.wait(timeout = 10)
            return states, [True] * len(states)

        engine = ContinuousServingEngine(start_fn, step_fn, lambda st: st['x'],
                                         max_batch_size = 2, admit_ahead = 0)
        rs = [engine.submit(i) for i in range(5)]
        with engine:
            time.sleep(0.3)                 # loop parked inside chunk 1
            assert len(started) <= 2
            gate.set()
            outs = [r.result.get(timeout = TIMEOUT) for r in rs]
        assert sorted(outs) == list(range(5))

    def test_batch_slot_reuse_and_abort(self):
        def step_fn(states):
            time.sleep(0.005)
            return states, [True] * len(states)

        with ContinuousServingEngine(lambda x: x, step_fn, max_batch_size = 2) as engine:
            results = [engine.submit(i) for i in range(5)]
            aborted = engine.submit(99)
            aborted.abort()
            assert [r.result.get(timeout = TIMEOUT) for r in results] == [0, 1, 2, 3, 4]
            with pytest.raises(RuntimeError):
                aborted.result.get(timeout = TIMEOUT)

    def test_all_aborted_boundary_skips_step(self):
        in_flight = threading.Event()
        min_rows = [99]

        def step_fn(states):
            min_rows[0] = min(min_rows[0], len(states))
            max(len(st) for st in states)     # fails on an empty batch
            in_flight.set()
            time.sleep(0.01)
            out = [dict(st, n = st['n'] - 1) for st in states]
            return out, [st['n'] <= 0 for st in out]

        with ContinuousServingEngine(lambda n: {'n': n}, step_fn,
                                     lambda st: 'done') as engine:
            a, b = engine.submit(50), engine.submit(50)
            assert in_flight.wait(timeout = TIMEOUT)
            a.abort()
            b.abort()
            for req in (a, b):
                with pytest.raises(RuntimeError):
                    req.result.get(timeout = TIMEOUT)
            assert engine.submit(2).result.get(timeout = TIMEOUT) == 'done'
        assert min_rows[0] >= 1

    def test_warmup_runs_buckets_to_completion(self):
        step_batches, finished = [], []

        def step_fn(states):
            step_batches.append(len(states))
            return _step_down(states)

        def finish_fn(st):
            finished.append(st['remaining'])
            return st

        engine = ContinuousServingEngine(_countdown, step_fn, finish_fn, max_batch_size = 4)
        engine.warmup(3)
        assert sorted(set(step_batches)) == [1, 2, 4]
        assert len(finished) == 1 + 2 + 4 and all(r == 0 for r in finished)
        with engine:
            with pytest.raises(RuntimeError):
                engine.warmup(1)
        assert engine.stats['requests'] == 0


def test_bucket_helper():
    for n in range(1, 20):
        for n_data in (1, 2, 3, 4, 6, 8):
            b = _bucket(n, n_data)
            assert b >= n and b % n_data == 0
    assert [_bucket(n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 8, 16]


# -- the models --------------------------------------------------------------------------

def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    """{'r1': (JAX task model, port), 'r2': ..., 'vocoder': port WaveGlow,
    'vits': port VITS}: the JAX Tacotron-2 task models saved, the port's
    loaded by name; the gates biased off."""
    root = str(tmp_path_factory.mktemp('models'))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        for key, extra in (('r1', {}), ('r2', dict(n_frames_per_step = 2,
                                                   lsa_attention_kernel_size = 5))):
            jax_model = JaxTacotron2(lang = 'en', name = 'serving_' + key,
                                     ** dict(TACOTRON, ** extra))
            jax_model.save()
            model = get_pretrained('serving_' + key, root = root, device = 'cpu')
            jax_model.arch.hp.gate_threshold = model.arch.hp.gate_threshold = 1.1
            out[key] = (jax_model, model)
        arch = WaveGlowArch(** WAVEGLOW)
        out['vocoder'] = WaveGlow.from_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0),
                                           name = 'serving_wg', device = 'cpu', root = root,
                                           ** WAVEGLOW)
        mel_fn = TacotronSTFT(sampling_rate = 8000, hop_length = 8, filter_length = 16,
                              win_length = 16)
        out['vits'] = VITS.create('en', name = 'serving_vits', mel_fn = mel_fn, root = root,
                                  device = 'cpu', ** VITS_HP)
        yield out
        reset_instances()


def _encoded(model, jax_model, B, S):
    """The same seeded tokens through both encoders → (port memory, pm,
    mask), (JAX memory, pm, mask)."""
    tokens = np.random.default_rng(B).integers(1, 30, (B, S))
    tokens[:, S // 2 + 1:] = 0
    tokens[0, S - 2:] = 5           # one row fills the bucket
    with torch.no_grad():
        enc, mask = model.arch.encode(model.params, model.state, torch.as_tensor(tokens))
        mem, pm = model.arch.process_memory(model.params['decoder'], enc, mask)
    jenc, jmask, _ = jax_model.arch.encode(jax_model.params, jax_model.state,
                                           jnp.asarray(tokens), train = False)
    jmem, jpm = jax_model.arch.process_memory(jax_model.params['decoder'], jenc, jmask)
    return (mem, pm, mask), (jmem, jpm, jmask)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [np.asarray(tree)]


def _two_chunks(arch, params, encoded, ** kw):
    """Two chunks of 5 steps from a zero carry (the second from the
    first's) → (frames, gates, carry leaves)."""
    mem, pm, mask = encoded
    B, S = mask.shape
    carry = (torch.zeros((B, 80)), arch.init_cell_state(B, S))
    frames, gates = [], []
    with torch.no_grad():
        for off in (0, 5):
            f, g, carry = arch.decode_chunk(params, * carry, mem, pm, mask, n_steps = 5,
                                            deterministic = True, step_offset = off, ** kw)
            frames.append(f)
            gates.append(g)
    return torch.cat(frames, 1).numpy(), torch.cat(gates, 1).numpy(), _leaves(carry)


def test_decode_chunk_matches_jax(models):
    jax_model, model = models['r1']
    (ported, ref) = _encoded(model, jax_model, 3, 16)
    frames, gates, carry = _two_chunks(model.arch, model.params, ported)
    jmem, jpm, jmask = ref
    arch = jax_model.arch
    jcarry = (jnp.zeros((3, 80)), arch.init_cell_state(3, 16))
    jframes, jgates = [], []
    for off in (0, 5):
        f, g, jcarry = arch.decode_chunk(jax_model.params, * jcarry, jmem, jpm, jmask,
                                         n_steps = 5, deterministic = True, step_offset = off)
        jframes.append(np.asarray(f))
        jgates.append(np.asarray(g))
    assert frames.shape == (3, 10, 80) and gates.shape == (3, 10)
    np.testing.assert_allclose(frames, np.concatenate(jframes, 1), atol = 1e-5, rtol = 0)
    np.testing.assert_allclose(gates, np.concatenate(jgates, 1), atol = 1e-5, rtol = 0)
    for leaf, jleaf in zip(carry, _leaves(jcarry)):
        np.testing.assert_allclose(leaf, np.asarray(jleaf), atol = 1e-5, rtol = 0)


@pytest.mark.parametrize('B', [1, 4, 16])
def test_decode_chunk_fused_route_matches_plain(models, B):
    """The fused route (its plain version on CPU tensors): B = 16 runs as
    two row groups of 8 on slices of one state."""
    _, model = models['r1']
    encoded, _ = _encoded(model, models['r1'][0], B, 16)
    plain = _two_chunks(model.arch, model.params, encoded)
    fused = _two_chunks(model.arch, model.params, encoded,
                        weights = model._decoder_weights(None))
    for a, b in zip((plain[0], plain[1], * plain[2]), (fused[0], fused[1], * fused[2])):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol = 1e-5, rtol = 0)


def test_decode_chunk_fused_route_refuses_outside_envelope(models):
    _, model = models['r2']
    encoded, _ = _encoded(model, models['r2'][0], 2, 16)
    weights = models['r1'][1]._decoder_weights(None)
    with pytest.raises(ValueError, match = 'fused decoder'):
        _two_chunks(model.arch, model.params, encoded, weights = weights)
    with pytest.raises(ValueError, match = 'envelope'):
        make_tacotron_stepper(model, use_fused_decoder = True)
    with pytest.raises(NotImplementedError, match = 'queue 4'):
        make_tacotron_stepper(model, mesh = object())


def _drive(start_fn, step_fn, finish_fn):
    """The schedule of the stepper tests: requests 0 and 1 admitted
    together, a chunk, request 2 admitted mid-flight (its bucket between
    theirs), then chunks until each finishes (request 0, the longest
    bucket, first: the batch re-buckets down) → outputs by request."""
    states = {0: start_fn(TEXTS[0]), 1: start_fn(TEXTS[1])}
    outs = {}
    admitted = False
    while len(outs) < 3:
        live = sorted(states)
        new, done = step_fn([states[i] for i in live])
        for i, st, d in zip(live, new, done):
            states[i] = st
            if d:
                outs[i] = finish_fn(states.pop(i))
        if not admitted:
            states[2] = start_fn(TEXTS[2])
            admitted = True
    return [outs[i] for i in range(3)]


def _one_shot(model, text, n_frames):
    tokens = np.asarray(model.encode_text(text))[None, :]
    s = -(-tokens.shape[1] // 8) * 8
    tokens = np.pad(tokens, ((0, 0), (0, s - tokens.shape[1])),
                    constant_values = model.blank_token_idx)
    with torch.no_grad():
        out = model.arch.infer(model.params, model.state, torch.as_tensor(tokens),
                               deterministic = True, early_stopping = False,
                               max_length = n_frames)
    return out.mel[0].numpy()


@pytest.mark.parametrize('case', ['r1_plain', 'r1_fused', 'r2_plain'])
def test_tacotron_stepper_matches_jax_and_one_shot(models, case):
    key, route = case.split('_')
    jax_model, model = models[key]
    r = model.arch.hp.n_frames_per_step
    chunk, max_steps = (4, 12) if r == 1 else (3, 6)
    kw = dict(chunk = chunk, token_multiple = 8, max_steps = max_steps, deterministic = True)
    stepper = make_tacotron_stepper(model, use_fused_decoder = route == 'fused', ** kw)
    assert stepper[1].fused == (route == 'fused')
    outs = _drive(* stepper)
    refs = _drive(* jax_tacotron_stepper(jax_model, ** kw))
    for text, out, ref in zip(TEXTS, outs, refs):
        assert out['steps'] == ref['steps'] == max_steps * r
        assert out['mel'].shape == (max_steps * r, 80)
        np.testing.assert_allclose(out['mel'], np.asarray(ref['mel']), atol = 1e-4, rtol = 0)
        np.testing.assert_allclose(out['mel'], _one_shot(model, text, max_steps * r),
                                   atol = 1e-4, rtol = 0)
    # the bucket grew with request 0 (32 tokens) and shrank after it
    assert stepper[1]._batch['s'] == 16


def test_tts_batch_fn_matches_jax(models):
    """`ServingEngine` over `make_tts_batch_fn`: three requests queued
    before the start form one batch (padded to 4 rows); each mel equals the
    JAX package's batch_fn on the same texts."""
    from text_to_speech_tpu.runtimes.serving import make_tts_batch_fn as jax_batch_fn
    jax_model, model = models['r1']
    kw = dict(deterministic = True, max_length = 16, padding_multiple = 8)
    refs = jax_batch_fn(jax_model, ** kw)(TEXTS)
    seen = []
    batch_fn = make_tts_batch_fn(model, ** kw)
    engine = ServingEngine(lambda texts: seen.append(len(texts)) or batch_fn(texts),
                           max_batch_size = 4, max_wait_ms = 50)
    requests = [engine.submit(text) for text in TEXTS]
    with engine:
        outs = [r.result.get(timeout = TIMEOUT) for r in requests]
    assert seen == [4]
    for out, ref in zip(outs, refs):
        assert out['text'] == ref['text'] and out['mel'].shape == (16, 80)
        np.testing.assert_allclose(out['mel'], np.asarray(ref['mel']), atol = 1e-4, rtol = 0)


def test_finish_many_matches_single(models):
    _, model = models['r1']
    start_fn, step_fn, finish_fn = make_tacotron_stepper(
        model, chunk = 4, token_multiple = 8, max_steps = 8, deterministic = True,
        vocoder = models['vocoder'])
    states = [start_fn(t) for t in TEXTS]
    done = [False]
    while not all(done):
        states, done = step_fn(states)
    batched = finish_fn.finish_many(copy.deepcopy(states))
    singles = [finish_fn(st) for st in states]
    for b, s in zip(batched, singles):
        assert b['steps'] == s['steps'] == 8 and b['rate'] == s['rate'] == model.rate
        np.testing.assert_allclose(b['mel'], s['mel'], atol = 1e-5, rtol = 0)
        assert b['audio'].shape == s['audio'].shape == (8 * 16,)


def test_streamed_audio_through_the_engine(models):
    """`stream_audio=True` on the fused route: parts arrive at chunk
    boundaries, concatenate to the result, cover ``steps × rate`` samples,
    and the last part's tail equals the offline vocode; the emitter hands
    the vocoder mel silence past each row's frames."""
    _, model = models['r1']
    vocoder = models['vocoder']
    mels = []

    class Recording:
        pad_mel_value = vocoder.pad_mel_value
        upsample_rate = vocoder.upsample_rate

        def __call__(self, mel, ** kwargs):
            mels.append(np.asarray(mel))
            return vocoder(mel, ** kwargs)

    stepper = make_tacotron_stepper(
        model, chunk = 4, token_multiple = 8, max_steps = 12, deterministic = True,
        vocoder = Recording(), stream_audio = True, stream_context = 4, stream_lookahead = 1,
        use_fused_decoder = True)
    chunks = [[], []]
    engine = ContinuousServingEngine(* stepper, max_batch_size = 4)
    # both queued before the loop starts: admitted together, they emit together
    reqs = [engine.submit(text, on_audio = parts.append)
            for text, parts in zip(TEXTS[:2], chunks)]
    try:
        engine.start()
        outs = [req.result.get(timeout = TIMEOUT) for req in reqs]
    finally:
        engine.stop()
    rate = vocoder.upsample_rate
    for out, parts in zip(outs, chunks):
        assert out['steps'] == 12 and len(parts) >= 2 and out['first_audio_s'] > 0.
        np.testing.assert_array_equal(np.concatenate(parts), out['audio'])
        assert out['audio'].shape == (12 * rate,)
        offline = vocoder(out['mel'])[0]
        np.testing.assert_allclose(parts[-1][-rate:], offline[11 * rate: 12 * rate],
                                   atol = 1e-3, rtol = 0)
    assert engine.stats['chunks'] >= 3
    batched = [m for m in mels if m.shape[0] > 1]
    assert batched, 'two streams share an emission call'
    silent_rows = 0
    for mel in batched:
        for row in np.all(mel == vocoder.pad_mel_value, axis = -1):
            if row.any():               # the silence is a tail, never a hole
                silent_rows += 1
                assert row[int(np.argmax(row)):].all()
    assert silent_rows > 0


# -- the VITS stepper ---------------------------------------------------------------------

def _drain(step_fn, finish_fn, states):
    outs = [None] * len(states)
    while any(o is None for o in outs):
        idx = [i for i, o in enumerate(outs) if o is None]
        live, done = step_fn([states[i] for i in idx])
        for j, i in enumerate(idx):
            states[i] = live[j]
            if done[j]:
                outs[i] = finish_fn(live[j])
    return outs


@pytest.mark.parametrize('mode', ['pipelined', 'eager', 'int16'])
def test_vits_stream_equals_one_shot_decode(models, mode):
    """Three requests (pads to the 4-row bucket): each stream equals
    `decode_frames` of its own latent buffer in one call within `EXACT`
    (the generator is fully convolutional and the context covers its
    receptive field); int16 transfer within 1/32767; batched admission
    equal to single."""
    model = models['vits']
    kw = dict(window = 16, context = 12, token_multiple = 8, max_frames = 64,
              min_duration = 3, noise_scale = 0., noise_scale_w = 0.,
              pipeline = mode != 'eager',
              transfer_dtype = 'int16' if mode == 'int16' else 'float32')
    start_fn, step_fn, finish_fn = make_vits_stepper(model, ** kw)
    texts = ['first stream', 'the second longer stream here', 'third']
    parts = [[] for _ in texts]
    states = [start_fn(t, on_audio = p.append) for t, p in zip(texts, parts)]
    latents = [st['z'] for st in states]
    outs = _drain(step_fn, finish_fn, states)
    rate = model.arch.upsample_rate
    for z, out, p in zip(latents, outs, parts):
        with torch.no_grad():
            full = model.arch.decode_frames(model.params, z[None])[0].numpy()
        full = full[: out['frames'] * rate]
        assert out['frames'] >= 16 and out['audio'].shape == full.shape
        np.testing.assert_array_equal(np.concatenate(p)[: len(full)], out['audio'])
        if mode == 'int16':
            err = np.abs(out['audio'] - np.clip(full, -1., 1.)).max()
            assert err <= 1. / 32767.
        else:
            np.testing.assert_allclose(out['audio'], full, atol = EXACT, rtol = 0)
    batched = _drain(step_fn, finish_fn, start_fn.start_many(texts, [{}] * len(texts)))
    for b, s in zip(batched, outs):
        assert b['frames'] == s['frames']
        # int16: a float difference of EXACT can move a sample by one step
        np.testing.assert_allclose(b['audio'], s['audio'], rtol = 0, atol = EXACT + (
            1. / 32767. if mode == 'int16' else 0.))
