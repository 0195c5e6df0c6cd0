"""The port's measurement layer: `loggers` (levels, formatters, handlers,
the span tree, the profiler trace) and the memory and configuration
functions of `devices`, against the JAX package's tests of the same surface
(``tests/test_utils.py`` `TestTimers`, `TestLoggerStyleAPI`,
`TestFormatterRobustness`; ``tests/test_periphery2.py`` `TestHandlers`;
``tests/test_serving.py`` `TestDevices`), and the span tree of a tiny
`tts()` against the JAX package's.

The tiny `tts()` runs one model on both sides: Tacotron-2 ``overfit_demo``
and a 4-flow WaveGlow with the same random weights, deterministic, on the
CPU.  The span names and their nesting must be equal.  Two things differ by
design and are normalised before comparing: the JAX package times `predict`
twice (its Tacotron-2 override and its base class's, one inside the other),
and runs `infer` on its `Stream`'s producer thread, so that thread's spans
hang under the main thread's innermost span; the port runs `infer` in the
caller's thread.  Counts are not compared: after a failed one-launch gate
the JAX package also tries the pipelined decode before its retries, the
port goes to its retries directly.
"""

import io
import json
import logging
import shutil
import threading

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch import devices, loggers
from text_to_speech_tpu_torch.loggers import (
    Timer, add_handler, add_level, get_formatter, get_level, reset_timers, set_style,
    timer, timer_report)
from text_to_speech_tpu_torch.loggers.handlers import BufferingHandler, TTSHandler

VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)


@pytest.fixture(autouse = True)
def fresh_timers():
    reset_timers()
    yield
    reset_timers()


# -- mirrored from the JAX package's tests --------------------------------------------

def test_span_tree():
    @timer(name = 'outer')
    def outer():
        with Timer('inner'):
            pass

    outer()
    outer()
    report = timer_report()
    assert 'outer' in report and 'inner' in report
    lines = report.splitlines()
    assert lines[0] == 'Timers (thread {}):'.format(threading.current_thread().name)
    assert lines[1].startswith('- outer : ') and lines[1].endswith('(2 execs)')
    assert lines[2].startswith('  - inner : ') and lines[2].endswith('(2 execs)')
    assert outer.timer_name == 'outer'


def test_each_thread_has_its_own_tree():
    def work():
        with Timer('in thread'):
            pass

    with Timer('main'):
        thread = threading.Thread(target = work, name = 'worker-1')
        thread.start()
        thread.join(timeout = 10)
    assert not thread.is_alive()
    report = timer_report()
    assert 'Timers (thread worker-1):\n- in thread' in report
    assert '- main' in report and '  - in thread' not in report


def test_add_level_and_method():
    add_level(9, 'trace9')
    assert get_level('trace9') == 9 and get_level('time') == loggers.TIME_LEVEL
    lg = logging.getLogger('port-style-test')
    lg.setLevel(9)
    assert hasattr(lg, 'trace9')
    lg.trace9('works')
    with pytest.raises(ValueError):
        get_level('no-such-level')


def test_get_formatter_styles():
    f = get_formatter('extended')
    rec = logging.LogRecord('n', logging.INFO, 'p', 1, 'msg', (), None)
    assert 'INFO' in f.format(rec) and 'msg' in f.format(rec)
    f2 = get_formatter('%(levelname)s|%(message)s')
    assert f2.format(rec) == 'INFO|msg'
    spec = {'style': '{'}
    assert isinstance(get_formatter(spec), logging.Formatter) and spec == {'style': '{'}
    assert get_formatter('{message} 50%').format(rec) == 'msg 50%'


def test_set_style_and_handlers(tmp_path):
    buf = io.StringIO()
    lg = logging.getLogger('port-style-target')
    lg.handlers.clear()
    h = add_handler('stream', logger = 'port-style-target', stream = buf)
    set_style('basic', 'port-style-target')
    lg.warning('only-message')
    assert buf.getvalue().strip() == 'only-message'
    lg.removeHandler(h)
    path = str(tmp_path / 'log.txt')
    fh = add_handler('file', logger = 'port-style-target', filename = path, level = 'dev')
    lg.warning('to the file')
    lg.removeHandler(fh)
    fh.close()
    assert fh.level == loggers.DEV_LEVEL and 'to the file' in open(path).read()
    with pytest.raises(ValueError):
        add_handler('carrier-pigeon')


def test_buffering_handler():
    logger = logging.getLogger('port_test_buf')
    handler = BufferingHandler(capacity = 2)
    logger.addHandler(handler)
    for word in ('hello', 'big', 'world'):
        logger.warning('%s %s', word, 'there')
    logger.removeHandler(handler)
    assert handler.records == ['big there', 'world there']


def test_timer_logs_at_time_debug(caplog):
    with caplog.at_level(loggers.TIME_DEBUG_LEVEL, logger = 'text_to_speech_tpu_torch'):
        with Timer('logged span'):
            pass
    assert any('logged span took' in r.message and r.levelno == loggers.TIME_DEBUG_LEVEL
               for r in caplog.records)


def test_tts_handler_goes_to_handle_error(monkeypatch):
    """A handler whose model cannot load (here: by name, with no GPU and no
    device given) hands the record to `handleError`, and it does not
    re-enter; `tts(..., play=True)` itself raises the load's error."""
    errors = []
    handler = loggers.try_tts_handler(model = 'overfit_demo')
    assert isinstance(handler, TTSHandler)
    monkeypatch.setattr(handler, 'handleError', errors.append)
    record = logging.LogRecord('n', logging.WARNING, 'p', 1, 'say this', (), None)
    handler.emit(record)
    assert errors == [record] and not handler._busy
    from text_to_speech_tpu_torch import tts
    with pytest.raises(RuntimeError, match = 'device'):
        tts('hello', model = 'overfit_demo', play = True)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = loggers.start_profiler_trace(str(tmp_path / 'trace'))
    with pytest.raises(RuntimeError):
        loggers.start_profiler_trace(str(tmp_path / 'other'))
    torch.ones(8) @ torch.ones(8)
    path = loggers.stop_profiler_trace()
    with open(path) as f:
        trace = json.load(f)
    assert path.startswith(log_dir) and trace['traceEvents']
    with pytest.raises(RuntimeError):
        loggers.stop_profiler_trace()


def test_device_listing():
    assert len(devices.list_devices('cpu')) >= 1
    assert devices.default_backend() in ('cpu', 'gpu')
    assert devices.get_memory_stats(devices.list_devices('cpu')[0]) == {}
    assert devices.list_devices('gpu') == [torch.device('cuda', i)
                                           for i in range(torch.cuda.device_count())]
    with pytest.raises(ValueError):
        devices.list_devices('tpu')


def test_device_config_refuses_xla_keywords_and_maps_precision():
    from text_to_speech_tpu_torch.train.precision import get_global_policy, set_global_policy
    for name in ('host_device_count', 'preallocate'):
        with pytest.raises(ValueError, match = name):
            devices.set_device_config(** {name: 8 if name == 'host_device_count' else False})
    precision, policy = torch.get_float32_matmul_precision(), get_global_policy()
    try:
        devices.set_device_config(precision = 'tensorfloat32')
        assert torch.get_float32_matmul_precision() == 'high'
        devices.set_default_precision('bfloat16')
        assert torch.get_float32_matmul_precision() == 'medium'
        devices.set_default_precision('mixed_float16')
        assert get_global_policy().name == 'mixed_bfloat16'
        devices.set_default_precision('float32')
        assert torch.get_float32_matmul_precision() == 'highest'
        assert get_global_policy().name == 'float32'
        with pytest.raises(ValueError):
            devices.set_default_precision('float8')
        assert devices.set_device_config(default_device = 'cpu') == devices.list_devices()
        assert torch.empty(1).device == torch.device('cpu')
    finally:
        torch.set_float32_matmul_precision(precision)
        set_global_policy(policy)
        torch.set_default_device(None)


def test_print_memory_usage(capsys):
    devices.print_memory_usage()
    out = capsys.readouterr().out
    assert out.strip() and 'GiB' in out


# -- the span tree of a tiny tts() ---------------------------------------------------

def _paths(roots, main):
    """Span paths from the root, thread names dropped; a span directly inside
    one of its own name is merged into it, and every other thread's spans
    hang under the innermost span of the thread `main`."""
    def walk(span, prefix, out):
        path = prefix if prefix and prefix[-1] == span.name else prefix + (span.name,)
        out.add(path)
        for child in span.children.values():
            walk(child, path, out)
        return out

    paths = set()
    for span in roots[main].children.values():
        walk(span, (), paths)
    innermost = max(paths, key = len)
    for name, root in roots.items():
        if name != main:
            for span in root.children.values():
                walk(span, innermost, paths)
    return paths


@pytest.fixture(scope = 'module')
def tiny_models(tmp_path_factory):
    """(JAX tts, port tts): the same Tacotron-2 and WaveGlow on both sides."""
    import jax.numpy as jnp
    from text_to_speech_tpu.models import saving
    from text_to_speech_tpu.models.interfaces import reset_instances
    from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow, tts as jax_tts
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import init_waveglow
    from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch

    root = str(tmp_path_factory.mktemp('models'))
    shutil.copytree('pretrained_models/overfit_demo', root + '/overfit_demo')
    arch = WaveGlowArch(** VOCODER)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    to_jax = lambda t: {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                        for k, v in t.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        jax_vocoder = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        jax_vocoder.set_weights({k: to_jax(v) if isinstance(v, dict) else v
                                 for k, v in params.items()})
        model = Tacotron2.from_pretrained('overfit_demo', root = root, device = 'cpu')
        vocoder = WaveGlow.from_jax(params, device = 'cpu', ** VOCODER)
        yield (lambda text, ** kw: jax_tts(text, model = 'overfit_demo', vocoder = jax_vocoder,
                                           save = False, display = False, ** kw),
               lambda text, ** kw: tts(text, model = model, vocoder = vocoder, save = False,
                                       display = False, ** kw))
        reset_instances()


RUNS = {
    # one sentence: the one-launch path
    'one_sentence': ('Hello world!', dict(min_fpt_ratio = -1., max_fpt_ratio = float('inf'))),
    # the frames-per-token gate fails: retries, then the vocoder on each chunk
    'retries': ('Hello world!', dict(min_fpt_ratio = 100., max_fpt_ratio = float('inf'),
                                     max_trial = 2)),
    # two texts in one batch: the pipelined decode and vocode
    'batch': (['Hello world!', 'They sleep all day.'],
              dict(batch_size = 2, min_fpt_ratio = -1., max_fpt_ratio = float('inf'))),
}


@pytest.mark.parametrize('run', list(RUNS))
def test_tts_span_tree_matches_jax(tiny_models, run):
    from text_to_speech_tpu import loggers as jax_loggers
    jax_tts, port_tts = tiny_models
    text, kwargs = RUNS[run]
    kwargs = dict(kwargs, deterministic = True, max_length = 3.,
                  vocoder_config = {'deterministic': True})
    main = threading.current_thread().name
    jax_loggers.reset_timers()
    jax_tts(text, ** kwargs)
    expected = _paths(jax_loggers.ROOT_TIMER._roots, main)
    jax_loggers.reset_timers()
    out = port_tts(text, ** kwargs)
    assert all(np.isfinite(o['audio']).all() for o in out)
    assert _paths(loggers.ROOT_TIMER._roots, main) == expected
    assert ('predict', 'inference', 'processing') in expected or run == 'batch'
