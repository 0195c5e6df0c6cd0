"""The HTTP front-end of the port (`runtimes.http_server`) and `serve()`, on
the CPU, over real sockets on an ephemeral port.

  - the WAV helpers give the JAX package's bytes (`wav_header`, `pcm16`,
    `encode_wav`);
  - every case of the JAX package's ``tests/test_http_server.py`` against a
    controllable fake engine: health and stats, one-shot and streamed
    (chunked) WAV, 400 / 404, abort of a queued request and of an unknown
    one, the keep-alive connection after a 404 with a body, the ``stream``
    query parsed (not matched as a substring), a failed stream truncated
    without an inline 500, the one-shot timeout and a client's disconnect
    aborting the engine request;
  - a real tiny VITS behind `ContinuousServingEngine` + `make_vits_stepper`,
    one-shot and streamed, and `serve(block=False)` on it and on a tiny
    Tacotron-2 + WaveGlow (``sigma=0``): the streamed body equal to the
    one-shot one for the same text (the decode is deterministic), and the
    served engine on the native scheduler.

Every blocking call carries a timeout, and every server stops in a
``finally`` (or its fixture's exit).
"""

import http.client
import json
import struct
import threading
import time

import numpy as np
import pytest

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.runtimes import http_server as jax_http
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.tts import Tacotron2, VITS, WaveGlow, serve
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.native.scheduler import available
from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
from text_to_speech_tpu_torch.runtimes.http_server import (
    TTSServer, encode_wav, pcm16, wav_header)
from text_to_speech_tpu_torch.runtimes.serving import ContinuousServingEngine, make_vits_stepper
from text_to_speech_tpu_torch.utils.stream import AsyncResult

TIMEOUT = 60.
VITS_HP = dict(inter_channels = 8, hidden_channels = 16, filter_channels = 32, n_heads = 2,
               n_text_layers = 1, posterior_layers = 2, flow_layers = 2, flow_wn_layers = 2,
               duration_filters = 16, upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
               upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
               resblock_dilation_sizes = ((1, 2),), max_frames = 64, max_position = 512)
TACOTRON = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
                prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
                lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                max_decoder_steps = 16)
WAVEGLOW = dict(n_flows = 2, wn_layers = 2, wn_channels = 16, upsample_width = 64,
                upsample_stride = 16, sigma = 0.)


# -- wav encoding --------------------------------------------------------------------

def parse_wav(data):
    assert data[:4] == b'RIFF' and data[8:12] == b'WAVE'
    assert data[12:16] == b'fmt '
    _, fmt, channels, rate, _, _, bits = struct.unpack('<IHHIIHH', data[16:36])
    assert data[36:40] == b'data'
    (size,) = struct.unpack('<I', data[40:44])
    pcm = np.frombuffer(data[44:], '<i2')
    return rate, bits, channels, size, pcm


def test_wav_helpers_match_jax():
    audio = np.sin(np.linspace(0, 40, 801)).astype(np.float32) * 1.3
    assert encode_wav(audio, 8000) == jax_http.encode_wav(audio, 8000)
    assert pcm16(audio) == jax_http.pcm16(audio)
    for n in (None, 0, 12345):
        assert wav_header(22050, n) == jax_http.wav_header(22050, n)


def test_encode_wav_roundtrip():
    audio = np.sin(np.linspace(0, 40, 800)).astype(np.float32) * 0.5
    rate, bits, channels, size, pcm = parse_wav(encode_wav(audio, 8000))
    assert (rate, bits, channels) == (8000, 16, 1)
    assert size == 2 * len(audio) and len(pcm) == len(audio)
    assert np.allclose(pcm / 32767., audio, atol = 2e-4)


def test_streaming_header_has_unknown_length():
    header = wav_header(22050)
    assert len(header) == 44
    (size,) = struct.unpack('<I', header[40:44])
    assert size > 2 ** 31          # "read to EOF" sentinel


def test_pcm16_clips():
    out = np.frombuffer(pcm16(np.asarray([2., -2., 0.])), '<i2')
    assert list(out) == [32767, -32767, 0]


# -- fake-engine semantics -------------------------------------------------------------

class FakeRequest:
    _next = iter(range(10 ** 6))

    def __init__(self, inputs, kwargs):
        self.inputs, self.kwargs = inputs, kwargs
        self.request_id = 'fake-{}'.format(next(self._next))
        self.result = AsyncResult()
        self.aborted = threading.Event()

    def abort(self):
        self.aborted.set()
        self.result.set_exception(RuntimeError('aborted'))


class FakeEngine:
    """Completes requests only when .release() is called."""

    def __init__(self):
        self.pending = []
        self.stats = {'requests': 0}

    def submit(self, inputs, ** kwargs):
        request = FakeRequest(inputs, kwargs)
        self.stats['requests'] += 1
        self.last_kwargs = kwargs
        self.pending.append(request)
        return request

    def release(self, audio = None):
        request = self.pending.pop(0)
        on_audio = request.kwargs.get('on_audio')
        audio = np.zeros(64, np.float32) if audio is None else audio
        if on_audio is not None:
            on_audio(audio[:32])
            on_audio(audio[32:])
        request.result.set_result({'audio': audio, 'rate': 8000})


def _connect(server, timeout = TIMEOUT):
    host, port = server._httpd.server_address[:2]
    return http.client.HTTPConnection(host, port, timeout = timeout)


@pytest.fixture
def fake_server():
    engine = FakeEngine()
    server = TTSServer(engine, rate = 8000, port = 0, timeout = 20.)
    with server:
        conn = _connect(server, 20)
        try:
            yield engine, server, conn
        finally:
            conn.close()


def _post(conn, path, payload):
    conn.request('POST', path, body = json.dumps(payload),
                 headers = {'Content-Type': 'application/json'})
    return conn.getresponse()


def _wait_pending(engine, n = 1, timeout = 10.):
    deadline = time.time() + timeout
    while len(engine.pending) < n:
        assert time.time() < deadline, 'request never reached the engine'
        time.sleep(0.005)


def _released(engine, audio = None):
    """A thread that releases the next request once it reaches the engine."""
    t = threading.Thread(target = lambda: (_wait_pending(engine), engine.release(audio)))
    t.start()
    return t


def test_health_and_stats(fake_server):
    engine, server, conn = fake_server
    conn.request('GET', '/health')
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())['status'] == 'ok'
    conn.request('GET', '/stats')
    resp = conn.getresponse()
    assert json.loads(resp.read())['requests'] == 0


def test_oneshot_roundtrip_fake(fake_server):
    engine, server, conn = fake_server
    audio = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    done = _released(engine, audio)
    resp = _post(conn, '/tts', {'text': 'hello'})
    done.join(timeout = TIMEOUT)
    assert resp.status == 200
    assert resp.getheader('Content-Type') == 'audio/wav'
    assert resp.getheader('X-Request-Id', '').startswith('fake-')
    rate, _, _, _, pcm = parse_wav(resp.read())
    assert rate == 8000
    assert np.allclose(pcm / 32767., audio, atol = 2e-4)


def test_missing_text_is_400(fake_server):
    _, _, conn = fake_server
    resp = _post(conn, '/tts', {})
    assert resp.status == 400
    assert 'text' in json.loads(resp.read())['error']


def test_unknown_path_404(fake_server):
    _, _, conn = fake_server
    assert _post(conn, '/nope', {'text': 'x'}).status == 404


def test_abort_queued_request(fake_server):
    engine, server, conn = fake_server
    request = server.submit('queued text')
    conn.request('DELETE', '/requests/{}'.format(request.request_id))
    resp = conn.getresponse()
    assert resp.status == 200
    resp.read()                      # keep-alive: drain before reusing
    assert request.aborted.is_set()
    with pytest.raises(RuntimeError):
        request.result.get(timeout = 1)
    # second abort: already finished -> 404
    conn.request('DELETE', '/requests/{}'.format(request.request_id))
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()
    engine.pending.clear()


def test_abort_unknown_request_404(fake_server):
    _, _, conn = fake_server
    conn.request('DELETE', '/requests/nope')
    assert conn.getresponse().status == 404


def test_streaming_chunks_fake(fake_server):
    engine, server, conn = fake_server
    audio = np.linspace(-0.25, 0.25, 64).astype(np.float32)
    done = _released(engine, audio)
    resp = _post(conn, '/tts?stream=1', {'text': 'hello'})
    done.join(timeout = TIMEOUT)
    assert resp.status == 200
    assert resp.getheader('Transfer-Encoding') == 'chunked'
    rate, _, _, size, pcm = parse_wav(resp.read())   # http.client joins the chunks
    assert rate == 8000 and size > 2 ** 31          # streaming header
    assert np.allclose(pcm / 32767., audio, atol = 2e-4)


def test_keep_alive_survives_404_with_body(fake_server):
    """An unknown-path POST drains its body, or the next request on the same
    keep-alive connection would parse the leftover bytes as a request line."""
    _, _, conn = fake_server
    resp = _post(conn, '/nope', {'text': 'a body that must be drained'})
    assert resp.status == 404
    resp.read()
    conn.request('GET', '/health')           # same connection
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())['status'] == 'ok'


def test_stream_query_is_parsed_not_substring_matched(fake_server):
    """?upstream=1 / ?stream=0 are one-shot; only a truthy 'stream' key
    streams.  The 'stream' body key does not reach the engine."""
    engine, server, conn = fake_server
    for path in ('/tts?upstream=1', '/tts?stream=0'):
        done = _released(engine)
        resp = _post(conn, path, {'text': 'hello'})
        done.join(timeout = TIMEOUT)
        assert resp.status == 200
        assert resp.getheader('Transfer-Encoding') is None
        assert 'stream' not in engine.last_kwargs and 'on_audio' not in engine.last_kwargs
        resp.read()
    done = _released(engine)
    resp = _post(conn, '/tts?stream=1', {'text': 'hi', 'stream': 1})
    done.join(timeout = TIMEOUT)
    assert resp.getheader('Transfer-Encoding') == 'chunked'
    assert 'stream' not in engine.last_kwargs and 'on_audio' in engine.last_kwargs
    resp.read()


def test_failed_stream_truncates_without_inline_500(fake_server):
    """A request failing mid-stream truncates the chunked body (no
    terminating chunk, connection closed), not a 500 written into it."""
    engine, server, conn = fake_server

    def fail():
        _wait_pending(engine)
        engine.pending.pop(0).result.set_exception(RuntimeError('decode failed'))

    t = threading.Thread(target = fail)
    t.start()
    resp = _post(conn, '/tts?stream=1', {'text': 'hello'})
    t.join(timeout = TIMEOUT)
    assert resp.status == 200                   # headers were already out
    with pytest.raises(http.client.IncompleteRead) as exc:
        resp.read()
    got = exc.value.partial
    assert b'HTTP/1.1 500' not in got and b'error' not in got


def test_oneshot_timeout_aborts_engine_request():
    """A request past the server timeout returns 500 AND aborts the engine
    request, so its slot frees."""
    engine = FakeEngine()
    server = TTSServer(engine, rate = 8000, port = 0, timeout = 0.2)
    with server:
        conn = _connect(server)
        try:
            resp = _post(conn, '/tts', {'text': 'never finishes'})
            assert resp.status == 500
            resp.read()
            assert engine.pending[0].aborted.is_set()
        finally:
            conn.close()
            engine.pending.clear()


def test_client_disconnect_aborts_stream():
    """A streaming client dropping the socket mid-utterance aborts the engine
    request at the next emitted chunk."""
    engine = FakeEngine()
    server = TTSServer(engine, rate = 8000, port = 0, timeout = 20.)
    with server:
        conn = _connect(server)
        conn.request('POST', '/tts?stream=1', body = json.dumps({'text': 'long utterance'}),
                     headers = {'Content-Type': 'application/json'})
        _wait_pending(engine)
        request = engine.pending[0]
        conn.close()                           # the client gives up
        # keep emitting chunks (result NOT set): the handler's writes hit
        # the dead socket and it must abort the request
        deadline = time.time() + 10
        try:
            while not request.aborted.is_set():
                assert time.time() < deadline, 'disconnect never aborted'
                request.kwargs['on_audio'](np.zeros(32, np.float32))
                time.sleep(0.02)
        finally:
            engine.pending.clear()


# -- real models over real sockets -----------------------------------------------------

@pytest.fixture(scope = 'module')
def tiny(tmp_path_factory):
    """A tiny VITS and a tiny Tacotron-2 + WaveGlow (``sigma=0``), seeded, on
    the CPU (`create` and `from_jax`: the JAX layouts through `weights`)."""
    root = str(tmp_path_factory.mktemp('models'))
    mel_fn = TacotronSTFT(sampling_rate = 8000, hop_length = 8, filter_length = 16,
                          win_length = 16)
    vits = VITS.create('en', name = 'http_vits', mel_fn = mel_fn, root = root, device = 'cpu',
                       ** VITS_HP)
    tacotron = Tacotron2.create('en', name = 'http_taco', root = root, device = 'cpu',
                                ** TACOTRON)
    tacotron.arch.hp.gate_threshold = 1.1      # every request runs to max_steps
    arch = WaveGlowArch(** WAVEGLOW)
    vocoder = WaveGlow.from_jax(init_waveglow(arch.hp, arch.flow_channels, seed = 0),
                                name = 'http_wg', device = 'cpu', root = root, ** WAVEGLOW)
    return vits, tacotron, vocoder


def test_vits_over_http(tiny):
    model = tiny[0]
    engine = ContinuousServingEngine(
        * make_vits_stepper(model, window = 16, context = 4, token_multiple = 8,
                            min_duration = 2),
        max_batch_size = 2)
    server = TTSServer(engine, rate = model.rate, port = 0, timeout = TIMEOUT)
    with server:
        conn = _connect(server)
        try:
            resp = _post(conn, '/tts', {'text': 'hello world'})
            assert resp.status == 200
            rate, bits, _, _, pcm = parse_wav(resp.read())
            assert rate == model.rate and bits == 16
            assert len(pcm) >= model.arch.upsample_rate  # >= 1 frame of audio
            # the streaming endpoint over the same live engine
            resp = _post(conn, '/tts?stream=1', {'text': 'hello there'})
            assert resp.status == 200
            _, _, _, size, pcm_s = parse_wav(resp.read())
            assert size > 2 ** 31 and len(pcm_s) >= model.arch.upsample_rate
        finally:
            conn.close()


def _oneshot_and_stream(server, text):
    conn = _connect(server)
    try:
        one = _post(conn, '/tts', {'text': text})
        assert one.status == 200
        one = parse_wav(one.read())
        streamed = _post(conn, '/tts?stream=1', {'text': text})
        assert streamed.status == 200
        streamed = parse_wav(streamed.read())
        conn.request('GET', '/stats')
        stats = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    return one, streamed, stats


def test_serve_vits(tiny):
    """`serve(model=vits, block=False)` builds the VITS stepper (int16 chunks
    by default, the window shrunk to the tiny frame buffer) and returns a
    live server on the native scheduler."""
    model = tiny[0]
    server = serve(model = model, port = 0, block = False, window = 96, context = 4,
                   token_multiple = 8, min_duration = 2, noise_scale = 0., noise_scale_w = 0.,
                   max_batch_size = 2)
    try:
        assert server.engine.native_scheduler == available()
        one, streamed, stats = _oneshot_and_stream(server, 'served')
        assert one[0] == streamed[0] == model.rate and len(one[4]) > 0
        np.testing.assert_array_equal(streamed[4], one[4])
        assert stats['requests'] == 2 and stats['completed'] == 2
    finally:
        server.stop()


def test_serve_tacotron_streams_through_the_vocoder(tiny):
    """`serve(model=tacotron, vocoder=waveglow)`: the Tacotron-2 stepper with
    streamed audio (the location kernel of 5 is outside the fused decoder's
    envelope: the plain route), a warm-up over the buckets first; the
    streamed WAV equals the one-shot WAV, ``max_steps × rate`` samples."""
    _, tacotron, vocoder = tiny
    server = serve(model = tacotron, vocoder = vocoder, port = 0, block = False, chunk = 4,
                   token_multiple = 8, max_steps = 8, deterministic = True,
                   stream_context = 4, stream_lookahead = 1, max_batch_size = 2,
                   warmup = 'warm up')
    try:
        assert not server.engine.step_fn.fused
        one, streamed, stats = _oneshot_and_stream(server, 'hello there')
        assert one[0] == streamed[0] == tacotron.rate
        assert len(one[4]) == 8 * vocoder.upsample_rate
        np.testing.assert_array_equal(streamed[4], one[4])
        assert stats['requests'] == 2
    finally:
        server.stop()
