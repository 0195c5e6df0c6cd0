"""Stdlib-only HTTP front-end over the serving engines.

Counterpart of ``text_to_speech_tpu/runtimes/http_server.py``.  Exposes any
serving engine (`ServingEngine` or `ContinuousServingEngine`, both over
the C++ scheduler core) as an HTTP API with no dependency beyond the
standard library:

    POST /tts                 {"text": "...", "priority": 0, ...}
                              → complete utterance as audio/wav (16-bit PCM)
    POST /tts?stream=1        → chunked-transfer WAV: audio bytes flush as
                              the stepper emits them (requires an engine
                              whose start_fn accepts ``on_audio``, e.g.
                              `make_vits_stepper` /
                              `make_tacotron_stepper(stream_audio=True)`)
    DELETE /requests/<id>     → abort (while queued on either engine; the
                              continuous engine also drops an in-flight
                              request at its next decode chunk boundary)
    GET  /health              → liveness + model name
    GET  /stats               → engine + scheduler-core counters

Responses carry ``X-Request-Id`` so a client can abort.  The server is a
`ThreadingHTTPServer`: each connection blocks on its own AsyncResult while
the engine batches across connections (in-flight admission happens at
decode chunk boundaries, so a request submitted mid-decode still enters
the active batch; see `runtimes.serving`).  A client that drops its
connection, and a one-shot request past the server's `timeout`, abort
their engine request.

Usage (or `models.tts.serve`):
    from text_to_speech_tpu_torch.runtimes.serving import (
        ContinuousServingEngine, make_vits_stepper)
    from text_to_speech_tpu_torch.runtimes.http_server import TTSServer

    engine = ContinuousServingEngine(* make_vits_stepper(model), max_batch_size = 8)
    with TTSServer(engine, rate = model.rate, port = 8700) as server:
        server.serve_forever()        # or .start() for a daemon thread
"""

import json
import queue
import struct
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

logger = logging.getLogger(__name__)

_WAV_STREAM_SIZE = 0xFFFFFFFF - 100     # unknown-length streaming WAV


def wav_header(rate, n_samples = None, channels = 1, sample_width = 2):
    """RIFF/WAVE header for 16-bit PCM; ``n_samples=None`` → streaming
    header with maxed-out chunk sizes (players read to EOF)."""
    data_size = _WAV_STREAM_SIZE if n_samples is None \
        else n_samples * channels * sample_width
    byte_rate = rate * channels * sample_width
    return b''.join([
        b'RIFF', struct.pack('<I', min(data_size + 36, 0xFFFFFFFF)), b'WAVE',
        b'fmt ', struct.pack('<IHHIIHH', 16, 1, channels, rate, byte_rate,
                             channels * sample_width, sample_width * 8),
        b'data', struct.pack('<I', data_size),
    ])


def pcm16(audio):
    """float waveform → little-endian int16 PCM bytes."""
    audio = np.clip(np.asarray(audio, np.float32), -1., 1.)
    return (audio * 32767.).astype('<i2').tobytes()


def encode_wav(audio, rate):
    body = pcm16(audio)
    return wav_header(rate, len(body) // 2) + body


class _Handler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'
    server_version = 'tts/1.0'

    # -- helpers ---------------------------------------------------------------

    def _json(self, payload, status = 200, headers = ()):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status, message):
        self._json({'error': message}, status = status)

    def _read_request(self):
        length = int(self.headers.get('Content-Length') or 0)
        raw = self.rfile.read(length) if length else b'{}'
        payload = json.loads(raw.decode() or '{}')
        if not isinstance(payload, dict):
            payload = {'text': payload}
        if not str(payload.get('text') or '').strip():
            raise ValueError("missing 'text'")
        return payload

    def _write_chunk(self, data):
        if not data: return
        self.wfile.write(b'%x\r\n' % len(data))
        self.wfile.write(data)
        self.wfile.write(b'\r\n')
        self.wfile.flush()

    # -- routes ----------------------------------------------------------------

    def do_GET(self):
        srv = self.server.tts
        path = self.path.split('?')[0]
        if path == '/health':
            self._json({'status': 'ok', 'name': srv.name})
        elif path == '/stats':
            self._json(srv.stats())
        else:
            self._error(404, 'unknown path {}'.format(path))

    def do_DELETE(self):
        srv = self.server.tts
        parts = self.path.rstrip('/').split('/')
        if len(parts) == 3 and parts[1] == 'requests':
            if srv.abort(parts[2]):
                self._json({'aborted': parts[2]})
            else:
                self._error(404, 'unknown or finished request')
        else:
            self._error(404, 'unknown path {}'.format(self.path))

    def do_POST(self):
        path, _, query = self.path.partition('?')
        if path not in ('/tts', '/tts/'):
            # drain the body so the next request on this keep-alive
            # connection starts at a request line, not mid-payload
            length = int(self.headers.get('Content-Length') or 0)
            if length: self.rfile.read(length)
            return self._error(404, 'unknown path {}'.format(path))
        try:
            payload = self._read_request()
        except ValueError as e:
            return self._error(400, str(e))
        except Exception:
            return self._error(400, 'invalid JSON body')
        stream = bool(payload.pop('stream', False))
        q_stream = parse_qs(query).get('stream')
        if q_stream is not None:
            stream = stream or q_stream[-1].lower() not in ('', '0', 'false')
        self._request = None
        self._response_started = False
        try:
            if stream:
                self._stream_tts(payload)
            else:
                self._oneshot_tts(payload)
        except ConnectionError:
            # client went away mid-response: free the engine slot
            self._abort_active()
            self.close_connection = True
        except Exception as e:
            logger.exception('tts request failed')
            self._abort_active()
            if self._response_started:
                # headers (and part of a chunked body) are already out —
                # truncate and drop the connection; writing a 500 here
                # would corrupt the chunked stream and any pipelined
                # request behind it
                self.close_connection = True
            else:
                try:
                    self._error(500, str(e))
                except Exception:
                    pass

    def _abort_active(self):
        """Abort the in-flight engine request of a dead/failed connection
        (the continuous engine drops it at the next chunk boundary)."""
        request = getattr(self, '_request', None)
        if request is not None and not request.result.done():
            try:
                request.abort()
            except Exception:
                logger.exception('abort failed')

    def _oneshot_tts(self, payload):
        srv = self.server.tts
        text = payload.pop('text')
        request = srv.submit(text, payload)
        self._request = request
        output = request.result.get(timeout = srv.timeout)
        audio, rate = srv.extract_audio(output)
        body = encode_wav(audio, rate)
        self._response_started = True
        self.send_response(200)
        self.send_header('Content-Type', 'audio/wav')
        self.send_header('Content-Length', str(len(body)))
        self.send_header('X-Request-Id', str(request.request_id))
        self.end_headers()
        self.wfile.write(body)

    def _stream_tts(self, payload):
        srv = self.server.tts
        text = payload.pop('text')
        chunks = queue.Queue()
        request = srv.submit(text, payload,
                             on_audio = lambda part: chunks.put(part))
        self._request = request
        self._response_started = True
        self.send_response(200)
        self.send_header('Content-Type', 'audio/wav')
        self.send_header('Transfer-Encoding', 'chunked')
        self.send_header('X-Request-Id', str(request.request_id))
        self.end_headers()
        self._write_chunk(wav_header(srv.rate))
        while True:
            # drain emitted chunks; poll the request so a failed/aborted
            # stream terminates instead of hanging the connection
            try:
                part = chunks.get(timeout = 0.05)
            except queue.Empty:
                if request.result.done():
                    break
                continue
            self._write_chunk(pcm16(part))
        while not chunks.empty():
            self._write_chunk(pcm16(chunks.get()))
        # a failed request truncates the stream (headers are already out);
        # the missing terminating chunk tells the client it was cut short
        request.result.get(timeout = srv.timeout)
        self.wfile.write(b'0\r\n\r\n')
        self.wfile.flush()

    def log_message(self, fmt, * args):        # route through logging, not stderr
        logger.debug('%s - %s', self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        # clients dropping keep-alive connections is normal operation, not
        # an error worth a stderr traceback (socketserver's default)
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            logger.debug('connection from %s closed: %s',
                         client_address, exc)
        else:
            logger.exception('error handling request from %s',
                             client_address)


class TTSServer:
    """HTTP wrapper around a serving engine.

    ``engine`` needs ``submit(inputs, **kwargs) -> request`` (returning an
    `InferenceRequest` with ``result``/``request_id``/``abort``) plus
    optional ``stats``/``scheduler_stats`` — both engine classes qualify.
    ``extract_audio`` turns an engine output into ``(waveform, rate)``; the
    default understands the steppers' dict outputs and raw arrays."""

    def __init__(self, engine, *, rate = 22050, host = '127.0.0.1',
                 port = 8700, name = 'tts', timeout = 600.,
                 extract_audio = None):
        self.engine = engine
        self.rate = rate
        self.name = name
        self.timeout = timeout
        if extract_audio is not None:
            self.extract_audio = extract_audio
        self._requests = {}
        self._lock = threading.Lock()
        self._httpd = _Server((host, port), _Handler)
        self._httpd.tts = self
        self._thread = None

    # -- engine glue -------------------------------------------------------

    def submit(self, text, kwargs = None, ** extra):
        request = self.engine.submit(text, ** dict(kwargs or {}, ** extra))
        with self._lock:
            if len(self._requests) > 4096:   # bounded: drop finished ids
                self._requests = {k: r for k, r in self._requests.items()
                                  if not r.result.done()}
            self._requests[str(request.request_id)] = request
        return request

    def abort(self, request_id):
        with self._lock:
            request = self._requests.get(str(request_id))
        if request is None or request.result.done():
            return False
        request.abort()
        return True

    def extract_audio(self, output):
        if isinstance(output, dict):
            return output['audio'], int(output.get('rate', self.rate))
        return np.asarray(output), self.rate

    def stats(self):
        stats = {}
        for source in ('stats', 'scheduler_stats'):
            value = getattr(self.engine, source, None)
            if isinstance(value, dict):
                stats.update({
                    k: (list(v) if hasattr(v, 'popleft') else v)
                    for k, v in value.items() if k != 'latencies'})
        return stats

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self):
        host, port = self._httpd.server_address[:2]
        return 'http://{}:{}'.format(host, port)

    def start(self):
        """Serve on a daemon thread (returns immediately)."""
        if self._thread is None:
            start = getattr(self.engine, 'start', None)
            if start is not None: start()
            self._thread = threading.Thread(
                target = self._httpd.serve_forever, daemon = True,
                name = self.name + '-http')
            self._thread.start()
        return self

    def serve_forever(self):
        getattr(self.engine, 'start', lambda: None)()
        self._httpd.serve_forever()

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout = 10)
            self._thread = None
        stop = getattr(self.engine, 'stop', None)
        if stop is not None: stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, * exc):
        self.stop()
