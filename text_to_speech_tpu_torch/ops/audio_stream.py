"""Streaming audio playback.

Counterpart of `AudioStream`, `AudioPlayer` and `stream_audio` in
``text_to_speech_tpu/ops/audio_stream.py``: the speakers are an
ffplay/aplay subprocess fed 16-bit PCM over a pipe by a writer thread, so
a clip plays while the next one is synthesized.  The player command can be
injected (`player`).  Capture (`AudioRecorder`, `record_audio`) is not
ported.
"""

import queue
import shutil
import logging
import threading
import subprocess

import numpy as np

logger = logging.getLogger(__name__)


class AudioStream:
    """Queue-fed playback stream: `put(chunk)` float32/-int16 chunks; a
    writer thread feeds the player process."""

    def __init__(self, rate = 22050, *, player = None):
        self.rate = rate
        self._player_cmd = player
        self._queue = queue.Queue()
        self._proc = None
        self._thread = None
        self._stopped = threading.Event()

    def _resolve_player(self):
        if self._player_cmd: return self._player_cmd
        if shutil.which('ffplay'):
            return ['ffplay', '-v', 'quiet', '-nodisp', '-autoexit',
                    '-f', 's16le', '-ar', str(self.rate), '-i', 'pipe:0']
        if shutil.which('aplay'):
            return ['aplay', '-q', '-f', 'S16_LE', '-r', str(self.rate), '-']
        return None

    def start(self):
        cmd = self._resolve_player()
        if cmd is None:
            logger.warning('no audio player available; AudioStream is a no-op')
            return False
        self._proc = subprocess.Popen(
            cmd, stdin = subprocess.PIPE,
            stdout = subprocess.DEVNULL, stderr = subprocess.DEVNULL,
        )
        self._stopped.clear()
        self._thread = threading.Thread(target = self._writer, daemon = True)
        self._thread.start()
        return True

    def _writer(self):
        while not self._stopped.is_set():
            try:
                chunk = self._queue.get(timeout = 0.2)
            except queue.Empty:
                continue
            if chunk is None:
                break
            chunk = np.asarray(chunk)
            if chunk.dtype != np.int16:
                chunk = np.clip(chunk * 32767., -32768, 32767).astype(np.int16)
            try:
                self._proc.stdin.write(chunk.tobytes())
                self._proc.stdin.flush()
            except (BrokenPipeError, ValueError):
                break
        try:
            self._proc.stdin.close()
        except Exception:
            pass

    def put(self, chunk):
        self._queue.put(chunk)

    def stop(self, drain = True):
        if drain:
            self._queue.put(None)
        else:
            self._stopped.set()
        if self._thread: self._thread.join(timeout = 5)
        if self._proc:
            try:
                self._proc.wait(timeout = 10)
            except subprocess.TimeoutExpired:
                self._proc.kill()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class AudioPlayer(AudioStream):
    """One-shot playback of complete clips through the stream interface."""

    def play(self, audio, blocking = True):
        if not self.start(): return False
        self.put(np.asarray(audio))
        if blocking:
            self.stop(drain = True)
        return True


def stream_audio(chunks, rate = 22050, ** kwargs):
    """Play an iterable of chunks as they arrive."""
    with AudioStream(rate, ** kwargs) as stream:
        for chunk in chunks:
            stream.put(chunk)
    return True
