"""Extra logging handlers.

Counterpart of ``text_to_speech_tpu/loggers/handlers.py``.  `TTSHandler`
speaks a record through the port's `tts(..., play=True)`, on the thread
that logs it; on a host without a player the playback logs a warning and
returns, and the handler does not re-enter itself for it.  A failed
synthesis goes to `handleError`.
"""

import logging


class TelegramHandler(logging.Handler):
    """Posts records to a Telegram chat via the bot API."""

    API_URL = 'https://api.telegram.org/bot{token}/sendMessage'

    def __init__(self, token, chat_id, level = logging.WARNING, timeout = 5):
        super().__init__(level)
        self.token = token
        self.chat_id = chat_id
        self.timeout = timeout

    def emit(self, record):
        try:
            import requests
            requests.post(
                self.API_URL.format(token = self.token),
                json = {'chat_id': self.chat_id, 'text': self.format(record)},
                timeout = self.timeout,
            )
        except Exception:
            self.handleError(record)


class TTSHandler(logging.Handler):
    """Speaks log records through a TTS model (lazy-loaded, non-blocking)."""

    def __init__(self, model = None, lang = 'en', level = logging.WARNING,
                 blocking = False):
        super().__init__(level)
        self.model = model
        self.lang = lang
        self.blocking = blocking
        self._busy = False

    def emit(self, record):
        if self._busy: return          # never re-enter while synthesizing
        try:
            self._busy = True
            from ..models.tts import tts
            # on this thread (workers=0): a record logged while it speaks
            # (the player's own warning) then finds the handler's lock held
            # by its own thread and returns on `_busy`, where a `Stream`
            # thread would wait for that lock for ever
            tts(self.format(record), model = self.model, lang = self.lang,
                play = True, save = False, blocking = self.blocking, workers = 0)
        except Exception:
            self.handleError(record)
        finally:
            self._busy = False


class BufferingHandler(logging.Handler):
    """Keeps the last `capacity` records in memory (introspection/tests)."""

    def __init__(self, capacity = 1000, level = logging.NOTSET):
        super().__init__(level)
        self.capacity = capacity
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))
        if len(self.records) > self.capacity:
            self.records = self.records[-self.capacity:]
