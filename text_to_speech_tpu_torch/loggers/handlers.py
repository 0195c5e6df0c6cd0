"""Extra logging handlers.

Counterpart of ``text_to_speech_tpu/loggers/handlers.py``.  `TTSHandler`
calls the port's `tts()`, which does not play audio yet (it refuses
``play``): every record it is given goes to `handleError`, as the JAX
package's handler does when synthesis fails.
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
            tts(self.format(record), model = self.model, lang = self.lang,
                play = True, save = False, blocking = self.blocking)
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
