"""Observability layer: custom log levels, handler factory, span timers.

Counterpart of ``text_to_speech_tpu/loggers/__init__.py``: adds the
``time``/``time_debug``/``dev`` levels, the ``set_level``/``add_handler``
helpers and re-exports the timing API (`Timer`, `timer`, `timer_report`,
`reset_timers`, and the `torch.profiler` trace).
"""

import os
import re
import sys
import logging

from .time_logging import (
    TIME_LEVEL, TIME_DEBUG_LEVEL, Timer, timer, timer_report, reset_timers,
    ROOT_TIMER, start_profiler_trace, stop_profiler_trace,
)

DEV_LEVEL = 11

_CUSTOM_LEVELS = {
    'time': TIME_LEVEL,
    'time_debug': TIME_DEBUG_LEVEL,
    'dev': DEV_LEVEL,
}

for _name, _level in _CUSTOM_LEVELS.items():
    logging.addLevelName(_level, _name.upper())


def _add_level_method(name, level):
    def log_method(self, message, *args, **kwargs):
        if self.isEnabledFor(level):
            self._log(level, message, args, **kwargs)
    setattr(logging.Logger, name, log_method)


for _name, _level in _CUSTOM_LEVELS.items():
    _add_level_method(_name, _level)


def get_level(level):
    """Resolve a level name (including custom ones) or int to an int level."""
    if isinstance(level, int): return level
    level = level.lower()
    if level in _CUSTOM_LEVELS: return _CUSTOM_LEVELS[level]
    resolved = logging.getLevelName(level.upper())
    if isinstance(resolved, int): return resolved
    raise ValueError('Unknown logging level: {}'.format(level))


def add_level(value, name):
    """Register a new custom log level: names it, makes `set_level(name)`
    resolve it, and adds a `logger.<name>(msg)` method."""
    name = name.lower()
    _CUSTOM_LEVELS[name] = value
    logging.addLevelName(value, name.upper())
    _add_level_method(name, value)


def set_level(level, logger = None):
    logging.getLogger(logger).setLevel(get_level(level))


#: named formats; '{'-style
_STYLES = {
    'basic': '{message}',
    'extended': '{asctime} : {levelname} : {message}',
    'dev': '{asctime} : {levelname} : {module} ({funcName}, {lineno}) : {message}',
}


def get_formatter(format = 'basic', datefmt = None):
    """→ a `logging.Formatter` from a style name ('basic'/'extended'/'dev'),
    a raw format string ('%' or '{' style auto-detected), or a dict of
    Formatter kwargs (left unmutated)."""
    if isinstance(format, logging.Formatter):
        return format
    if isinstance(format, str):
        format = {'fmt': _STYLES.get(format, format)}
    else:
        format = dict(format)
    fmt = format.get('fmt')
    if fmt is not None and 'style' not in format:
        # '{'-style wins when brace fields are present (a literal '%' in a
        # brace format must not flip the detection)
        format['style'] = '{' if re.search(r'\{\w+[^}]*\}', fmt) else '%'
    if datefmt:
        format.setdefault('datefmt', datefmt)
    return logging.Formatter(** format)


def set_style(style, logger = None):
    """Apply a named format to every handler of `logger` (root when None)."""
    formatter = get_formatter(style)
    for handler in logging.getLogger(logger).handlers:
        handler.setFormatter(formatter)


def try_tts_handler(* args, ** kwargs):
    """Best-effort TTSHandler (speaks log records) → None on failure."""
    try:
        from .handlers import TTSHandler
        return TTSHandler(* args, ** kwargs)
    except Exception as exc:
        logging.getLogger(__name__).error(
            'could not initialize TTSHandler: %s', exc)
        return None


def add_handler(handler = 'stream', logger = None, level = None, fmt = None, ** kwargs):
    """Attach a handler by name: 'stream', 'file' (filename=...), or a
    logging.Handler instance."""
    if isinstance(handler, str):
        handler = handler.lower()
        if handler == 'stream':
            handler = logging.StreamHandler(kwargs.get('stream', sys.stdout))
        elif handler == 'file':
            handler = logging.FileHandler(kwargs['filename'])
        elif handler == 'smtp':
            from logging.handlers import SMTPHandler
            handler = SMTPHandler(** kwargs)
        else:
            raise ValueError('Unknown handler type: {}'.format(handler))
    if level is not None:
        handler.setLevel(get_level(level))
    if fmt is not None:
        handler.setFormatter(logging.Formatter(fmt))
    logging.getLogger(logger).addHandler(handler)
    return handler


_DEFAULT_FORMAT = '%(asctime)s : %(levelname)s : %(message)s'


def setup_logging(level = None, fmt = None):
    """Initialise root logging from env (`LOG_LEVEL`, `LOG_FORMAT`) or args."""
    level = level if level is not None else os.environ.get('LOG_LEVEL', 'info')
    fmt = fmt if fmt is not None else os.environ.get('LOG_FORMAT', _DEFAULT_FORMAT)
    logging.basicConfig(level = get_level(level), format = fmt)
