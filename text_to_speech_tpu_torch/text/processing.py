"""Long-text chunking for bounded-length synthesis.

The part of ``text_to_speech_tpu/text/processing.py`` that the synthesis
path uses (`split_text`, `split_sentences`), copied so that the port
imports nothing of the JAX package.  Long inputs are recursively split
(paragraph → sentence → clause → word) into chunks of at most `max_length`
characters, then greedily merged back so chunks are as large as possible.
"""

import re

_SENTENCE_SPLIT_RE = re.compile(r'(?<=[.!?…])\s+|\n+')
_CLAUSE_SPLIT_RE = re.compile(r'(?<=[,;:])\s+')
_WORD_SPLIT_RE = re.compile(r'\s+')


def split_sentences(text):
    """Split on sentence boundaries (punctuation + whitespace, newlines)."""
    return [s.strip() for s in _SENTENCE_SPLIT_RE.split(text) if s and s.strip()]


def split_paragraphs(text):
    return [p.strip() for p in re.split(r'\n\s*\n', text) if p.strip()]


def merge_texts(parts, max_length, sep = ' '):
    """Greedily merge consecutive `parts` while staying under `max_length`."""
    groups, cur, cur_len = [], [], 0
    for part in parts:
        extra = len(part) if not cur else len(part) + len(sep)
        if not cur or cur_len + extra <= max_length:
            cur.append(part)
            cur_len += extra
        else:
            groups.append(cur)
            cur, cur_len = [part], len(part)
    if cur:
        groups.append(cur)
    return [sep.join(g) for g in groups]


def _split_level(parts, max_length, splitters):
    """Recursively split any part exceeding `max_length` with the next splitter."""
    if not splitters:
        return parts
    splitter, *rest = splitters
    out = []
    for part in parts:
        if len(part) <= max_length:
            out.append(part)
        else:
            sub = [s.strip() for s in splitter(part) if s and s.strip()]
            out.extend(_split_level(sub or [part], max_length, rest))
    return out


def split_text(text, max_length = 150):
    """Split `text` into chunks of at most `max_length` characters, breaking
    at the largest possible linguistic boundary and merging back greedily."""
    if len(text) <= max_length:
        stripped = text.strip()
        return [stripped] if stripped else []

    splitters = [
        split_paragraphs,
        _SENTENCE_SPLIT_RE.split,
        _CLAUSE_SPLIT_RE.split,
        _WORD_SPLIT_RE.split,
    ]
    parts = _split_level([text], max_length, splitters)
    return merge_texts(parts, max_length)
