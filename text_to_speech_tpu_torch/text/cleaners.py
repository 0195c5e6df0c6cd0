"""Composable text cleaners for the TTS frontend.

A copy of ``text_to_speech_tpu/text/cleaners.py``, kept so that the port
imports nothing of the JAX package: name-resolved cleaner pipelines,
abbreviation/symbol/acronym expansion, number expansion, ASCII transliteration (self-contained — no `unidecode` dependency),
accent-preserving French variant, whitespace collapsing.
"""

import re
import unicodedata

from functools import partial

from .numbers import normalize_numbers

_WHITESPACE_RE = re.compile(r'\s+')
_ACRONYM_RE = re.compile(r"\b[A-Z]{2,4}(?!['a-z])\b")
_MARKDOWN_BOLD_RE = re.compile(r'\*\*(.*?)\*\*')

_FR_KEPT_ACCENTS = 'éèêîçô'

# Translations applied before NFD-stripping for characters whose decomposition
# loses meaning (ligatures, quotes, dashes, common symbols).
_ASCII_MAP = {
    'æ': 'ae', 'Æ': 'AE', 'œ': 'oe', 'Œ': 'OE', 'ß': 'ss', 'ø': 'o', 'Ø': 'O',
    'đ': 'd', 'Đ': 'D', 'ł': 'l', 'Ł': 'L', 'þ': 'th', 'Þ': 'Th', 'ð': 'd',
    '’': "'", '‘': "'", '“': '"', '”': '"', '„': '"', '‚': "'",
    '—': '-', '–': '-', '‑': '-', '…': '...', '·': '.', '«': '"', '»': '"',
    ' ': ' ', ' ': ' ', ' ': ' ',
}

_SPECIAL_SYMBOLS = {
    '=': {'fr': 'égal', 'en': 'equal'},
    '+': {'fr': 'plus', 'en': 'plus'},
    '/': {'fr': 'slash', 'en': 'slash'},
    '^': {'fr': 'chapeau', 'en': 'hat'},
    '%': {'fr': 'pourcent', 'en': 'percent'},
    '§': {'fr': 'paragraphe', 'en': 'paragraph'},
    '&': {'fr': 'et', 'en': 'and'},
    '°C': {'fr': 'degrés', 'en': 'degrees'},
    '°': {'fr': 'degrés', 'en': 'degrees'},
}

_ABBREVIATIONS = {
    'en': {
        'mr': 'mister', 'mrs': 'misess', 'ms': 'miss', 'dr': 'doctor',
        'st': 'saint', 'co': 'company', 'jr': 'junior', 'sr': 'senior',
        'maj': 'major', 'gen': 'general', 'drs': 'doctors', 'rev': 'reverend',
        'lt': 'lieutenant', 'hon': 'honorable', 'sgt': 'sergeant',
        'capt': 'captain', 'esq': 'esquire', 'ltd': 'limited',
        'col': 'colonel', 'ft': 'fort', 'etc': 'et cetera',
        'e.g': 'for example', 'i.e': 'that is', 'vs': 'versus',
        'approx': 'approximately', 'no': 'number', 'dept': 'department',
    },
    'fr': {
        'm': 'monsieur', 'mr': 'monsieur', 'mme': 'madame', 'mlle': 'mademoiselle',
        'dr': 'docteur', 'st': 'saint', 'ste': 'sainte', 'etc': 'et cetera',
        'ex': 'exemple', 'av': 'avenue', 'bd': 'boulevard', 'fig': 'figure',
        'env': 'environ', 'cf': 'confer', 'nb': 'nota bene',
    },
}

_LETTER_NAMES = {
    'en': {
        'a': 'ae', 'b': 'be', 'c': 'ce', 'd': 'de', 'e': 'e', 'f': 'af',
        'g': 'ge', 'h': 'aich', 'i': 'eye', 'j': 'jay', 'k': 'kay', 'l': 'el',
        'm': 'am', 'n': 'an', 'o': 'oo', 'p': 'pe', 'q': 'qu', 'r': 'ar',
        's': 'as', 't': 'tea', 'u': 'yu', 'v': 've', 'w': 'double yu',
        'x': 'ex', 'y': 'way', 'z': 'ze',
    },
    'fr': {
        'a': 'ha', 'b': 'bé', 'c': 'cé', 'd': 'dé', 'e': 'euh', 'f': 'effe',
        'g': 'gé', 'h': 'hache', 'i': 'ih', 'j': 'ji', 'k': 'ka', 'l': 'elle',
        'm': 'aime', 'n': 'aine', 'o': 'eau', 'p': 'pé', 'q': 'cu', 'r': 'air',
        's': 'aisse', 't': 'thé', 'u': 'eu', 'v': 'vé', 'w': 'double vé',
        'x': 'ix', 'y': 'i grec', 'z': 'zed',
    },
}


def _norm_lang(lang):
    return 'fr' if lang == 'be' else lang


# -- atomic cleaners ----------------------------------------------------------

def lowercase(text, ** kwargs):
    return text.lower()


def collapse_whitespace(text, ** kwargs):
    return _WHITESPACE_RE.sub(' ', text)


def strip(text, ** kwargs):
    return text.strip()


def remove_markdown(text, ** kwargs):
    return _MARKDOWN_BOLD_RE.sub(r'\1', text)


def remove_control(text, ** kwargs):
    return ''.join(
        c for c in text
        if c in ('\t', '\n', '\r', ' ') or not unicodedata.category(c).startswith('C')
    )


def remove_accents(text, ** kwargs):
    text = unicodedata.normalize('NFD', text)
    return ''.join(c for c in text if unicodedata.category(c) != 'Mn')


def convert_to_ascii(text, ** kwargs):
    """Self-contained transliteration: ligature/symbol map + NFD accent strip +
    drop of remaining non-ascii."""
    for src, dst in _ASCII_MAP.items():
        if src in text: text = text.replace(src, dst)
    text = remove_accents(text)
    return text.encode('ascii', 'ignore').decode('ascii')


def fr_convert_to_ascii(text, accepted = _FR_KEPT_ACCENTS, ** kwargs):
    """Transliterate while preserving the French accents in the symbol set."""
    out = []
    for c in text:
        out.append(c if c in accepted else convert_to_ascii(c))
    return ''.join(out)


def expand_numbers(text, lang = 'en', ** kwargs):
    return normalize_numbers(text, lang = lang, ** kwargs)


def expand_abbreviations(text, lang = 'en', abbreviations = None, ** kwargs):
    lang = _norm_lang(lang)
    if abbreviations is None:
        abbreviations = _ABBREVIATIONS.get(lang, {})
    if not abbreviations: return text

    pattern = re.compile(
        r'\b({})(\.|\b)'.format('|'.join(re.escape(a) for a in abbreviations)),
        re.IGNORECASE,
    )
    return pattern.sub(lambda m: abbreviations[m.group(1).lower()], text)


def expand_special_symbols(text, lang = 'en', symbols = None, ** kwargs):
    lang = _norm_lang(lang)
    if symbols is None:
        symbols = {k: v[lang] for k, v in _SPECIAL_SYMBOLS.items() if lang in v}
    for symbol, replacement in symbols.items():
        if symbol in text:
            text = text.replace(symbol, ' ' + replacement + ' ')
    return text


def expand_acronyms(text, lang = 'en', ** kwargs):
    """Spell out short all-caps words letter by letter ('TPU' -> 'tea pe yu')."""
    lang = _norm_lang(lang)
    names = _LETTER_NAMES.get(lang, {})

    def _spell(m):
        word = m.group(0)
        if word == 'I' and lang == 'en': return word
        return ' '.join(names.get(c.lower(), c) for c in word)

    return _ACRONYM_RE.sub(_spell, text)


def collapse_repetitions(text, max_repetition = 3, ** kwargs):
    if not text or max_repetition < 1: return text
    out, count = [text[0]], 1
    for c in text[1:]:
        count = count + 1 if out and c == out[-1] else 1
        if count <= max_repetition: out.append(c)
    return ''.join(out)


def replace_patterns(text, patterns, ** kwargs):
    for pattern, repl in patterns.items():
        text = re.sub(pattern, repl, text)
    return text


def replace_words(text, words, flags = re.IGNORECASE, ** kwargs):
    lowered = {k.lower(): v for k, v in words.items()}
    present = {k: v for k, v in lowered.items() if k in text.lower()}
    if not present: return text
    regex = re.compile(
        r'\b({})\b'.format('|'.join(re.escape(w) for w in words)), flags
    )
    return regex.sub(lambda m: lowered[m.group(0).lower()], text)


def remove_punctuation(text, punctuation = '_!?.,’“”‚‘—–()[]{}:;\'"`+-*/^=\\<>&#$%@', ** kwargs):
    return ''.join(c for c in text if c not in punctuation)


def detach_punctuation(text, punctuation = '!?.,:;()[]{}', ** kwargs):
    """Surround punctuation with spaces (word-level tokenization prep)."""
    for punct in punctuation:
        text = text.replace(punct, ' {} '.format(punct))
    return text.strip()


def attach_punctuation(text, ** kwargs):
    """Re-attach punctuation to adjacent words (inverse of detach)."""
    text = collapse_whitespace(text)
    for punct in '([{':
        text = text.replace('{} '.format(punct), punct)
    for punct in ')]},.!?:;':
        text = text.replace(' {}'.format(punct), punct)
    return text


def expand_tremas(text, ** kwargs):
    """French diaeresis verbalization (aï → aille, ï → hi)."""
    return replace_patterns(text, {r'(aï)\b': 'aille', r'(ï)': 'hi'})


def convert_to_alnum(text, allowed_char = '.,?! ', replace_char = ' ', ** kwargs):
    """Replace all non-alphanumeric characters by `replace_char`."""
    return ''.join(
        c if c.isalnum() or c in allowed_char else replace_char for c in text
    )


def remove_tokens(text, tokens = (), ** kwargs):
    if not tokens: return text
    return replace_words(text, {tok: '' for tok in tokens})


# -- pipelines ----------------------------------------------------------------

def basic_cleaners(text, ** kwargs):
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text, ** kwargs):
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def complete_cleaners(text,
                      lang,
                      *,
                      to_lowercase = True,
                      to_expand = True,
                      to_expand_abbrev = True,
                      to_expand_symbols = True,
                      to_expand_acronyms = False,
                      replacements = None,
                      patterns = None,
                      max_repetition = -1,
                      ** kwargs
                     ):
    """Full language-aware pipeline: patterns/replacements → acronyms →
    lowercase → abbreviations → numbers/symbols → transliteration →
    whitespace collapse."""
    num_lang = lang             # 'be' keeps septante/nonante in numbers
    lang = _norm_lang(lang)     # word tables only have 'en' / 'fr' entries
    if patterns: text = replace_patterns(text, patterns)
    if replacements: text = replace_words(text, replacements)
    if to_expand_acronyms: text = expand_acronyms(text, lang = lang)
    if to_lowercase: text = lowercase(text)
    if to_expand:
        text = remove_markdown(text)
        if to_expand_abbrev: text = expand_abbreviations(text, lang = lang)
        text = expand_numbers(text, lang = num_lang, expand_symbols = to_expand_symbols)
        if to_expand_symbols: text = expand_special_symbols(text, lang = lang)
    if lang == 'fr':
        text = fr_convert_to_ascii(text)
    else:
        text = convert_to_ascii(text)
    if max_repetition > 1: text = collapse_repetitions(text, max_repetition)
    return collapse_whitespace(text).strip()


english_cleaners = partial(complete_cleaners, lang = 'en')
french_cleaners = partial(complete_cleaners, lang = 'fr')
belgian_cleaners = partial(complete_cleaners, lang = 'be')

_CLEANERS = {
    'basic_cleaners': basic_cleaners,
    'transliteration_cleaners': transliteration_cleaners,
    'complete_cleaners': complete_cleaners,
    'english_cleaners': english_cleaners,
    'french_cleaners': french_cleaners,
    'belgian_cleaners': belgian_cleaners,
    'lowercase': lowercase,
    'collapse_whitespace': collapse_whitespace,
    'strip': strip,
    'convert_to_ascii': convert_to_ascii,
    'fr_convert_to_ascii': fr_convert_to_ascii,
    'remove_accents': remove_accents,
    'remove_punctuation': remove_punctuation,
    'remove_control': remove_control,
    'remove_markdown': remove_markdown,
    'expand_numbers': expand_numbers,
    'expand_abbreviations': expand_abbreviations,
    'expand_acronyms': expand_acronyms,
    'expand_special_symbols': expand_special_symbols,
    'detach_punctuation': detach_punctuation,
    'attach_punctuation': attach_punctuation,
    'expand_tremas': expand_tremas,
    'convert_to_alnum': convert_to_alnum,
    'collapse_repetitions': collapse_repetitions,
    'remove_tokens': remove_tokens,
}


def get_cleaners_fn(cleaners):
    """Resolve a cleaner spec list into callables.

    Each entry may be: a name, a ``(name, kwargs)`` tuple, a dict with a
    ``name`` key (remaining keys are kwargs), or a callable.
    """
    if not isinstance(cleaners, (list, tuple)): cleaners = [cleaners]
    fns = []
    for spec in cleaners:
        kwargs = None
        if isinstance(spec, tuple):
            spec, kwargs = spec
        elif isinstance(spec, dict):
            kwargs = {k: v for k, v in spec.items() if k != 'name'}
            spec = spec['name']
        if callable(spec):
            fn = spec
        elif spec in _CLEANERS:
            fn = _CLEANERS[spec]
        else:
            raise ValueError('Unknown cleaner: {}'.format(spec))
        fns.append(partial(fn, ** kwargs) if kwargs else fn)
    return fns


def clean_text(text, cleaners, tokens = {}, ** kwargs):
    """Apply a resolved cleaner pipeline, then map protected tokens."""
    for cleaner in cleaners:
        text = cleaner(text, ** kwargs)
    for cleaned, token in tokens.items():
        text = text.replace(cleaned, token)
    return text
