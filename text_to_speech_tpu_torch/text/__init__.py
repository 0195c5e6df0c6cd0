"""Text front end: symbol sets, the char tokenizer, cleaners, chunking.

The `get_symbols` / `default_english_tokenizer` / `get_tokenizer` part of
``text_to_speech_tpu/text/__init__.py``, with the same symbol tables.
`get_tokenizer` resolves a `Tokenizer`, a saved ``.json``, ``'en'`` or a
config dict (a bare `lang` gives the JAX package's default for it: the
language's symbols without ARPAbet and its cleaners); the French symbol
set and the pretrained subword tokenizers are not ported.
"""

from .cleaners import get_cleaners_fn, clean_text, english_cleaners
from .processing import split_text, split_sentences
from .tokenizer import Tokenizer

_pad = '_'
_punctuation = '!\'(),.:;? '
_special = '-'
_letters = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz'
_accents = 'éèêîçô'
_numbers = '0123456789'
_maths = '+*/%'

_mini_punctuation = ' \',.?!'

# ARPAbet phoneme symbols, prefixed with '@' for uniqueness with letters.
_cmudict_symbols = [
    'AA', 'AA0', 'AA1', 'AA2', 'AE', 'AE0', 'AE1', 'AE2', 'AH', 'AH0', 'AH1',
    'AH2', 'AO', 'AO0', 'AO1', 'AO2', 'AW', 'AW0', 'AW1', 'AW2', 'AY', 'AY0',
    'AY1', 'AY2', 'B', 'CH', 'D', 'DH', 'EH', 'EH0', 'EH1', 'EH2', 'ER',
    'ER0', 'ER1', 'ER2', 'EY', 'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH',
    'IH0', 'IH1', 'IH2', 'IY', 'IY0', 'IY1', 'IY2', 'JH', 'K', 'L', 'M', 'N',
    'NG', 'OW', 'OW0', 'OW1', 'OW2', 'OY', 'OY0', 'OY1', 'OY2', 'P', 'R',
    'S', 'SH', 'T', 'TH', 'UH', 'UH0', 'UH1', 'UH2', 'UW', 'UW0', 'UW1',
    'UW2', 'V', 'W', 'Y', 'Z', 'ZH',
]
_arpabet = ['@' + s for s in _cmudict_symbols]

en_symbols = [_pad] + list(_special) + list(_punctuation) + list(_letters) + _arpabet


def get_symbols(lang,
                punctuation = 1,
                maj = True,
                arpabet = True,
                accents = True,
                numbers = False,
                maths = False
               ):
    symbols = [_pad] + list(_special)
    if punctuation:
        symbols += list(_punctuation) if punctuation == 1 else list(_mini_punctuation)
    else:
        symbols += [' ']
    symbols += list(_letters) if maj else [c for c in _letters if c.islower()]
    if lang == 'en' and arpabet: symbols += _arpabet
    if lang in ('fr', 'be', 'multi') and accents: symbols += list(_accents)
    if numbers: symbols += list(_numbers)
    if maths: symbols += list(_maths)
    return symbols


_default_cleaners = {
    'en': 'english_cleaners',
    'fr': 'french_cleaners',
    'be': 'belgian_cleaners',
    'multi': 'french_cleaners',
}


def default_english_tokenizer(cleaners = ('english_cleaners',), ** kwargs):
    return Tokenizer(en_symbols, level = 'char', cleaners = list(cleaners), ** kwargs)


def get_tokenizer(tokenizer = None, lang = None, ** kwargs):
    """A `Tokenizer` from a `Tokenizer`, a ``.json`` file, ``'en'``, a config
    dict, or None with a `lang` (the JAX package's `get_tokenizer`)."""
    import os

    if tokenizer is None: tokenizer = kwargs or {}
    if isinstance(tokenizer, Tokenizer):
        return tokenizer
    if isinstance(tokenizer, str):
        if os.path.isfile(tokenizer):
            return Tokenizer.load_from_file(tokenizer)
        if tokenizer in ('en', 'english'):
            return default_english_tokenizer(** kwargs)
        raise ValueError('tokenizer {!r} is not ported'.format(tokenizer))
    if isinstance(tokenizer, dict):
        tokenizer = dict(tokenizer)
        if 'vocab' not in tokenizer:
            if not lang:
                raise ValueError('Provide either `vocab` or `lang`')
            tokenizer['vocab'] = get_symbols(lang, arpabet = False)
            tokenizer['level'] = 'char'
        tokenizer.setdefault('level', 'char')
        tokenizer.setdefault('use_sos_and_eos', False)
        tokenizer.setdefault('cleaners', [_default_cleaners.get(lang, 'basic_cleaners')])
        return Tokenizer(** tokenizer)
    raise ValueError('Unsupported tokenizer spec: {!r}'.format(tokenizer))
