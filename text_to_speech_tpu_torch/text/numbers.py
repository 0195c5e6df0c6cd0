"""Number verbalization (digits → words) for English and French.

A copy of ``text_to_speech_tpu/text/numbers.py``, kept so that the port
imports nothing of the JAX package: cardinals, ordinals,
decimals, money (£/$/€), clock times, durations, math symbols and large
numbers with thousands separators.
"""

import re
from functools import lru_cache

# -- English cardinals --------------------------------------------------------

_EN_ONES = [
    'zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight',
    'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen',
    'sixteen', 'seventeen', 'eighteen', 'nineteen',
]
_EN_TENS = [
    '', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
    'eighty', 'ninety',
]
_EN_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'), (1000, 'thousand')]

_EN_ORDINAL_IRREG = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _en_below_1000(n):
    if n < 20: return _EN_ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _EN_TENS[tens] + ('-' + _EN_ONES[rem] if rem else '')
    hundreds, rem = divmod(n, 100)
    out = _EN_ONES[hundreds] + ' hundred'
    if rem: out += ' ' + _en_below_1000(rem)
    return out


def _en_cardinal(n):
    if n < 0: return 'minus ' + _en_cardinal(-n)
    if n < 1000: return _en_below_1000(n)
    for scale, word in _EN_SCALES:
        if n >= scale:
            head, rem = divmod(n, scale)
            out = _en_cardinal(head) + ' ' + word
            if rem: out += ' ' + _en_cardinal(rem)
            return out
    return _en_below_1000(n)


def _en_ordinal(n):
    words = _en_cardinal(n)
    head, _, last = words.rpartition(' ')
    pre, _, hyph_last = last.rpartition('-')
    if hyph_last in _EN_ORDINAL_IRREG:
        last_ord = _EN_ORDINAL_IRREG[hyph_last]
    elif hyph_last.endswith('y'):
        last_ord = hyph_last[:-1] + 'ieth'
    else:
        last_ord = hyph_last + 'th'
    if pre: last_ord = pre + '-' + last_ord
    return (head + ' ' + last_ord) if head else last_ord


# -- French cardinals ---------------------------------------------------------

_FR_ONES = [
    'zéro', 'un', 'deux', 'trois', 'quatre', 'cinq', 'six', 'sept', 'huit',
    'neuf', 'dix', 'onze', 'douze', 'treize', 'quatorze', 'quinze', 'seize',
    'dix-sept', 'dix-huit', 'dix-neuf',
]
_FR_TENS = ['', 'dix', 'vingt', 'trente', 'quarante', 'cinquante', 'soixante']


def _fr_below_100(n):
    if n < 20: return _FR_ONES[n]
    if n < 70:
        tens, rem = divmod(n, 10)
        if rem == 0: return _FR_TENS[tens]
        if rem == 1: return _FR_TENS[tens] + ' et un'
        return _FR_TENS[tens] + '-' + _FR_ONES[rem]
    if n < 80:
        if n == 71: return 'soixante et onze'
        return 'soixante-' + _FR_ONES[n - 60]
    if n == 80: return 'quatre-vingts'
    return 'quatre-vingt-' + _FR_ONES[n - 80]


def _fr_below_1000(n):
    if n < 100: return _fr_below_100(n)
    hundreds, rem = divmod(n, 100)
    if hundreds == 1:
        out = 'cent'
    else:
        out = _FR_ONES[hundreds] + ' cent' + ('s' if rem == 0 else '')
    if rem: out += ' ' + _fr_below_100(rem)
    return out


def _fr_cardinal(n):
    if n < 0: return 'moins ' + _fr_cardinal(-n)
    if n < 1000: return _fr_below_1000(n)
    for scale, word, plural in (
        (10 ** 12, 'billion', True), (10 ** 9, 'milliard', True),
        (10 ** 6, 'million', True), (1000, 'mille', False),
    ):
        if n >= scale:
            head, rem = divmod(n, scale)
            if scale == 1000 and head == 1:
                out = 'mille'
            else:
                head_words = _fr_cardinal(head)
                # 'quatre-vingts millions' keeps its s; 'cents' before scale drops it
                if head_words.endswith('cents'): head_words = head_words[:-1]
                out = head_words + ' ' + word + ('s' if plural and head > 1 else '')
            if rem: out += ' ' + _fr_cardinal(rem)
            return out
    return _fr_below_1000(n)


def _fr_ordinal(n):
    if n == 1: return 'premier'
    words = _fr_cardinal(n)
    if words.endswith('et un'): return words[:-5] + 'et unième'
    if words.endswith('un') and n % 10 == 1 and n != 11:
        return words[:-2] + 'unième'
    if words.endswith('e'): words = words[:-1]
    elif words.endswith('cinq'): words += 'u'
    elif words.endswith('neuf'): words = words[:-1] + 'v'
    elif words.endswith('cents') or words.endswith('vingts'): words = words[:-1]
    return words + 'ième'


@lru_cache(maxsize = 4096)
def num2words(number, lang = 'en', ordinal = False, to_year = False):
    """Verbalize `number` (int, float, or numeric str) in `lang` ('en'/'fr'/'be')."""
    if isinstance(number, str):
        number = float(number) if '.' in number else int(number)
    if isinstance(number, float) and number == int(number):
        number = int(number)

    if isinstance(number, float):
        ent = int(number)
        dec_str = repr(number).split('.')[1]
        sep = ' point ' if lang == 'en' else ' virgule '
        return num2words(ent, lang) + sep + ' '.join(
            num2words(int(d), lang) for d in dec_str
        )

    if lang in ('fr', 'be'):
        text = _fr_ordinal(number) if ordinal else _fr_cardinal(number)
        if lang == 'be':
            text = _belgianize(text)
        return text
    return _en_ordinal(number) if ordinal else _en_cardinal(number)


def _belgianize(text):
    """Belgian French: septante / nonante (including ordinal stems like
    'quatre-vingt-onzième' → 'nonante et unième')."""
    ordinal_stems = [
        ('soixante et onzième', 'septante et unième'),
        ('quatre-vingt-onzième', 'nonante et unième'),
        ('soixante-dixième', 'septantième'),
        ('quatre-vingt-dixième', 'nonantième'),
        ('soixante-douzième', 'septante-deuxième'),
        ('soixante-treizième', 'septante-troisième'),
        ('soixante-quatorzième', 'septante-quatrième'),
        ('soixante-quinzième', 'septante-cinquième'),
        ('soixante-seizième', 'septante-sixième'),
        ('soixante-dix-septième', 'septante-septième'),
        ('soixante-dix-huitième', 'septante-huitième'),
        ('soixante-dix-neuvième', 'septante-neuvième'),
        ('quatre-vingt-douzième', 'nonante-deuxième'),
        ('quatre-vingt-treizième', 'nonante-troisième'),
        ('quatre-vingt-quatorzième', 'nonante-quatrième'),
        ('quatre-vingt-quinzième', 'nonante-cinquième'),
        ('quatre-vingt-seizième', 'nonante-sixième'),
        ('quatre-vingt-dix-septième', 'nonante-septième'),
        ('quatre-vingt-dix-huitième', 'nonante-huitième'),
        ('quatre-vingt-dix-neuvième', 'nonante-neuvième'),
    ]
    for old, new in ordinal_stems:
        text = text.replace(old, new)
    replacements = [
        ('soixante et onze', 'septante et un'),
        ('soixante-douze', 'septante-deux'), ('soixante-treize', 'septante-trois'),
        ('soixante-quatorze', 'septante-quatre'), ('soixante-quinze', 'septante-cinq'),
        ('soixante-seize', 'septante-six'), ('soixante-dix-sept', 'septante-sept'),
        ('soixante-dix-huit', 'septante-huit'), ('soixante-dix-neuf', 'septante-neuf'),
        ('soixante-dix', 'septante'),
        ('quatre-vingt-onze', 'nonante et un'), ('quatre-vingt-douze', 'nonante-deux'),
        ('quatre-vingt-treize', 'nonante-trois'), ('quatre-vingt-quatorze', 'nonante-quatre'),
        ('quatre-vingt-quinze', 'nonante-cinq'), ('quatre-vingt-seize', 'nonante-six'),
        ('quatre-vingt-dix-sept', 'nonante-sept'), ('quatre-vingt-dix-huit', 'nonante-huit'),
        ('quatre-vingt-dix-neuf', 'nonante-neuf'), ('quatre-vingt-dix', 'nonante'),
    ]
    for old, new in replacements:
        text = text.replace(old, new)
    return text


# -- text normalization pipeline ----------------------------------------------

_COMMA_NUMBER_RE = re.compile(r'([0-9][0-9,]+[0-9])')
_SPACE_NUMBER_RE = re.compile(r'[0-9]+( [0-9]{3})+(?!\d)')
_POUNDS_RE = re.compile(r'£([0-9,]*[0-9]+)')
_DOLLARS_RE = re.compile(r'\$([0-9.,]*[0-9]+)')
_EUROS_RE = re.compile(r'([0-9.,]*[0-9]+)\s*€|€\s*([0-9.,]*[0-9]+)')
_DECIMAL_RE = re.compile(r'([0-9]+\.[0-9]+)')
_ORDINAL_RE = re.compile(r'([0-9]+)(st|nd|rd|th|er|ère|ème|eme|ième|ieme)\b')
_NUMBER_RE = re.compile(r'[0-9]+')
_CLOCK_RE = re.compile(r'\b(\d{1,2}):(\d{2})(?::(\d{2}))?\b')
_DURATION_RE = re.compile(r'\b(\d+)\s*(h|min|sec|s)\b(?:\s*(\d+)\s*(min|sec|s)\b)?(?:\s*(\d+)\s*(sec|s)\b)?')
_MATH_RE = re.compile(r'(?<=[\d\s])([+*/^=])(?=[\d\s])')

_TIME_WORDS = {
    'h': {'en': 'hour', 'fr': 'heure'},
    'min': {'en': 'minute', 'fr': 'minute'},
    's': {'en': 'second', 'fr': 'seconde'},
    'sec': {'en': 'second', 'fr': 'seconde'},
}
_TIME_SEP = {'en': ' and ', 'fr': ' et '}
_MATH_WORDS = {
    '=': {'en': 'equal', 'fr': 'égal'},
    '+': {'en': 'plus', 'fr': 'plus'},
    '-': {'en': 'minus', 'fr': 'moins'},
    '*': {'en': 'times', 'fr': 'fois'},
    '/': {'en': 'divided by', 'fr': 'divisé par'},
    '^': {'en': 'to the power', 'fr': 'exposant'},
}

# physical units: number + optional SI prefix + unit (+ optional /time)
_UNITS = {
    'g': {'en': 'gram', 'fr': 'gramme'},
    't': {'en': 'ton', 'fr': 'tonne'},
    'm': {'en': 'meter', 'fr': 'mètre'},
    'mi': {'en': 'mile', 'fr': 'mile'},
    'l': {'en': 'liter', 'fr': 'litre'},
    'o': {'en': 'octet', 'fr': 'octet'},
    'b': {'en': 'bit', 'fr': 'bit'},
    'V': {'en': 'volt', 'fr': 'volt'},
    'W': {'en': 'watt', 'fr': 'watt'},
    'A': {'en': 'ampere', 'fr': 'ampère'},
    'Hz': {'en': 'hertz', 'fr': 'hertz'},
    'N': {'en': 'newton', 'fr': 'newton'},
    'J': {'en': 'joule', 'fr': 'joule'},
}
_SI_PREFIXES = {
    'n': 'nano', 'c': 'centi', 'd': 'deci', 'k': 'kilo',
    'M': 'mega', 'G': 'giga', 'T': 'tera',
}
_SI_PREFIXES_FR = {** _SI_PREFIXES, 'c': 'centi', 'd': 'déci', 'M': 'méga'}
_MILLI = {'en': 'mili', 'fr': 'mili'}

_UNITS_RE = re.compile(
    r'\b(\d+)\s*([ncdkMGT]|m(?=m))?({})(?:/(h|min|s(?:ec)?))?(?![\w])'.format(
        '|'.join(sorted(_UNITS, key = len, reverse = True))
    )
)
_PER_WORD = {'en': 'per', 'fr': 'par'}
_UNARY_MINUS_RE = re.compile(r'(^|[\s(])-\s*(?=\d)')
_SPACED_MINUS_RE = re.compile(r'(?<=[\d\s])- (?=\d)|(?<=\d) - (?=\d)')


def _expand_units(m, lang):
    n, prefix, unit, per_time = m.group(1), m.group(2), m.group(3), m.group(4)
    value = int(n)
    prefixes = _SI_PREFIXES_FR if lang == 'fr' else _SI_PREFIXES
    prefix_word = (_MILLI[lang] if prefix == 'm' else prefixes.get(prefix, '')) \
        if prefix else ''
    word = prefix_word + _UNITS[unit][lang]
    if value != 1 and not word.endswith(('s', 'z')): word += 's'
    out = '{} {}'.format(n, word)
    if per_time:
        time_word = {'h': {'en': 'hour', 'fr': 'heure'},
                     'min': {'en': 'minute', 'fr': 'minute'},
                     's': {'en': 'second', 'fr': 'seconde'},
                     'sec': {'en': 'second', 'fr': 'seconde'}}[per_time][lang]
        out += ' {} {}'.format(_PER_WORD[lang], time_word)
    return out


def _norm_lang(lang):
    return 'fr' if lang == 'be' else lang


def _expand_money(amount_str, unit, cent_unit, lang):
    amount_str = amount_str.replace(',', '')
    parts = amount_str.split('.')
    if len(parts) > 2: return amount_str + ' ' + unit + 's'
    whole = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    out = []
    if whole or not cents:
        out.append('{} {}{}'.format(whole, unit, 's' if whole != 1 else ''))
    if cents:
        out.append('{} {}{}'.format(cents, cent_unit, 's' if cents != 1 else ''))
    return ', '.join(out)


def _expand_clock(m, lang):
    h, mi, s = m.group(1), m.group(2), m.group(3)
    parts = []
    for value, unit in ((h, 'h'), (mi, 'min'), (s, 's')):
        if value is None: continue
        v = int(value)
        word = _TIME_WORDS[unit][lang]
        if v > 1: word += 's'
        num = 'une' if (v == 1 and lang == 'fr' and unit in ('h', 'min', 's')) else str(v)
        parts.append('{} {}'.format(num, word))
    return _TIME_SEP[lang].join(parts)


def _expand_duration(m, lang):
    pairs = [(m.group(1), m.group(2)), (m.group(3), m.group(4)), (m.group(5), m.group(6))]
    parts = []
    for value, unit in pairs:
        if value is None: continue
        v = int(value)
        word = _TIME_WORDS[unit][lang]
        if v > 1: word += 's'
        num = 'une' if (v == 1 and lang == 'fr') else str(v)
        parts.append('{} {}'.format(num, word))
    return _TIME_SEP[lang].join(parts)


def _expand_decimal(m, lang):
    ent, dec = m.group(1).split('.')
    sep = 'point' if lang == 'en' else 'virgule'
    dec_words = ' '.join(num2words(int(d), lang) for d in dec)
    return '{} {} {}'.format(num2words(int(ent), lang), sep, dec_words)


def normalize_numbers(text, lang = 'en', expand_symbols = True, ** kwargs):
    """Expand every numeric pattern of `text` into words."""
    num_lang = lang             # 'be' keeps septante/nonante through num2words
    lang = _norm_lang(lang)     # word tables only have 'en' / 'fr' entries

    if expand_symbols:
        text = _UNITS_RE.sub(lambda m: _expand_units(m, lang), text)

    text = _DURATION_RE.sub(lambda m: _expand_duration(m, lang), text)
    text = _CLOCK_RE.sub(lambda m: _expand_clock(m, lang), text)

    if expand_symbols:
        text = _MATH_RE.sub(lambda m: ' ' + _MATH_WORDS[m.group(1)][lang] + ' ', text)
        minus = ' ' + _MATH_WORDS['-'][lang] + ' '
        text = _SPACED_MINUS_RE.sub(minus, text)        # '1 - 1' → minus
        text = _UNARY_MINUS_RE.sub(r'\1' + minus.lstrip(), text)  # '-1' → minus 1

    # thousands separators: "3,000,000" -> "3000000" (en) ; "3,14" -> "3.14" (fr)
    def _commas(m):
        s = m.group(1)
        if lang == 'fr' and s.count(',') == 1:
            return s.replace(',', '.')
        return s.replace(',', '')
    text = _COMMA_NUMBER_RE.sub(_commas, text)
    text = _SPACE_NUMBER_RE.sub(lambda m: m.group(0).replace(' ', ''), text)

    text = _POUNDS_RE.sub(lambda m: _expand_money(m.group(1), 'pound', 'penny', lang), text)
    text = _DOLLARS_RE.sub(lambda m: _expand_money(m.group(1), 'dollar', 'cent', lang), text)
    text = _EUROS_RE.sub(
        lambda m: _expand_money(m.group(1) or m.group(2), 'euro', 'centime' if lang == 'fr' else 'cent', lang),
        text,
    )

    text = _DECIMAL_RE.sub(lambda m: _expand_decimal(m, num_lang), text)
    text = _ORDINAL_RE.sub(lambda m: num2words(int(m.group(1)), num_lang, ordinal = True), text)
    text = _NUMBER_RE.sub(lambda m: num2words(int(m.group(0)), num_lang), text)
    return text
