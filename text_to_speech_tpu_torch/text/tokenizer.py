"""Character-level text tokenizer with a cleaner pipeline.

The char-level part of ``text_to_speech_tpu/text/tokenizer.py``, copied so
that the port imports nothing of the JAX package.  It reads and writes the
same ``tokenizer.json`` files; other levels (byte, BPE, word) are not ported.
"""

import json

import numpy as np

from ..utils.file_utils import dump_json
from .cleaners import get_cleaners_fn, clean_text


class Tokenizer:
    def __init__(self,
                 vocab,
                 level = 'char',
                 *,
                 cleaners = (),
                 sos_token = None,
                 eos_token = None,
                 blank_token = None,
                 ukn_token = None,
                 sep_token = None,
                 mask_token = None,
                 use_sos_and_eos = False,
                 ** _
                ):
        if level != 'char':
            raise NotImplementedError(
                'only the char-level tokenizer is ported, got {!r}'.format(level))
        self.level = level
        self.vocab = list(vocab)
        self.cleaners = cleaners if isinstance(cleaners, (list, tuple)) else [cleaners]
        self.cleaners_fn = get_cleaners_fn(self.cleaners)

        self.sos_token = sos_token
        self.eos_token = eos_token
        self.blank_token = blank_token if blank_token is not None else (
            self.vocab[0] if self.vocab else None
        )
        self.ukn_token = ukn_token
        self.sep_token = sep_token
        self.mask_token = mask_token
        self.use_sos_and_eos = use_sos_and_eos
        self._token_to_idx = {tok: i for i, tok in enumerate(self.vocab)}

    @property
    def vocab_size(self):
        return len(self.vocab)

    def token_idx(self, token):
        return self._token_to_idx.get(token, None)

    @property
    def blank_token_idx(self):
        idx = self.token_idx(self.blank_token)
        return idx if idx is not None else 0

    def __len__(self):
        return self.vocab_size

    def clean_text(self, text, ** kwargs):
        return clean_text(text, self.cleaners_fn, ** kwargs)

    def encode(self, text, *, cleaned = False, ** kwargs):
        """Clean then map `text` to an int32 numpy array of token ids.

        Unknown characters map to `ukn_token` when set, otherwise are
        dropped."""
        if not cleaned:
            text = self.clean_text(text, ** kwargs)
        ukn_idx = self.token_idx(self.ukn_token)
        ids = []
        for unit in text:
            idx = self._token_to_idx.get(unit, ukn_idx)
            if idx is not None:
                ids.append(idx)
        if self.use_sos_and_eos:
            if self.token_idx(self.sos_token) is not None:
                ids.insert(0, self.token_idx(self.sos_token))
            if self.token_idx(self.eos_token) is not None:
                ids.append(self.token_idx(self.eos_token))
        return np.asarray(ids, dtype = np.int32)

    __call__ = encode

    def get_config(self):
        """The ``tokenizer.json`` content, as the JAX package writes it."""
        return {
            'vocab': self.vocab,
            'level': self.level,
            'cleaners': [c for c in self.cleaners if isinstance(c, (str, dict))]
                        or list(self.cleaners),
            'sos_token': self.sos_token,
            'eos_token': self.eos_token,
            'blank_token': self.blank_token,
            'ukn_token': self.ukn_token,
            'sep_token': self.sep_token,
            'mask_token': self.mask_token,
            'use_sos_and_eos': self.use_sos_and_eos,
        }

    def save(self, filename):
        if not filename.endswith('.json'): filename += '.json'
        return dump_json(filename, self.get_config(), indent = 2)

    @classmethod
    def load_from_file(cls, filename):
        with open(filename, encoding = 'utf-8') as file:
            config = json.load(file)
        config['cleaners'] = [c for c in config.get('cleaners', [])
                              if isinstance(c, (str, dict, list))]
        return cls(** config)
