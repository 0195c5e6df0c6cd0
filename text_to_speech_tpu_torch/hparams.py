"""Namespaced hyper-parameter containers.

A copy of ``text_to_speech_tpu/hparams.py``, kept so that the port imports
nothing of the JAX package: dict-like access, prefix
namespacing (``get_config(prefix=...)``, ``add_prefix``), ``extract`` of known
keys from kwargs, and ``+`` merge with conflict detection.
"""

import logging

logger = logging.getLogger(__name__)


class HParams:
    """A mutable, dict-like hyper-parameter container.

    Supports attribute and item access, prefix-namespaced composition so that
    sub-module configs can be embedded in a parent config
    (e.g. ``encoder_vocab_size``), and extraction back out by prefix.
    """

    def __init__(self, _prefix = None, ** kwargs):
        object.__setattr__(self, '_prefix', _prefix)
        object.__setattr__(self, '_config', {})
        self.update(kwargs)

    # -- core mapping protocol -------------------------------------------------

    @property
    def config(self):
        return self._config

    def __len__(self):
        return len(self._config)

    def __iter__(self):
        return iter(self._config)

    def __contains__(self, key):
        return self._normalize_key(key) in self._config

    def __getitem__(self, key):
        return self._config[self._normalize_key(key)]

    def __setitem__(self, key, value):
        self._config[self._normalize_key(key)] = value

    def __getattr__(self, key):
        if key.startswith('_'):
            raise AttributeError(key)
        try:
            return self._config[self._normalize_key(key)]
        except KeyError:
            raise AttributeError('Unknown hyper-parameter: {}'.format(key))

    def __setattr__(self, key, value):
        if key.startswith('_'):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __eq__(self, other):
        if isinstance(other, HParams): other = other._config
        return isinstance(other, dict) and other == self._config

    def __repr__(self):
        return 'HParams({})'.format(
            ', '.join('{}={!r}'.format(k, v) for k, v in self._config.items())
        )

    def _normalize_key(self, key):
        if self._prefix and not key.startswith(self._prefix + '_') and key in self._config:
            return key
        if self._prefix:
            prefixed = key if key.startswith(self._prefix + '_') else '{}_{}'.format(self._prefix, key)
            if prefixed in self._config: return prefixed
        return key

    # -- composition -----------------------------------------------------------

    def update(self, other):
        if isinstance(other, HParams): other = other._config
        for k, v in other.items():
            self[k] = v
        return self

    def __add__(self, other):
        """Merge two configs; conflicting values keep `other`'s with a warning."""
        other_cfg = other._config if isinstance(other, HParams) else dict(other)
        merged = dict(self._config)
        for k, v in other_cfg.items():
            if k in merged and merged[k] != v:
                logger.warning('HParams conflict on %s: %r -> %r', k, merged[k], v)
            merged[k] = v
        return HParams(** merged)

    def __call__(self, ** kwargs):
        """Return a copy updated with `kwargs`; unknown keys are accepted."""
        new = HParams(** self._config)
        new.update(kwargs)
        return new

    def copy(self):
        return HParams(** self._config)

    # -- namespacing -----------------------------------------------------------

    def get_config(self, prefix = None, add_prefix = None, with_prefix = False):
        """Return a plain dict view.

        - ``prefix='enc'``: select keys starting with ``enc_`` and strip it
          (unless ``with_prefix``).
        - ``add_prefix='enc'``: return all keys with ``enc_`` prepended.
        """
        if add_prefix:
            return {'{}_{}'.format(add_prefix, k): v for k, v in self._config.items()}
        if prefix is None:
            return dict(self._config)
        p = prefix + '_'
        out = {}
        for k, v in self._config.items():
            if k.startswith(p):
                out[k if with_prefix else k[len(p):]] = v
        return out

    def extract(self, kwargs, pop = False, add_unknown = False):
        """Build a new HParams from this template, overridden by matching
        entries of `kwargs`.  With ``pop=True``, consumed keys are removed
        from `kwargs`."""
        new = self.copy()
        taken = []
        for k in list(kwargs.keys()):
            if k in new._config or add_unknown:
                new[k] = kwargs[k]
                taken.append(k)
        if pop:
            for k in taken:
                kwargs.pop(k)
        return new

    def setdefault(self, key, value):
        if key not in self:
            self[key] = value
        return self[key]

    def get(self, key, default = None):
        return self._config.get(self._normalize_key(key), default)

    def items(self):
        return self._config.items()

    def keys(self):
        return self._config.keys()

    def values(self):
        return self._config.values()
