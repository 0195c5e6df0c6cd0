"""Input pipeline over in-memory rows: map, filter, cache, shuffle, length
buckets, batch and collate.

Counterpart of the parts of ``text_to_speech_tpu/train/datasets.py`` that
`fit` needs: `train_test_split` of a list of rows (the same split for the
same seed), `prepare_dataset` with its row filter (`filter_fn`, on the
mapped items), and `GE2EDataset`, whose batches are the JAX package's row
for row (the same `random.Random(seed + epoch)` draws).  Shuffling a
`Dataset` draws from a numpy generator seeded with ``seed + epoch``.  The
disk cache (`FileCacheDataset`), the native loader pool, the prefetch
thread, DataFrame, column and file sources and the split by speaker are
not ported.
"""

import logging
import math
import random

import numpy as np

logger = logging.getLogger(__name__)


def train_test_split(data, *, valid_size = 0.1, shuffle = True, random_state = 0):
    """Split rows into (train, valid): `valid_size` is a share of the rows
    below 1, a count from 1."""
    rows = list(data)
    rng = random.Random(random_state)
    idx = list(range(len(rows)))
    if shuffle: rng.shuffle(idx)
    n_valid = int(len(rows) * valid_size) if valid_size < 1 else int(valid_size)
    valid_idx = set(idx[:n_valid])
    return [rows[i] for i in idx[n_valid:]], [rows[i] for i in sorted(valid_idx)]


class Dataset:
    """Rows → batches, in the order map → cache → shuffle → length buckets →
    batch (+ collate).  The mapped rows are cached at the first epoch."""

    def __init__(self, rows, *, map_fn = None, filter_fn = None, shuffle = False,
                 batch_size = 1, collate_fn = None, seed = 0, length_bucket_fn = None):
        self.rows = list(rows)
        self.map_fn = map_fn
        self.filter_fn = filter_fn
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.seed = seed
        self.length_bucket_fn = length_bucket_fn
        self._cached = None
        self._epoch = 0

    def _materialize(self):
        if self._cached is not None:
            return self._cached
        out = []
        for row in self.rows:
            try:
                item = self.map_fn(row) if self.map_fn else row
            except Exception:
                logger.exception('map_fn failed on a row; skipping it')
                continue
            if self.filter_fn and not self.filter_fn(
                    * item if isinstance(item, tuple) else (item,)):
                continue
            out.append(item)
        self._cached = out
        return out

    def __len__(self):
        return math.ceil(len(self._materialize()) / self.batch_size)

    def __iter__(self):
        items = self._materialize()
        order = list(range(len(items)))
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(len(items)).tolist()
        self._epoch += 1
        if self.length_bucket_fn is not None:
            # similar lengths together, less padding (a stable sort: the
            # shuffle still orders equal lengths)
            order.sort(key = lambda i: self.length_bucket_fn(items[i]))
        for start in range(0, len(order), self.batch_size):
            chunk = [items[i] for i in order[start: start + self.batch_size]]
            yield self.collate_fn(chunk) if self.collate_fn else chunk


def prepare_dataset(data, *, prepare_fn = None, filter_fn = None, collate_fn = None,
                    batch_size = 16, shuffle = True, length_bucket_fn = None, seed = 0):
    """A `Dataset` in the standard stage order."""
    return Dataset(data, map_fn = prepare_fn, filter_fn = filter_fn, shuffle = shuffle,
                   batch_size = batch_size, collate_fn = collate_fn,
                   length_bucket_fn = length_bucket_fn, seed = seed)


class GE2EDataset:
    """Batches for GE2E speaker-verification training: each is `n_speakers`
    groups of `n_utterances` rows of one speaker, drawn without replacement
    by ``random.Random(seed + epoch)`` (the speakers shuffled, then each
    group sampled), as the JAX package draws them."""

    def __init__(self, rows, *, speaker_column = 'speaker', n_speakers = 4,
                 n_utterances = 4, map_fn = None, collate_fn = None, seed = 0):
        self.rows = list(rows)
        self.map_fn = map_fn
        self.collate_fn = collate_fn
        self.n_speakers = n_speakers
        self.n_utterances = n_utterances
        self.seed = seed
        self._epoch = 0
        self.by_speaker = {}
        for row in self.rows:
            self.by_speaker.setdefault(row[speaker_column], []).append(row)
        self.speakers = [s for s, items in self.by_speaker.items()
                         if len(items) >= n_utterances]
        if len(self.speakers) < n_speakers:
            raise ValueError('Need >= {} speakers with >= {} utterances'.format(
                n_speakers, n_utterances))

    def __len__(self):
        return max(1, len(self.speakers) // self.n_speakers)

    def __iter__(self):
        rng = random.Random(self.seed + self._epoch)
        self._epoch += 1
        speakers = list(self.speakers)
        rng.shuffle(speakers)
        for start in range(0, len(speakers) - self.n_speakers + 1, self.n_speakers):
            batch = []
            for spk in speakers[start: start + self.n_speakers]:
                rows = rng.sample(self.by_speaker[spk], self.n_utterances)
                batch.append([self.map_fn(r) if self.map_fn else r for r in rows])
            yield self.collate_fn(batch) if self.collate_fn else batch
