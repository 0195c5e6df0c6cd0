"""Input pipeline over in-memory rows: map, filter, cache, shuffle, length
buckets, batch and collate.

Counterpart of the parts of ``text_to_speech_tpu/train/datasets.py`` that
`fit` needs: `train_test_split` of a list of rows (the same split for the
same seed) and `prepare_dataset`.  Shuffling draws from a numpy generator seeded with
``seed + epoch``.  The disk cache (`FileCacheDataset`), the native loader
pool, the prefetch thread, DataFrame, column and file sources, the split by
speaker, row filters and `GE2EDataset` are not ported.
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

    def __init__(self, rows, *, map_fn = None, shuffle = False, batch_size = 1,
                 collate_fn = None, seed = 0, length_bucket_fn = None):
        self.rows = list(rows)
        self.map_fn = map_fn
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


def prepare_dataset(data, *, prepare_fn = None, collate_fn = None, batch_size = 16,
                    shuffle = True, length_bucket_fn = None, seed = 0):
    """A `Dataset` in the standard stage order."""
    return Dataset(data, map_fn = prepare_fn, shuffle = shuffle, batch_size = batch_size,
                   collate_fn = collate_fn, length_bucket_fn = length_bucket_fn, seed = seed)
