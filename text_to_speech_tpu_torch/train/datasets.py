"""Input pipeline: map, filter, cache, shuffle, length buckets, batch and
collate, with a prefetch thread.

Counterpart of ``text_to_speech_tpu/train/datasets.py``:

  - `as_rows`: a list, a dict of columns, a DataFrame (by duck typing; the
    port does not import pandas) or a csv / tsv file (read with `csv`, every
    value a string) → a list of rows;
  - `train_test_split`, by rows or, with `split_column`, by the unique
    values of a column (a speaker never on both sides): the JAX package's
    split for the same seed;
  - `Dataset`: map → filter → cache → shuffle → length buckets → batch
    (+ collate) → prefetch, the JAX package's batches for the same seed
    (``random.Random(seed + epoch)``); `num_parallel_calls` maps on a
    thread pool; `native_audio_rate` decodes the rows' WAV files on the
    native loader pool first (`native.data_loader`), and ``native_rows``
    counts the rows it decoded;
  - `FileCacheDataset`: one ``.npz`` per mapped row, read back at later
    epochs instead of mapping again;
  - `GE2EDataset`, the GE2E speaker batches, row for row the JAX package's.

Where the JAX package's prefetch thread loses an error of the map or
collate functions (its consumer sees a short epoch), the port raises it in
the consumer.  `FileCacheDataset` decodes the rows it maps natively when
given `native_audio_rate`; the JAX package's ignores it.
"""

import csv
import logging
import math
import os
import queue
import random
import threading

import numpy as np

logger = logging.getLogger(__name__)


def _read_table(filename):
    with open(filename, newline = '', encoding = 'utf-8') as f:
        return list(csv.DictReader(f, delimiter = '\t' if filename.endswith('.tsv') else ','))


def as_rows(data):
    """A data source → a list of rows: a list or tuple, a DataFrame (its
    records), a dict of columns, or a csv / tsv filename."""
    if isinstance(data, str) and os.path.isfile(data):
        return _read_table(data)
    if hasattr(data, 'to_dict') and hasattr(data, 'columns'):      # a DataFrame
        return data.to_dict('records')
    if isinstance(data, dict):
        keys = list(data)
        n = len(data[keys[0]])
        return [{k: data[k][i] for k in keys} for i in range(n)]
    return list(data)


def train_test_split(data, *, valid_size = 0.1, shuffle = True, random_state = 0,
                     split_column = None):
    """Split rows into (train, valid): `valid_size` is a share below 1, a
    count from 1.  With `split_column` (e.g. 'speaker') the column's unique
    values are split, so that no value is on both sides."""
    rows = as_rows(data)
    rng = random.Random(random_state)
    if split_column is not None:
        values = sorted({r[split_column] for r in rows})
        if shuffle: rng.shuffle(values)
        n_valid = max(1, int(len(values) * valid_size)) if valid_size < 1 else int(valid_size)
        valid_values = set(values[:n_valid])
        return ([r for r in rows if r[split_column] not in valid_values],
                [r for r in rows if r[split_column] in valid_values])
    idx = list(range(len(rows)))
    if shuffle: rng.shuffle(idx)
    n_valid = int(len(rows) * valid_size) if valid_size < 1 else int(valid_size)
    valid_idx = set(idx[:n_valid])
    return [rows[i] for i in idx[n_valid:]], [rows[i] for i in sorted(valid_idx)]


class Dataset:
    """Rows → batches, in the order map → filter → cache → shuffle → length
    buckets → batch (+ collate) → prefetch.

    `cache` keeps the mapped items after the first epoch; `prefetch` batches
    are made ahead on a producer thread (0: inline); `length_bucket_fn`
    sorts the (shuffled) items by length before batching, a stable sort;
    `num_parallel_calls` threads run `map_fn`, in order; with
    `native_audio_rate` the WAV rows are decoded and resampled to it on the
    native loader pool before the map."""

    def __init__(self, rows, *, map_fn = None, filter_fn = None, cache = True,
                 shuffle = False, batch_size = 1, collate_fn = None, drop_remainder = False,
                 prefetch = 2, seed = 0, length_bucket_fn = None, num_parallel_calls = None,
                 native_audio_rate = None):
        self.rows = as_rows(rows)
        self.map_fn = map_fn
        self.filter_fn = filter_fn
        self.cache = cache
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.seed = seed
        self.length_bucket_fn = length_bucket_fn
        self.num_parallel_calls = num_parallel_calls
        self.native_audio_rate = native_audio_rate
        self.native_rows = 0
        self._cached = None
        self._epoch = 0

    def _native_preload(self, rows):
        """The rows with the audio of their WAV files decoded on the native
        loader pool (``'audio'`` and ``'rate'`` added), so that `map_fn`
        reads no file; rows the pool refuses keep their filename."""
        from ..native import data_loader
        if not data_loader.available():
            return rows
        idx = [i for i, r in enumerate(rows)
               if isinstance(r, dict) and 'audio' not in r
               and str(r.get('filename', '')).lower().endswith('.wav')]
        if not idx:
            return rows
        decoded = data_loader.load_audio_batch(
            [rows[i]['filename'] for i in idx], target_rate = self.native_audio_rate,
            n_workers = self.num_parallel_calls or 2)
        self.native_rows += decoded.native_rows
        rows = list(rows)
        for i, (audio, rate) in zip(idx, decoded):
            rows[i] = dict(rows[i], audio = audio, rate = rate)
        return rows

    def _map_one(self, row):
        try:
            return True, (self.map_fn(row) if self.map_fn else row)
        except Exception:
            logger.exception('map_fn failed on a row; skipping it')
            return False, None

    def _keep(self, item):
        return not self.filter_fn or self.filter_fn(
            * item if isinstance(item, tuple) else (item,))

    def _materialize(self):
        if self._cached is not None:
            return self._cached
        rows = list(self.rows)
        if self.native_audio_rate:
            rows = self._native_preload(rows)
        n_workers = self.num_parallel_calls or 1
        if self.map_fn is not None and n_workers > 1 and len(rows) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(n_workers, len(rows))) as pool:
                mapped = list(pool.map(self._map_one, rows))
        else:
            mapped = [self._map_one(row) for row in rows]
        out = [item for ok, item in mapped if ok and self._keep(item)]
        if self.cache:
            self._cached = out
        return out

    def __len__(self):
        n = len(self._materialize()) / self.batch_size
        return int(n) if self.drop_remainder else math.ceil(n)

    def _batches(self):
        items = self._materialize()
        order = list(range(len(items)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        if self.length_bucket_fn is not None:
            order.sort(key = lambda i: self.length_bucket_fn(items[i]))
        for start in range(0, len(order), self.batch_size):
            chunk = [items[i] for i in order[start: start + self.batch_size]]
            if self.drop_remainder and len(chunk) < self.batch_size:
                return
            yield self.collate_fn(chunk) if self.collate_fn else chunk

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return
        buf = queue.Queue(maxsize = self.prefetch)
        stop = threading.Event()
        done = object()
        failure = []

        def put(item):
            # give up when the consumer has gone, instead of blocking forever
            while not stop.is_set():
                try:
                    buf.put(item, timeout = 0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except BaseException as err:       # raised again in the consumer
                failure.append(err)
            put(done)

        thread = threading.Thread(target = producer, daemon = True, name = 'dataset-prefetch')
        thread.start()
        try:
            while True:
                item = buf.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            thread.join()
        if failure:
            raise failure[0]


def prepare_dataset(data, *, prepare_fn = None, filter_fn = None, collate_fn = None,
                    batch_size = 16, shuffle = True, cache = True, prefetch = 2,
                    length_bucket_fn = None, ** kwargs):
    """A `Dataset` in the standard stage order; `kwargs` go to it."""
    return Dataset(data, map_fn = prepare_fn, filter_fn = filter_fn, cache = cache,
                   shuffle = shuffle, batch_size = batch_size, collate_fn = collate_fn,
                   prefetch = prefetch, length_bucket_fn = length_bucket_fn, ** kwargs)


class FileCacheDataset(Dataset):
    """A `Dataset` whose mapped items are cached on disk, one ``.npz`` per
    row under `cache_dir` (named by ``cache_key_fn(index, row)``): a row
    whose file exists is read back (a pickled object array: tuples of
    arrays come back as they went in) and not mapped again.  Only rows that
    are mapped are decoded natively."""

    def __init__(self, rows, cache_dir, *, cache_key_fn = None, ** kwargs):
        super().__init__(rows, ** kwargs)
        self.cache_dir = cache_dir
        self.cache_key_fn = cache_key_fn or (lambda i, row: 'item-{}.npz'.format(i))
        os.makedirs(cache_dir, exist_ok = True)

    def _materialize(self):
        if self._cached is not None:
            return self._cached
        paths = [os.path.join(self.cache_dir, self.cache_key_fn(i, row))
                 for i, row in enumerate(self.rows)]
        missing = [i for i, path in enumerate(paths) if not os.path.exists(path)]
        rows = list(self.rows)
        if missing and self.native_audio_rate:
            for i, row in zip(missing, self._native_preload([rows[i] for i in missing])):
                rows[i] = row
        out = []
        for row, path in zip(rows, paths):
            if os.path.exists(path):
                with np.load(path, allow_pickle = True) as data:
                    item = data['item']
                    item = item.item() if item.dtype == object else item
                out.append(item)
                continue
            ok, item = self._map_one(row)
            if not ok or not self._keep(item):
                continue
            np.savez(path, item = _object_array(item))
            out.append(item)
        if self.cache:
            self._cached = out
        return out


def _object_array(item):
    """`item` as a 0-d object array, however its parts' shapes line up."""
    array = np.empty((), dtype = object)
    array[()] = item
    return array


class GE2EDataset:
    """Batches for GE2E speaker-verification training: each is `n_speakers`
    groups of `n_utterances` rows of one speaker, drawn without replacement
    by ``random.Random(seed + epoch)`` (the speakers shuffled, then each
    group sampled), as the JAX package draws them."""

    def __init__(self, rows, *, speaker_column = 'speaker', n_speakers = 4,
                 n_utterances = 4, map_fn = None, collate_fn = None, seed = 0):
        self.rows = as_rows(rows)
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
