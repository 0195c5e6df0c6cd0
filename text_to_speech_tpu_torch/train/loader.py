"""Named corpora: the dataset directory, task tags, loading one or several
corpora by name, summaries and pipeline timing.

Counterpart of ``text_to_speech_tpu/train/loader.py``, without pandas: a
corpus is a list of row dicts (`train.audio_datasets`), several are
concatenated with each row tagged by its corpus under ``dataset``, and
`summarize_dataset` counts values itself.  The dataset directory is
``$DATASET_DIR`` or ``/storage``, as in the JAX package, until
`set_dataset_dir`.
"""

import enum
import logging
import os
import time

import numpy as np

from .audio_datasets import _DATASETS, list_datasets
from .datasets import prepare_dataset

logger = logging.getLogger(__name__)

_dataset_dir = os.environ.get('DATASET_DIR', '/storage')

#: task tag → [dataset names]
_TASKS = {}
#: cleaned name → {'directory': ..., 'task': ...}
_DATASET_INFOS = {}


class Task(enum.Enum):
    TTS = 'Text To Speech'
    STT = 'Speech To Text'
    SI = 'Speaker Identification'
    QA = 'Question Answering (Q&A)'
    OCR = 'OCR'
    TEXT_DETECTION = 'text detection'
    OBJECT_DETECTION = 'object detection'
    OBJECT_SEGMENTATION = 'object segmentation'
    FACE_RECOGNITION = 'face recognition'
    IMAGE_CAPTIONING = 'image captioning'


def _clean_name(name):
    return ''.join(c for c in str(name).lower() if c.isalnum())


def set_dataset_dir(directory):
    """The root directory under which the named corpora live."""
    global _dataset_dir
    _dataset_dir = directory


def get_dataset_dir(dataset = None):
    """The root dataset directory, or the directory of a named corpus (its
    registered directory, ``{}`` standing for the root, else
    ``<root>/<name>``)."""
    if not dataset:
        return _dataset_dir
    directory = _DATASET_INFOS.get(_clean_name(dataset), {}).get('directory')
    if directory:
        return directory.format(_dataset_dir)
    return os.path.join(_dataset_dir, str(dataset))


def _resolve_name(name):
    """The registry key of `name`, whatever its case and punctuation
    ('CommonVoice' → 'common_voice'), or None."""
    key = str(name).lower()
    if key in _DATASETS:
        return key
    cleaned = _clean_name(name)
    return next((k for k in _DATASETS if _clean_name(k) == cleaned), None)


def add_dataset(fn, name = None, task = Task.TTS, directory = None):
    """Register a loader ``fn(directory, ** kwargs) → rows`` under `name`
    and `task`."""
    name = name or getattr(fn, 'dataset', fn.__name__)
    _DATASETS[str(name).lower()] = fn
    _DATASET_INFOS[_clean_name(name)] = {'directory': directory, 'task': task}
    names = _TASKS.setdefault(task.value if isinstance(task, Task) else str(task), [])
    if name not in names:
        names.append(name)
    return fn


def is_custom_dataset(dataset):
    if isinstance(dataset, (list, tuple)):
        return [is_custom_dataset(ds) for ds in dataset]
    return _resolve_name(dataset) is not None


def show_datasets(task = None):
    """Log the registered corpora, by task."""
    for t, names in _TASKS.items():
        if task and t not in (task, getattr(task, 'value', task)):
            continue
        logger.info('%s :\t%s', t, tuple(names))
    tagged = {_clean_name(n) for names in _TASKS.values() for n in names}
    untagged = [n for n in list_datasets() if _clean_name(n) not in tagged]
    if untagged and not task:
        logger.info('(untagged) :\t%s', tuple(untagged))


def get_dataset(dataset, *, directory = None, source = None, ** kwargs):
    """The rows of one or several named corpora.

    A list (or a dict ``{name: kwargs}``) loads each and concatenates them,
    every row tagged with its corpus under ``dataset`` (unless it has one);
    `source`, a callable ``(name, ** kwargs)``, loads instead of the
    registry; `directory` defaults to `get_dataset_dir(name)`."""
    if isinstance(dataset, dict):
        return get_dataset(list(dataset), per_dataset_kwargs = dataset, directory = directory,
                           source = source, ** kwargs)
    if isinstance(dataset, (list, tuple)):
        per = kwargs.pop('per_dataset_kwargs', {})
        rows = []
        for name in dataset:
            part = get_dataset(name, directory = directory, source = source,
                               ** {** kwargs, ** (per.get(name) or {})})
            rows.extend(dict(r, dataset = name) if isinstance(r, dict) and 'dataset' not in r
                        else r for r in part)
        return rows
    if callable(source):
        return source(dataset, ** kwargs)
    key = _resolve_name(dataset)
    if key is None:
        raise ValueError('Unknown dataset {!r} (known: {})'.format(dataset, list_datasets()))
    if directory is None:
        directory = get_dataset_dir(dataset)
    logger.info('Loading dataset %s from %s...', dataset, directory)
    return _DATASETS[key](directory, ** kwargs)


def summarize_dataset(dataset, columns = None, limit = 0.25, ** _):
    """Per-column statistics of a list of rows: the counts of its values
    (``uniques``, most frequent first; ``# uniques`` alone when there are
    more than `limit`, a share of the rows below 1) and, for numbers, the
    mean, std (n - 1), min, quartiles and max; rows without the column (or
    with None) are left out, as pandas leaves out NaN."""
    if not (isinstance(dataset, (list, tuple)) and dataset and isinstance(dataset[0], dict)):
        return {}
    if isinstance(limit, float):
        limit = int(limit * len(dataset))
    if columns is None:
        columns = list(dict.fromkeys(k for row in dataset for k in row))
    return {col: _summarize_column([row[col] for row in dataset if row.get(col) is not None],
                                   limit) for col in columns}


def _summarize_column(values, limit):
    if not values:
        return {}
    first = values[0]
    counts = {}
    if isinstance(first, list):
        if not first or not isinstance(first[0], (str, int)):
            return {}
        for row in values:
            for v in (row if isinstance(row, list) else [row]):
                counts[v] = counts.get(v, 0) + 1
    elif isinstance(first, (str, int, float, np.integer, np.floating)):
        for v in values:
            counts[v] = counts.get(v, 0) + 1
    else:
        return {}
    counts = dict(sorted(counts.items(), key = lambda p: -p[1]))
    infos = {'# uniques': len(counts)} if len(counts) > limit else {'uniques': counts}
    if isinstance(first, (int, float, np.integer, np.floating)) and not isinstance(first, bool):
        x = np.asarray(values, np.float64)
        infos.update({'mean': float(x.mean()), 'std': float(x.std(ddof = 1)) if len(x) > 1
                      else float('nan'), 'min': float(x.min()),
                      '25%': float(np.percentile(x, 25)), '50%': float(np.percentile(x, 50)),
                      '75%': float(np.percentile(x, 75)), 'max': float(x.max())})
    return infos


def _leaf_stats(x):
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        return 'shape : {} - min : {:.3f} - max : {:.3f} - mean : {:.3f}'.format(
            x.shape, x.min(), x.max(), x.mean())
    if np.issubdtype(x.dtype, np.integer):
        return 'shape : {} - min : {} - max : {}'.format(x.shape, x.min(), x.max())
    return 'shape : {}'.format(x.shape)


def _tree_stats(batch):
    if isinstance(batch, dict):
        return {k: _tree_stats(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_stats(v) for v in batch)
    return _leaf_stats(batch)


def benchmark_dataset(dataset, steps = 100, build = False, ** kwargs):
    """Iterate `dataset` (built from rows by `prepare_dataset` with `build`)
    for `steps` batches → host seconds: the first batch against the
    average, batches per second, and the last batch's leaf shapes and
    ranges (``batch_stats``)."""
    t0 = time.time()
    if build:
        dataset = prepare_dataset(dataset, ** kwargs)
    t1 = time.time()
    times, batch = [t1], None
    for i, batch in enumerate(dataset):
        times.append(time.time())
        if steps > 0 and i >= steps - 1:
            break
    n = len(times) - 1
    if n == 0:
        return {'steps': 0}
    deltas = [b - a for a, b in zip(times, times[1:])]
    infos = {'steps': n, 'batch_size': getattr(dataset, 'batch_size', 1),
             'total time': times[-1] - t0, 'initial batch time': deltas[0],
             'average batch time': sum(deltas) / n, 'batches per sec': n / sum(deltas)}
    if build:
        infos['build time'] = t1 - t0
    try:
        infos['batch_stats'] = _tree_stats(batch)
    except (TypeError, ValueError):        # batches that are not trees of arrays
        pass
    logger.info('%d batches in %.3fs (%.2f batch/s, first %.3fs, avg %.3fs)', n, sum(deltas),
                infos['batches per sec'], deltas[0], infos['average batch time'])
    return infos


for _name in list(_DATASETS):
    _TASKS.setdefault(Task.TTS.value, []).append(_name)
    _DATASET_INFOS.setdefault(_clean_name(_name), {'directory': None, 'task': Task.TTS})
