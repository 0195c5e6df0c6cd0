"""Training historian.

Counterpart of ``text_to_speech_tpu/train/history.py``: per-epoch and
per-batch metric logs, one config record per training run, and the same
``history.json`` layout (``{'epoch_logs': [...], 'trainings':
[...]}``), so either package reads the other's, and `get_best`.  Plotting
is not ported.
"""

import time

import numpy as np
import torch

from ..utils.file_utils import load_json, dump_json


def to_json_serializable(value):
    """Numpy and torch scalars and arrays, tuples and dicts → JSON values."""
    if isinstance(value, dict):
        return {str(k): to_json_serializable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_json_serializable(v) for v in value]
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    return value


class History:
    def __init__(self, filename = None):
        self.filename = filename
        self.epoch_logs = []          # [{'epoch': int, 'metrics': {...}, 'time': float}]
        self.batch_logs = []          # the current epoch's batch metrics
        self.trainings = []           # [{'config': {...}, 'start_epoch': int, ...}]
        self._epoch_start = None
        self._current_training = None

    @property
    def epochs(self):
        return len(self.epoch_logs)

    @property
    def steps(self):
        return sum(t.get('steps', 0) for t in self.trainings)

    def __len__(self):
        return self.epochs

    def __repr__(self):
        return 'History(epochs={}, trainings={})'.format(self.epochs, len(self.trainings))

    def set_config(self, config):
        """Start a new training run with the given config."""
        self._current_training = {
            'config': to_json_serializable(config),
            'start_epoch': self.epochs,
            'start_time': time.time(),
            'steps': 0,
        }
        self.trainings.append(self._current_training)

    def on_epoch_begin(self, epoch = None):
        self._epoch_start = time.time()
        self.batch_logs = []

    def on_batch_end(self, metrics):
        self.batch_logs.append(to_json_serializable(metrics))
        if self._current_training is not None:
            self._current_training['steps'] = self._current_training.get('steps', 0) + 1

    def on_epoch_end(self, metrics, epoch = None):
        entry = {
            'epoch': epoch if epoch is not None else self.epochs,
            'metrics': to_json_serializable(metrics),
            'time': time.time() - self._epoch_start if self._epoch_start else None,
        }
        self.epoch_logs.append(entry)
        if self.filename:
            self.save(self.filename)
        return entry

    def get_metric(self, name):
        return [e['metrics'].get(name) for e in self.epoch_logs]

    def get_best(self, metric = 'loss', mode = None):
        """(best value, its epoch) of `metric`, (None, -1) when no epoch has
        it; `mode` 'max' or 'min', by default 'max' for a name with 'acc',
        'f1', 'precision' or 'recall' in it, else 'min'.  A tie keeps the
        first epoch."""
        values = [(e['metrics'][metric], e['epoch']) for e in self.epoch_logs
                  if e['metrics'].get(metric) is not None]
        if not values: return None, -1
        if mode is None:
            mode = 'max' if any(tag in metric for tag in ('acc', 'f1', 'precision', 'recall')) \
                else 'min'
        return (max if mode == 'max' else min)(values, key = lambda v: v[0])

    def get_config(self):
        return {'epoch_logs': self.epoch_logs, 'trainings': self.trainings}

    def save(self, filename = None):
        return dump_json(filename or self.filename, self.get_config(), indent = 2)

    @classmethod
    def load(cls, filename):
        hist = cls(filename = filename)
        config = load_json(filename, default = None)
        if config:
            hist.epoch_logs = config.get('epoch_logs', [])
            hist.trainings = config.get('trainings', [])
        return hist
