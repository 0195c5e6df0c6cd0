"""Rotating tree checkpoints with a JSON manifest.

Counterpart of ``text_to_speech_tpu/train/checkpoint.py``, in its layout::

    <directory>/checkpoint.json              # manifest, oldest first
    <directory>/ckpt-<epoch>.<tree>.npz      # one file per named tree

A tree is nested dicts of arrays or tensors, flattened to ``/``-joined
paths (`weights.flatten_tree`).  `max_to_keep` checkpoints are kept, and
the best one (lowest metric, or the one saved with ``is_best``) is never
deleted; ``load(best = True)`` reads it, or the latest when there is none.  `AsyncCheckpointSaver`
moves the writes onto one background thread.
"""

import concurrent.futures
import os

import numpy as np
import torch

from ..weights import flatten_tree, unflatten_tree
from ..utils.file_utils import dump_json, load_json


def save_tree(filename, tree):
    flat = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in flatten_tree(tree).items()}
    directory = os.path.dirname(filename)
    if directory: os.makedirs(directory, exist_ok = True)
    np.savez(filename, ** flat)
    return filename


def load_tree(filename):
    with np.load(filename) as data:
        return unflatten_tree({k: data[k] for k in data.files})


class CheckpointManager:
    MANIFEST = 'checkpoint.json'

    def __init__(self, directory, max_to_keep = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok = True)
        self._manifest = load_json(os.path.join(directory, self.MANIFEST),
                                   default = {'checkpoints': [], 'best': None})

    @property
    def checkpoints(self):
        return list(self._manifest['checkpoints'])

    @property
    def best_epoch(self):
        best = self._manifest.get('best')
        return best['epoch'] if best else None

    @property
    def latest_epoch(self):
        cks = self._manifest['checkpoints']
        return cks[-1]['epoch'] if cks else None

    def _path(self, epoch, tree_name):
        return os.path.join(self.directory, 'ckpt-{}.{}.npz'.format(epoch, tree_name))

    def save(self, trees, epoch, *, metric = None, is_best = None):
        """`trees` = {'params': tree, 'opt': tree, ...} for `epoch`.  It is
        the best when `is_best` says so, or, with `is_best` None, when its
        `metric` is below the best's (or the best has none).  Rotates the
        checkpoints beyond `max_to_keep`, never the best one."""
        entry = {'epoch': epoch, 'trees': sorted(trees), 'metric': metric}
        for name, tree in trees.items():
            save_tree(self._path(epoch, name), tree)
        self._manifest['checkpoints'] = [
            c for c in self._manifest['checkpoints'] if c['epoch'] != epoch] + [entry]
        best = self._manifest.get('best')
        if is_best is None and metric is not None:
            is_best = best is None or best.get('metric') is None or metric < best['metric']
        if is_best:
            self._manifest['best'] = dict(entry)
        keep = {c['epoch'] for c in self._manifest['checkpoints'][-self.max_to_keep:]}
        if self._manifest.get('best'):
            keep.add(self._manifest['best']['epoch'])
        for ck in list(self._manifest['checkpoints']):
            if ck['epoch'] not in keep:
                self.delete(ck['epoch'])
        self._save_manifest()
        return entry

    def load(self, epoch = None, *, best = False, trees = None):
        """{'params': tree, ...} of numpy arrays for `epoch` (default: the
        latest, or with `best` the best, else the latest); `trees` restricts
        which named trees are read."""
        if best:
            epoch = self.best_epoch
        if epoch is None:
            epoch = self.latest_epoch
        if epoch is None:
            return None
        entry = next((c for c in self._manifest['checkpoints'] if c['epoch'] == epoch), None)
        if entry is None:
            raise ValueError('No checkpoint for epoch {} (have: {})'.format(
                epoch, [c['epoch'] for c in self._manifest['checkpoints']]))
        return {name: load_tree(self._path(epoch, name)) for name in entry['trees']
                if trees is None or name in trees}

    def delete(self, epoch):
        entry = next((c for c in self._manifest['checkpoints'] if c['epoch'] == epoch), None)
        if entry is None: return
        for name in entry['trees']:
            path = self._path(epoch, name)
            if os.path.exists(path): os.remove(path)
        self._manifest['checkpoints'] = [
            c for c in self._manifest['checkpoints'] if c['epoch'] != epoch]
        self._save_manifest()

    def _save_manifest(self):
        self._manifest['checkpoints'].sort(key = lambda c: c['epoch'])
        dump_json(os.path.join(self.directory, self.MANIFEST), self._manifest, indent = 2)


class AsyncCheckpointSaver:
    """Checkpoint writes on one background thread over a `CheckpointManager`
    (the JAX package's `AsyncCheckpointSaver`).

    `save` snapshots every tensor with a copy on its device, so that the next
    step's in-place update cannot change it, and starts a non-blocking copy
    of that snapshot to the host, then returns; the thread waits for the
    copies and writes the ``.npz`` files and the manifest.  At most one save
    is in flight: `save` and `wait_until_finished` first join the previous
    one, and an error raised on the thread is raised there."""

    def __init__(self, manager):
        self.manager = manager
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers = 1, thread_name_prefix = 'ckpt-writer')
        self._future = None

    def save(self, trees, epoch, *, metric = None, is_best = None):
        self.wait_until_finished()
        snapshot, devices = {}, set()
        for name, tree in trees.items():
            leaves = {}
            for key, value in flatten_tree(tree).items():
                if torch.is_tensor(value):
                    value = value.detach().clone()
                    if value.is_cuda:
                        devices.add(value.device)
                        value = value.to('cpu', non_blocking = True)
                else:
                    value = np.array(value)
                leaves[key] = value
            snapshot[name] = leaves
        copied = []
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            copied.append(event)
        self._future = self._pool.submit(self._write, snapshot, epoch, metric, is_best, copied)

    def _write(self, snapshot, epoch, metric, is_best, copied):
        for event in copied:
            event.synchronize()
        trees = {name: unflatten_tree(leaves) for name, leaves in snapshot.items()}
        return self.manager.save(trees, epoch, metric = metric, is_best = is_best)

    def wait_until_finished(self):
        """Join the save in flight, if any, and raise its error."""
        future, self._future = self._future, None
        if future is not None:
            return future.result()

    def close(self):
        try:
            self.wait_until_finished()
        finally:
            self._pool.shutdown(wait = True)
