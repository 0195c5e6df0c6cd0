"""The task models' inference pipeline and their training side.

Counterpart of ``text_to_speech_tpu/models/interfaces/base_model.py``:
`BaseModel` holds the inference part (`pred_dir`,
`get_inference_callbacks`, `predict`: `infer` over a `utils.stream.Stream`
of the inputs, with the callbacks and their prediction cache, joined at the
end, and `stream`); a task model gives `folder` (its directory under the
root it was loaded from) and `infer`.  `TrainableModel` holds what `fit`
needs and saving under a name: the model's `history`, `epochs` and
`ckpt_manager` in ``<root>/<name>/saving/``, `to`, `set_weights`, `fit`,
and `save`, which writes the JAX package's layout (``config.json``,
``saving/config_models.json``, the task's saving objects such as
``tokenizer.json`` and ``mel_fn.json``, ``history.json`` and a checkpoint
of the JAX trees), so that either package loads the directory by name.
"""

import functools
import os

import numpy as np
import torch

from ..loggers import timer
from ..train.checkpoint import CheckpointManager
from ..train.history import History
from ..utils.stream import Stream
from ..weights import tree_to
from .saving import write_model_config


class BaseModel:
    @property
    def pred_dir(self):
        path = os.path.join(self.folder, 'predictions')
        os.makedirs(path, exist_ok = True)
        return path

    def infer(self, inputs, ** kwargs):
        raise NotImplementedError()

    def get_inference_callbacks(self, ** kwargs):
        return {}, []

    @timer(name = 'predict')
    def predict(self,
                inputs,
                *,
                callbacks = None,
                workers = 1,
                overwrite = False,
                return_output = True,
                ** kwargs
               ):
        """Run `self.infer` over a stream of inputs with caching callbacks:
        on the caller's thread with ``workers = 0``, else on one `Stream`
        thread."""
        if not isinstance(inputs, (list, tuple, np.ndarray)) and not hasattr(inputs, 'get'):
            inputs = [inputs]

        if callbacks is None:
            predicted, callbacks = self.get_inference_callbacks(** kwargs)
        else:
            predicted = {}

        infer_fn = functools.partial(
            self.infer,
            callbacks = callbacks,
            predicted = predicted,
            overwrite = overwrite,
            return_output = return_output,
            ** kwargs,
        )
        results = list(Stream(infer_fn, inputs, workers = workers if workers == 0 else 1))
        for cb in callbacks:
            if hasattr(cb, 'join'): cb.join()
        return results

    def stream(self, stream, ** kwargs):
        """predict() over a live queue/iterator (a queue ends at `None`)."""
        return self.predict(stream, ** kwargs)


def detach_tree(tree):
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    return tree.detach()


class TrainableModel:
    """The training side of a task model.  It gives `name`, `folder`,
    `device`, `arch`, `params`, `state`, `get_config`, `jax_trees` (its
    weights as the JAX package's trees) and `get_saving_objects`
    ({filename under ``saving/``: an object with ``save(path)``})."""

    max_to_keep = 3
    _history = None
    _ckpt_manager = None

    def get_saving_objects(self):
        return {}

    def _weights_changed(self):
        """Drop what was derived from the old weights."""

    @property
    def history(self):
        if self._history is None:
            self._history = History.load(os.path.join(self.folder, 'saving', 'history.json'))
        return self._history

    @property
    def epochs(self):
        return self.history.epochs

    @property
    def ckpt_manager(self):
        """The `CheckpointManager` of ``saving/checkpoint/``, made (with its
        directory) at first use."""
        if self._ckpt_manager is None:
            self._ckpt_manager = CheckpointManager(
                os.path.join(self.folder, 'saving', 'checkpoint'),
                max_to_keep = self.max_to_keep)
        return self._ckpt_manager

    def to(self, device):
        """Move the weights to `device` (a no-op where they are)."""
        device = torch.device(device)
        if device != self.device:
            self.device = device
            self.set_weights(self.params, self.state)
        return self

    def set_weights(self, params, state = None):
        self.params = tree_to(detach_tree(params), self.device)
        if state is not None: self.state = tree_to(detach_tree(state), self.device)
        self._weights_changed()

    def fit(self, data, ** kwargs):
        """Train on `data` with `train.trainer.fit`."""
        from ..train.trainer import fit
        return fit(self, data, ** kwargs)

    def save(self, *, epoch = None, metric = None, extra_trees = None, saver = None):
        """Write ``<root>/<name>/`` in the JAX package's layout, with a
        checkpoint of the weights (and `extra_trees`) for `epoch` (default:
        ``epochs``); through `saver` (`train.checkpoint.AsyncCheckpointSaver`),
        when given, the checkpoint is written on its thread."""
        saving = os.path.join(self.folder, 'saving')
        write_model_config(self.folder, type(self).__name__,
                           {** self.get_config(), 'name': self.name},
                           type(self.arch).__name__.lower(), self.arch.get_config())
        for filename, obj in self.get_saving_objects().items():
            obj.save(os.path.join(saving, filename))
        self.history.save(os.path.join(saving, 'history.json'))
        trees = {** self.jax_trees(), ** (extra_trees or {})}
        (saver or self.ckpt_manager).save(trees, epoch if epoch is not None else self.epochs,
                                          metric = metric)
        return self.folder
