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
of the JAX trees), so that either package loads the directory by name;
`from_pretrained` loads a saved model, or, given a second name, makes a new
one from a saved model's weights (`transfer_trees`, the JAX package's
name-based partial transfer).
"""

import functools
import logging
import os

import numpy as np
import torch

from ..loggers import Timer, timer
from ..train.checkpoint import CheckpointManager
from ..train.history import History
from ..utils.stream import Stream
from ..weights import cast_tree, tree_to
from .saving import model_dir, write_model_config

logger = logging.getLogger(__name__)


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


def transfer_trees(pretrained_name, params, state, *, root = None):
    """The JAX trees (`params`, `state`) of a new model with the weights of
    the saved model `pretrained_name` under `root` carried across by
    `weights_converter.name_based_partial_transfer_learning`, as the JAX
    package's constructor does with ``pretrained_name``: a leaf whose name
    matches takes the source's (its overlapping block, the rest zeros, when
    the shapes differ), an unmatched one keeps its fresh value.  The source
    is read by name (`models.get_pretrained`) and its trees in its
    checkpoint's order, which is the order the JAX package maps in.  When
    the state does not transfer, the fresh statistics stay, with the JAX
    package's warning."""
    from . import get_pretrained
    from .weights_converter import name_based_partial_transfer_learning
    with Timer('read source'):
        source = get_pretrained(pretrained_name, root = root, device = 'cpu')
        trees = source.ckpt_manager.load(trees = ('params', 'state'))
    with Timer('name-based transfer'):
        params = name_based_partial_transfer_learning(trees['params'], params)
        if trees.get('state') and state:
            try:
                state = name_based_partial_transfer_learning(trees['state'], state)
            except (ValueError, IndexError, TypeError):
                logger.warning('state transfer failed; keeping fresh statistics')
    logger.info('transferred weights from %s', pretrained_name)
    return params, state


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

    @classmethod
    def from_pretrained(cls, name, pretrained_name = None, *, root = None, device = None,
                        ** kwargs):
        """The saved model `name` under `root`, on `device` (`kwargs` go to
        the constructor).  With `pretrained_name`, the JAX package's
        ``from_pretrained(name, pretrained_name)``: when `name` is not saved
        yet, a new model made by `create` from `kwargs` (the language, the
        hparams, a seed) whose weights come from the saved model
        `pretrained_name` (`transfer_trees`), saved as `name`; when `name`
        is saved, that model, and `pretrained_name` and `kwargs` are
        ignored."""
        if pretrained_name is not None:
            if not os.path.exists(model_dir(name, 'config.json', root = root)):
                return cls.create(name = name, pretrained_name = pretrained_name, root = root,
                                  device = device, ** kwargs)
            logger.info('%s is saved: loading it, not transferring %s', name, pretrained_name)
            kwargs = {}
        return cls.load_saved(name, root = root, device = device, ** kwargs)

    @classmethod
    def create(cls, ** kwargs):
        raise NotImplementedError('{} has no create: a new model of it cannot be made by '
                                  'transfer'.format(cls.__name__))

    def _weights_changed(self):
        """New weights (`params` set, `set_weights`, `to`, each epoch of
        `fit`) drop those derived from the old ones in `_derived`: cast
        copies, a packed decoder."""
        self._derived = {}

    def _cast_params(self, dtype):
        """The params cast to `dtype` (as they are for None), once per dtype
        and set of weights."""
        if dtype is None:
            return self.params
        key = ('cast', dtype)
        if key not in self._derived:
            self._derived[key] = cast_tree(self.params, dtype)
        return self._derived[key]

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
