"""The task models' inference pipeline.

Counterpart of the inference part of
``text_to_speech_tpu/models/interfaces/base_model.py``: `pred_dir`,
`get_inference_callbacks`, `predict` (`infer` over a `utils.stream.Stream`
of the inputs, with the callbacks and their prediction cache, joined at the
end) and `stream`.  A task model gives `folder` (its directory under the
root it was loaded from) and `infer`.
"""

import functools
import os

import numpy as np

from ..loggers import timer
from ..utils.stream import Stream


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
