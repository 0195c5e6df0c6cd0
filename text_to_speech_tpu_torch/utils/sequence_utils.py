"""Padding helpers of the data and bucketing paths.

Counterpart of ``text_to_speech_tpu/utils/sequence_utils.py``: `pad_batch`
stacks arrays of unequal lengths, `pad_to_multiple` pads one axis to a
shape bucket.
"""

import numpy as np

from .. import xp


def pad_batch(batch, pad_value = 0, max_length = None):
    """Stack arrays that differ along any axis into one array of the largest
    shape (axis 0 at least `max_length`), filled with `pad_value`."""
    batch = [np.asarray(b) for b in batch]
    shape = [max(b.shape[i] for b in batch) for i in range(batch[0].ndim)]
    if max_length is not None:
        shape[0] = max(shape[0], max_length)
    out = np.full([len(batch)] + shape, pad_value, dtype = batch[0].dtype)
    for i, b in enumerate(batch):
        out[(i,) + tuple(slice(0, n) for n in b.shape)] = b
    return out


def pad_to_multiple(data, multiple, axis = 0, constant_values = 0):
    """Pad `data` (a numpy array or a torch tensor, which stays one, on its
    device) along `axis` to a multiple of `multiple`."""
    rem = data.shape[axis] % multiple
    if rem == 0: return data
    pads = [(0, 0)] * data.ndim
    pads[axis] = (0, multiple - rem)
    return xp.pad(data, pads, mode = 'constant', constant_values = constant_values)
