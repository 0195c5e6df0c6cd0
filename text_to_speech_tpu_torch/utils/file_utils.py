"""JSON files.

Counterpart of `load_json` / `dump_json` in
``text_to_speech_tpu/utils/file_utils.py``, with its numpy-aware encoder
(and torch tensors, which the port's training logs hold).  The rest of the
JAX package's loader registry is not ported.
"""

import json
import os

import numpy as np
import torch


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o):
        if torch.is_tensor(o): o = o.detach().cpu().numpy()
        if isinstance(o, np.generic): return o.item()
        if isinstance(o, np.ndarray): return o.tolist()
        if isinstance(o, bytes): return o.decode('utf-8', 'replace')
        return super().default(o)


def load_json(filename, default = '__raise__'):
    """The JSON value in `filename`; `default` when the file does not exist
    (unless left as the raising sentinel)."""
    if not os.path.exists(filename):
        if isinstance(default, str) and default == '__raise__':
            raise FileNotFoundError(filename)
        return default
    with open(filename, 'r', encoding = 'utf-8') as f:
        return json.load(f)


def dump_json(filename, data, indent = None):
    d = os.path.dirname(filename)
    if d: os.makedirs(d, exist_ok = True)
    with open(filename, 'w', encoding = 'utf-8') as f:
        json.dump(data, f, indent = indent, cls = _NumpyJSONEncoder, ensure_ascii = False)
    return filename
