"""The JAX package's saved model directories, read by the port.

The layout (``text_to_speech_tpu/models/saving.py``)::

    <root>/<name>/config.json                 # class name + constructor kwargs
    <root>/<name>/saving/config_models.json   # architecture hparams
    <root>/<name>/saving/tokenizer.json
    <root>/<name>/saving/mel_fn.json
    <root>/<name>/saving/checkpoint/checkpoint.json   # manifest, newest last
    <root>/<name>/saving/checkpoint/ckpt-<epoch>.<tree>.npz

The port reads these files, and its task models write them (`save`:
`write_model_config` and a checkpoint), so that the JAX package loads them.  The root is
``$TTS_PRETRAINED_DIR`` or ``pretrained_models`` (relative to the working
directory), like the JAX package's, unless a caller passes its own.
"""

import os

from ..utils.file_utils import dump_json, load_json
from ..weights import load_tree


def pretrained_root(root = None):
    return root or os.environ.get('TTS_PRETRAINED_DIR', 'pretrained_models')


def model_dir(name, * parts, root = None):
    return os.path.join(pretrained_root(root), name, * parts)


def write_model_config(folder, class_name, config, architecture, arch_config):
    """``config.json`` (the class and its constructor config) and
    ``saving/config_models.json`` (the architecture's name and hparams) of
    the model directory `folder`, as the JAX package writes them."""
    dump_json(os.path.join(folder, 'config.json'),
              {'class_name': class_name, 'config': config}, indent = 2)
    dump_json(os.path.join(folder, 'saving', 'config_models.json'),
              {'architecture': architecture, ** arch_config}, indent = 2)


def load_model_files(name, root = None):
    """{'config', 'architecture', 'params', 'state', 'dir'} of saved model
    `name`; the weights are the newest checkpoint in the manifest (the
    one the JAX package restores), as numpy trees."""
    directory = model_dir(name, root = root)
    config = load_json(os.path.join(directory, 'config.json'))
    architecture = load_json(os.path.join(directory, 'saving', 'config_models.json'))
    ckpt_dir = os.path.join(directory, 'saving', 'checkpoint')
    manifest = load_json(os.path.join(ckpt_dir, 'checkpoint.json'))
    entry = manifest['checkpoints'][-1]
    trees = {}
    for tree in ('params', 'state'):
        path = os.path.join(ckpt_dir, 'ckpt-{}.{}.npz'.format(entry['epoch'], tree))
        trees[tree] = load_tree(path) if os.path.exists(path) else {}
    return {'config': config, 'architecture': architecture, 'dir': directory, ** trees}
