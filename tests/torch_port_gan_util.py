"""What the two adversarial-training test files of the port share
(``test_torch_port_gan.py``, ``test_torch_port_vits_train.py``).

  - `compile_fast`: a JAX program jitted and compiled at XLA's first
    optimization level, about two thirds of the default's compile time for
    these programs at the same run time;
  - `narrow_discriminators`: a fixture that narrows the port's
    discriminators (`MPD_CHANNELS`, `MSD_SPECS`) for a test that holds the
    port to itself, such as a `fit` that checkpoints and resumes: the
    published widths put 18 M parameters and their optimizer state in
    every step, save and load of such a test, and nothing it checks depends
    on them;
  - `layer_records`: the shape and dtype of every conv, transposed conv and
    dense layer a step runs through the `nn.layers` module given, and of
    the calls of the object methods given, for holding a mixed-precision
    step's casts to the JAX step's.
"""

import contextlib

import jax
import jax.numpy as jnp
import pytest

from text_to_speech_tpu_torch.models import hifigan_arch

#: XLA's first optimization level
FAST_COMPILE = {'xla_backend_optimization_level': 1}


def compile_fast(fn, * args):
    """`fn` jitted and compiled for `args` at `FAST_COMPILE`."""
    jitted = fn if hasattr(fn, 'lower') else jax.jit(fn)
    return jitted.lower(* args).compile(compiler_options = FAST_COMPILE)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.fixture
def narrow_discriminators(monkeypatch):
    """The port's discriminators at 16-32 channels (the groups and strides
    of `MSD_SPECS` kept)."""
    monkeypatch.setattr(hifigan_arch, 'MPD_CHANNELS', (4, 8, 16, 16))
    monkeypatch.setattr(hifigan_arch, 'MSD_SPECS', (
        (15, 1, 1, 16), (41, 2, 4, 16), (41, 2, 16, 16), (41, 4, 16, 16), (41, 4, 16, 32),
        (41, 1, 16, 32), (5, 1, 1, 32)))


def _dtype(x):
    """'float32', 'bfloat16', 'int', 'bool' or 'None' of an array or tensor
    of either package."""
    if x is None:
        return 'None'
    name = str(x.dtype).replace('torch.', '')
    if name.startswith(('int', 'uint')):
        return 'int'
    return name


def _first_array(out):
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


@contextlib.contextmanager
def layer_records(layers, methods = ()):
    """Yields a set that collects, while the block runs, one record per
    distinct call: ``(layer, input shape, output shape, input dtype, output
    dtype)`` for `layers`' ``conv1d``, ``conv1d_transpose`` and ``dense``;
    for each (object, name) of `methods` the same of its second argument and
    its first output array, or with a dict output ``(name, key, dtype)`` a
    key.  JAX calls record while a program traces."""
    records = set()

    def describe(name, x, out):
        if isinstance(out, dict):
            return [(name, k, _dtype(v)) for k, v in out.items()]
        out = _first_array(out)
        return [(name, tuple(x.shape), tuple(out.shape), _dtype(x), _dtype(out))]

    def spy(name, fn):
        def call(* args, ** kwargs):
            out = fn(* args, ** kwargs)
            records.update(describe(name, args[1], out))
            return out
        return call

    saved = [(layers, name, getattr(layers, name))
             for name in ('conv1d', 'conv1d_transpose', 'dense')]
    for owner, name, fn in saved:
        setattr(owner, name, spy(name, fn))
    for owner, name in methods:
        setattr(owner, name, spy(name, getattr(owner, name)))   # an instance attribute
    try:
        yield records
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        for owner, name in methods:
            delattr(owner, name)
