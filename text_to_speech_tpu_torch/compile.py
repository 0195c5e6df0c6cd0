"""The compilation decorator and the execution contexts.

Counterpart of ``text_to_speech_tpu/compile.py``, with its API and its
behaviour around the call:

  - `TensorSpec` annotations drive argument casting and static-argument
    detection (``static=True`` arguments are left as they are);
  - `graph_compile` binds the signature, runs the `prepare_for_xla` hook
    (shape bucketing, `pad_to_multiple_hook`) and casts the annotated
    arguments, outside the eager context `EagerExecution`; inside it the
    function runs on its arguments as given;
  - `execute_eagerly` runs a host function on numpy copies of its tensor
    arguments, and inside a program exported with `torch.export` as a
    `torch.library` op whose fake implementation gives the declared
    ``output_shape`` / ``output_dtype``.

A standing deviation: nothing is compiled.  The JAX package jit-compiles
the function once per bucket; PyTorch runs eagerly, and a jit has no
counterpart the port needs (a CUDA graph belongs to a change that makes the
port faster, not to the port of this API), so ``wrapper.compiled_fn`` is the
function itself.  A program for a fixed shape is `runtimes.ExportRuntime` /
`AOTRuntime`.
"""

import functools
import inspect
import itertools
import threading

import numpy as np
import torch

from .xp import _torch_dtype, convert_to_tensor

_context = threading.local()


class TensorSpec:
    """Argument annotation: expected shape / dtype, or `static=True` for a
    value left as it is."""

    def __init__(self, shape = None, dtype = 'float32', static = False):
        self.shape = shape
        self.dtype = dtype
        self.static = static

    def cast(self, value, device = None):
        """`value` as a tensor of this spec's dtype: a tensor stays on its
        device, anything else goes to `device` (by default the port's,
        `devices.default_device`)."""
        if value is None or self.static:
            return value
        if torch.is_tensor(value):
            return value.to(_torch_dtype(self.dtype))
        return convert_to_tensor(np.asarray(value), self.dtype, device)

    def __repr__(self):
        return 'TensorSpec(shape={}, dtype={}, static={})'.format(
            self.shape, self.dtype, self.static)


class XLAExecution:
    """Context manager selecting the compiled path (here: the casts and the
    bucketing hook) on this thread."""

    def __init__(self, force = True):
        self.mode = 'xla' if force else None

    def __enter__(self):
        self._prev = getattr(_context, 'mode', None)
        _context.mode = self.mode
        return self

    def __exit__(self, * exc):
        _context.mode = self._prev
        return False


class EagerExecution(XLAExecution):
    """Context manager forcing the raw function on this thread."""

    def __init__(self):
        self.mode = 'eager'


def is_eager():
    return getattr(_context, 'mode', None) == 'eager'


def graph_compile(fn = None, *, static_args = (), prepare_for_xla = None,
                  cast_kwargs = True, jit_options = None, device = None):
    """Decorator honouring `TensorSpec` annotations, as the JAX package's.

    - annotated ``static=True`` parameters and the names in `static_args`
      make ``wrapper.static_argnames``;
    - other annotated parameters are cast to their spec's dtype (values that
      are not tensors onto `device`, by default the port's);
    - `prepare_for_xla(arguments) -> dict` may rewrite the arguments (shape
      bucketing) before the call;
    - under `EagerExecution` neither runs: the function gets its arguments
      as given.

    `jit_options` is accepted for the JAX package's signature and unused:
    nothing is compiled (module docstring)."""
    def decorate(func):
        signature = inspect.signature(func)
        specs = {name: param.annotation for name, param in signature.parameters.items()
                 if isinstance(param.annotation, TensorSpec)}
        static_names = tuple(name for name, spec in specs.items() if spec.static) \
            + tuple(static_args)

        @functools.wraps(func)
        def wrapper(* args, ** kwargs):
            bound = signature.bind_partial(* args, ** kwargs)
            bound.apply_defaults()
            arguments = dict(bound.arguments)
            if not is_eager():
                if prepare_for_xla is not None:
                    arguments.update(prepare_for_xla(arguments) or {})
                if cast_kwargs:
                    for name, spec in specs.items():
                        if name in arguments:
                            arguments[name] = spec.cast(arguments[name], device)
            return func(** arguments)

        wrapper.eager_fn = func
        wrapper.compiled_fn = func
        wrapper.static_argnames = static_names
        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


_HOST_OPS = itertools.count()


def execute_eagerly(fn = None, *, output_shape = None, output_dtype = 'float32'):
    """Wrap a host function (numpy in, array out) so that it takes and
    returns tensors: the JAX package's ``jax.pure_callback`` wrapper.

    With a fully known `output_shape`, the call is a `torch.library` op
    (CPU and CUDA implementations: numpy copies of the tensor arguments,
    the result on the first argument's device), so that `torch.export`
    holds it as one node and its fake implementation gives the output;
    without one, the function runs directly on numpy copies (the JAX
    package's eager fallback).  Keyword arguments are the host function's
    own and are not traced."""
    dtype = _torch_dtype(output_dtype)

    def decorate(func):
        def host(args, kwargs):
            out = func(* [a.detach().cpu().numpy() for a in args], ** kwargs)
            device = args[0].device if args else torch.device('cpu')
            return torch.tensor(np.asarray(out, dtype = np.dtype(output_dtype)), device = device)

        op = None
        if output_shape is not None and all(s is not None for s in output_shape):
            name = 'tts_torch::host_{}_{}'.format(
                ''.join(c if c.isalnum() else '_' for c in func.__name__), next(_HOST_OPS))
            op = torch.library.custom_op(name, lambda args: None, mutates_args = (),
                                         schema = '(Tensor[] args) -> Tensor')
            op.register_kernel(('cpu', 'cuda'))(lambda args: host(args, {}))
            op.register_fake(lambda args: args[0].new_empty(tuple(output_shape),
                                                            dtype = dtype))

        @functools.wraps(func)
        def wrapper(* args, ** kwargs):
            args = [a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a)) for a in args]
            if op is None or kwargs:
                return host(args, kwargs)
            return op(args)

        wrapper.python_fn = func
        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


def pad_to_multiple_hook(arg_name, multiple, axis = 1, value = 0):
    """A `prepare_for_xla` hook bucketing one argument's shape (a numpy array
    or a tensor, which stays one)."""
    from .utils.sequence_utils import pad_to_multiple

    def hook(arguments):
        if arg_name in arguments and arguments[arg_name] is not None:
            data = arguments[arg_name]
            arguments[arg_name] = pad_to_multiple(
                data if torch.is_tensor(data) else np.asarray(data), multiple, axis = axis,
                constant_values = value)
        return arguments

    return hook
