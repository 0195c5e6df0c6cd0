"""Inference runtimes: the `Runtime` registry, and the serving modules.

Counterpart of ``text_to_speech_tpu/runtimes/__init__.py`` (`Runtime`,
`register_runtime`, `list_runtimes`, `build_runtime` with its engine cache,
`enable_persistent_compilation_cache`) on `torch.export`:

  - ``'torch'`` (`TorchRuntime`): the in-process call of a function, the
    JAX package's ``'jax'`` (a standing deviation of the name: nothing is
    jit-compiled, `compile.py`);
  - ``'export'`` (`ExportRuntime`): a program saved by `torch.export` as a
    ``.pt2`` file, loaded and moved onto the caller's device
    (`torch.export.passes.move_to_device_pass`), so that one artifact runs
    on the CPU and on the card (the JAX package exports for ``platforms=
    ('cpu', 'tpu')`` instead); K3 is the exception: its kernel takes the
    LSTM weights in its slabs, not in the CPU's plain layout, so a decode
    chunk is exported on the device it runs on;
  - ``'aot'`` (`AOTRuntime`): a program exported at example shapes, with
    its operation count (`FlopCounterMode`, the kernels counted by their
    flop formulas) and its memory from the graph; persisted as ``.pt2``
    files under `enable_persistent_compilation_cache`'s directory;
  - ``'hf'`` (`HFRuntime`): a HuggingFace ``transformers`` model on a
    device, imported when loaded.

The engine cache is keyed by (runtime, path, device), so that an engine
loaded for the CPU is never handed to a caller on the card.  The kernels
K1, K2 and K3 are `torch.library` ops (``torch.ops.tts_torch``): an
exported program holds them as nodes, launches them on the card and counts
their launches there; `ExportRuntime` imports their modules before it loads
a program.

The serving modules of the package are `serving` (the request engines and
the steppers), `http_server` (`TTSServer`) and `llm_serving`.
"""

import hashlib
import logging
import os
import types

import torch

from ..devices import default_device

logger = logging.getLogger(__name__)

_RUNTIMES = {}
_ENGINE_CACHE = {}
_AOT_CACHE = {'directory': None}


def register_runtime(name):
    def deco(cls):
        _RUNTIMES[name] = cls
        return cls
    return deco


class Runtime:
    """Base runtime: wraps an engine addressed by `path`."""

    def __init__(self, path, ** kwargs):
        self.path = path
        self.kwargs = kwargs
        self.engine = self.load_engine(path, ** kwargs)

    @classmethod
    def load_engine(cls, path, ** kwargs):
        raise NotImplementedError()

    def __call__(self, * args, ** kwargs):
        raise NotImplementedError()

    def __repr__(self):
        return '{}(path={!r})'.format(self.__class__.__name__, self.path)


def build_runtime(runtime, path = None, device = None, ** kwargs):
    """Factory with an engine cache keyed by (runtime, path, device);
    `device` defaults to the port's (`devices.default_device`: cuda)."""
    if isinstance(runtime, Runtime): return runtime
    if runtime not in _RUNTIMES:
        raise ValueError('Unknown runtime {!r} (known: {})'.format(
            runtime, sorted(_RUNTIMES)))
    device = default_device(device)
    cache_key = (runtime, path, str(device))
    if cache_key not in _ENGINE_CACHE:
        _ENGINE_CACHE[cache_key] = _RUNTIMES[runtime](path, device = device, ** kwargs)
    return _ENGINE_CACHE[cache_key]


def list_runtimes():
    return sorted(_RUNTIMES)


def _load_kernel_ops():
    """Register the kernels' ops (``torch.ops.tts_torch``): a saved program
    that holds them loads only once they exist."""
    from ..ops import decoder_kernel, wn_block, wn_block_int8  # noqa: F401


class _Module(torch.nn.Module):
    """`fn` as the module `torch.export` takes; its arguments (parameter
    dicts included) stay call arguments."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, * args):
        return self.fn(* args)


def _export(fn, example_args):
    """`torch.export` of `fn` at `example_args`, without them: a program
    keeps its example inputs and saves them, a parameter tree included."""
    program = torch.export.export(_Module(fn), tuple(example_args))
    program.example_inputs = None
    return program


@register_runtime('torch')
class TorchRuntime(Runtime):
    """In-process execution of a callable, the JAX package's ``'jax'``
    runtime: PyTorch runs it eagerly, under `torch.no_grad`."""

    def __init__(self, fn, static_argnames = None, ** kwargs):
        self.path = getattr(fn, '__name__', 'fn')
        self.kwargs = kwargs
        self.engine = fn

    @classmethod
    def load_engine(cls, path, ** kwargs):
        return path

    def __call__(self, * args, ** kwargs):
        with torch.no_grad():
            return self.engine(* args, ** kwargs)


@register_runtime('export')
class ExportRuntime(Runtime):
    """A `torch.export` program saved as a ``.pt2`` file: shapes and dtypes
    fixed at export, the kernels as ops.  Loading moves it onto the
    caller's device, so that one artifact serves the CPU and the card."""

    @classmethod
    def load_engine(cls, path, device = None, ** kwargs):
        from torch.export.passes import move_to_device_pass

        _load_kernel_ops()
        program = move_to_device_pass(torch.export.load(path), default_device(device))
        return program.module()

    def __call__(self, * args):
        with torch.no_grad():
            return self.engine(* args)

    @staticmethod
    def export_function(fn, example_args, path, *, static_argnames = None):
        """Trace `fn` at the example arguments (tensors, and dicts or tuples
        of them, such as a parameter tree) with `torch.export` and save the
        program to `path`.  `static_argnames` is the JAX package's: nothing
        needs it here, `torch.export` fixes every argument that is not a
        tensor at its example value."""
        program = _export(fn, example_args)
        directory = os.path.dirname(path)
        if directory: os.makedirs(directory, exist_ok = True)
        torch.export.save(program, path)
        return path


def _signature(args):
    """Shapes, dtypes and devices of the tensors of `args`, in tree order."""
    leaves = torch.utils._pytree.tree_leaves(args)
    return tuple((tuple(t.shape), str(t.dtype), str(t.device)) if torch.is_tensor(t)
                 else repr(t) for t in leaves)


_PLAIN = (type(None), bool, int, float, complex, str, bytes, torch.dtype, torch.device)


def _constant_key(value):
    """`value` as a key that means the same in another process: plain
    constants, tuples, lists and dicts of them, and code objects by their
    bytecode, names and constants; None for anything else (a tensor, a
    model)."""
    if isinstance(value, _PLAIN):
        return (type(value).__name__, repr(value))
    if isinstance(value, types.CodeType):
        consts = _constant_key(value.co_consts)
        return None if consts is None else ('code', value.co_code, value.co_names, consts)
    if isinstance(value, (tuple, list)):
        keys = [_constant_key(v) for v in value]
        return None if None in keys else (type(value).__name__, tuple(keys))
    if isinstance(value, dict):
        keys = [(_constant_key(k), _constant_key(v)) for k, v in value.items()]
        return None if any(None in kv for kv in keys) else ('dict', tuple(keys))
    return None


def _function_key(fn):
    """What decides the program `fn` exports to, besides its arguments:
    its module and name, its code, its defaults and keyword defaults, and
    the values its closure holds; None where one of these is not a plain
    constant (`_constant_key`), and for any callable that is not a Python
    function.  The code that `fn` calls is not part of the key."""
    if not isinstance(fn, types.FunctionType):
        return None
    try:
        closure = tuple(cell.cell_contents for cell in fn.__closure__ or ())
    except ValueError:                                  # a cell not yet assigned
        return None
    parts = [_constant_key(part) for part in (
        fn.__code__, fn.__defaults__, fn.__kwdefaults__, closure)]
    if None in parts:
        return None
    return (fn.__module__, fn.__qualname__, tuple(parts))


def _nbytes(value):
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    if torch.is_tensor(value):
        return value.numel() * value.element_size()
    return 0


@register_runtime('aot')
class AOTRuntime(Runtime):
    """A program exported at the example arguments' shapes (the JAX
    package's ahead-of-time compiled executable): another shape raises.
    With `enable_persistent_compilation_cache` the program is saved as a
    ``.pt2`` file under its directory, keyed by `fn` (`_function_key`: its
    code, defaults and closure values) and the arguments' shapes and
    dtypes, and loaded from there next time; a function that cannot be
    keyed so is exported afresh each time (`cache_file` is None)."""

    def __init__(self, fn, example_args, *, donate_argnums = (), ** kwargs):
        self.path = getattr(fn, '__name__', 'fn')
        self.kwargs = kwargs
        self._example_args = tuple(example_args)
        self._signature = _signature(self._example_args)
        self._flops = None
        cached = self._cache_path(fn)
        if cached is not None and os.path.exists(cached):
            _load_kernel_ops()
            self.program = torch.export.load(cached)
        else:
            self.program = _export(fn, self._example_args)
            if cached is not None:
                torch.export.save(self.program, cached)
        self.cache_file = cached
        self.engine = self.program.module()

    def _cache_path(self, fn):
        directory = _AOT_CACHE['directory']
        if directory is None:
            return None
        identity = _function_key(fn)
        if identity is None:
            logger.info('AOTRuntime %s: not cached (a default or closure value that is not a '
                        'plain constant)', self.path)
            return None
        key = hashlib.sha256(repr((identity, self._signature)).encode()).hexdigest()[:32]
        return os.path.join(directory, '{}-{}.pt2'.format(self.path, key))

    @classmethod
    def load_engine(cls, path, ** kwargs):
        return path

    @property
    def flops(self):
        """Operations of one call at the example arguments, by
        `torch.utils.flop_counter` (products and convolutions, and each
        kernel op by its registered formula)."""
        if self._flops is None:
            from torch.utils.flop_counter import FlopCounterMode
            with torch.no_grad(), FlopCounterMode(display = False) as counter:
                self.engine(* self._example_args)
            self._flops = counter.get_total_flops()
        return self._flops

    @property
    def memory_analysis(self):
        """Bytes of the arguments, of the outputs and of every other value
        the program makes (its temporaries, none freed), from the exported
        graph's node metadata."""
        graph = self.program.graph
        output = next(n for n in graph.nodes if n.op == 'output')
        out_nodes = set(torch.utils._pytree.tree_leaves(output.args))
        val = lambda node: node.meta.get('val')
        return types.SimpleNamespace(
            argument_size_in_bytes = sum(_nbytes(val(n)) for n in graph.nodes
                                         if n.op == 'placeholder'),
            output_size_in_bytes = sum(_nbytes(val(n)) for n in out_nodes
                                       if isinstance(n, torch.fx.Node)),
            temp_size_in_bytes = sum(_nbytes(val(n)) for n in graph.nodes
                                     if n.op == 'call_function' and n not in out_nodes))

    def __call__(self, * args):
        if _signature(args) != self._signature:
            raise ValueError('AOTRuntime {} was exported for {}, got {}'.format(
                self.path, self._signature, _signature(args)))
        with torch.no_grad():
            return self.engine(* args)


@register_runtime('hf')
class HFRuntime(Runtime):
    """A HuggingFace ``transformers`` model (``AutoModel`` by `task`) on
    `device`; ``transformers`` is imported when a model is loaded."""

    @classmethod
    def load_engine(cls, path, task = 'auto', device = None, ** kwargs):
        import transformers
        auto_cls = {
            'auto': transformers.AutoModel,
            'causal-lm': transformers.AutoModelForCausalLM,
            'seq2seq': transformers.AutoModelForSeq2SeqLM,
        }.get(task, transformers.AutoModel)
        model = auto_cls.from_pretrained(path, ** kwargs)
        model.to(default_device(device))
        model.eval()
        return model

    def __call__(self, * args, ** kwargs):
        with torch.no_grad():
            return self.engine(* args, ** kwargs)


def enable_persistent_compilation_cache(directory = None):
    """Persist `AOTRuntime` programs as ``.pt2`` files under `directory`
    (default ``build/aot_cache`` beside the package), so that a program is
    exported once across processes: the JAX package's persistent XLA
    compilation cache."""
    directory = directory or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        'build', 'aot_cache')
    os.makedirs(directory, exist_ok = True)
    _AOT_CACHE['directory'] = directory
    return directory
