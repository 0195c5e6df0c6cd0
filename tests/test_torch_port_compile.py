"""The port's `compile.py` and `xp.py` against the JAX package's, and the
utilities that now take tensors through `xp` (`utils.distances`,
`utils.sequence_utils.pad_to_multiple`) against the JAX ones on JAX arrays.

`graph_compile` keeps the JAX API and its behaviour around the call
(signature binding, `TensorSpec` casts, static arguments, the
`prepare_for_xla` bucketing hook, the eager context) and compiles nothing;
`execute_eagerly` is a `torch.library` op inside an exported program, as
the JAX one is a `pure_callback` inside jit.  The cases are those of
``tests/test_periphery2.py`` (`TestGraphCompile`).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu import compile as jax_compile
from text_to_speech_tpu import xp as jax_xp
from text_to_speech_tpu.utils import distances as jax_distances
from text_to_speech_tpu.utils.sequence_utils import pad_to_multiple as jax_pad_to_multiple
from text_to_speech_tpu_torch import compile as port_compile
from text_to_speech_tpu_torch import xp
from text_to_speech_tpu_torch.utils import distances
from text_to_speech_tpu_torch.utils.sequence_utils import pad_to_multiple

PACKAGES = {'jax': jax_compile,
            'port': functools.partial(port_compile.graph_compile, device = 'cpu')}


def _both(build):
    """`build(graph_compile, TensorSpec, module)` for the JAX package and the
    port (on the CPU)."""
    return (build(jax_compile.graph_compile, jax_compile.TensorSpec, jax_compile),
            build(PACKAGES['port'], port_compile.TensorSpec, port_compile))


def _np(value):
    return value.detach().numpy() if torch.is_tensor(value) else np.asarray(value)


def test_compiles_and_casts():
    def build(graph_compile, TensorSpec, _):
        @graph_compile
        def f(x: TensorSpec(dtype = 'float32'), scale: TensorSpec(static = True) = 2):
            return x * scale
        return f

    ref, f = _both(build)
    out = f(np.array([1, 2], np.int64), scale = 3)
    assert torch.is_tensor(out) and out.dtype == torch.float32
    np.testing.assert_array_equal(_np(out), _np(ref(np.array([1, 2], np.int64), scale = 3)))
    assert f.static_argnames == ref.static_argnames == ('scale',)
    assert f.compiled_fn is f.eager_fn                      # nothing compiled
    # a tensor keeps its device; the cast changes only its dtype
    assert f(torch.tensor([1, 2]), scale = 2).dtype == torch.float32


def test_eager_context_bypasses():
    def build(graph_compile, TensorSpec, module):
        calls = []

        @graph_compile
        def f(x: TensorSpec(dtype = 'float32')):
            calls.append(type(x).__module__.split('.')[0])
            return x + 1
        return f, calls, module

    (ref, ref_calls, jax_module), (f, calls, module) = _both(build)
    with module.EagerExecution():
        out = f(np.ones(2, np.int32))
        assert module.is_eager()
    with jax_module.EagerExecution():
        ref_out = ref(np.ones(2, np.int32))
    assert not module.is_eager()
    # the raw function on the raw argument: numpy in, numpy out, no cast
    assert isinstance(out, np.ndarray) and out.dtype == np.int32 and calls == ['numpy']
    np.testing.assert_array_equal(out, _np(ref_out))
    with module.XLAExecution():
        assert torch.is_tensor(f(np.ones(2)))


def test_prepare_hook_bucketing():
    def build(graph_compile, TensorSpec, module):
        @graph_compile(prepare_for_xla = module.pad_to_multiple_hook('x', 4, axis = 0))
        def f(x: TensorSpec()):
            return x.shape[0]
        return f

    ref, f = _both(build)
    assert int(f(np.ones(6, np.float32))) == int(ref(np.ones(6, np.float32))) == 8
    assert int(f(torch.ones(6))) == 8                     # a tensor is padded as a tensor
    with port_compile.EagerExecution():
        assert f(np.ones(6, np.float32)) == 6


def test_execute_eagerly_in_an_exported_program():
    calls = []

    def host(x):
        calls.append(type(x))
        return np.asarray(x) * 2.

    jax_fn = jax_compile.execute_eagerly(output_shape = (3,), output_dtype = 'float32')(host)
    ref = jax.jit(lambda x: jax_fn(x) + 1.)(jnp.arange(3.))
    port_fn = port_compile.execute_eagerly(output_shape = (3,), output_dtype = 'float32')(host)
    assert port_fn.python_fn is host

    class Module(torch.nn.Module):
        def forward(self, x):
            return port_fn(x) + 1.

    program = torch.export.export(Module(), (torch.zeros(3),))
    assert any(str(n.target).startswith('tts_torch.host_host')
               for n in program.graph.nodes if n.op == 'call_function')
    out = program.module()(torch.arange(3.))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert calls[-1] is np.ndarray                        # the host got numpy
    # an unknown output shape: the direct host call (the JAX eager fallback)
    loose = port_compile.execute_eagerly(output_shape = (None,))(host)
    np.testing.assert_array_equal(loose(torch.ones(2)).numpy(), [2., 2.])


# -- xp -------------------------------------------------------------------------

_A = np.arange(12, dtype = np.float32).reshape(3, 4) / 7.
_B = np.linspace(-1., 1., 8, dtype = np.float32).reshape(4, 2)

XP_CASES = {
    'matmul': lambda m, a, b: m.matmul(a, b),
    'sum_axis': lambda m, a, b: m.sum(a, axis = -1),
    'sqrt_square': lambda m, a, b: m.sqrt(m.square(a)),
    'pad': lambda m, a, b: m.pad(a, [(1, 0), (0, 2)], mode = 'constant', constant_values = 3.),
    'concatenate': lambda m, a, b: m.concatenate([a, a], axis = 1),
    'stack': lambda m, a, b: m.stack([a, a], axis = 0),
    'where_scalars': lambda m, a, b: m.where(a > 0.5, a, 0.),
    'maximum_scalar': lambda m, a, b: m.maximum(a, 0.7),
    'minimum_scalar': lambda m, a, b: m.minimum(0.3, a),
    'asarray_dtype': lambda m, a, b: m.asarray(a, dtype = 'int32'),
    'clip': lambda m, a, b: m.clip(a, 0.2, 1.),
    'mean_keepdims': lambda m, a, b: m.mean(a, axis = 0, keepdims = True),
}


@pytest.mark.parametrize('name', sorted(XP_CASES))
def test_xp_matches_jax_xp(name):
    case = XP_CASES[name]
    ref_np, ref_jax = case(jax_xp, _A, _B), case(jax_xp, jnp.asarray(_A), jnp.asarray(_B))
    out_np = case(xp, _A, _B)
    out_t = case(xp, torch.from_numpy(_A), torch.from_numpy(_B))
    assert isinstance(out_np, np.ndarray) and isinstance(ref_np, np.ndarray)
    assert torch.is_tensor(out_t)
    np.testing.assert_array_equal(out_np, ref_np)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_jax), atol = 1e-6, rtol = 0)
    assert out_t.numpy().dtype == np.asarray(ref_jax).dtype


def test_xp_conversions():
    t = xp.convert_to_tensor(_A, device = 'cpu')
    assert torch.is_tensor(t) and xp.is_tensor(t) and not xp.is_tensor(_A)
    assert xp.convert_to_tensor([1, 2], dtype = 'float32', device = 'cpu').dtype == torch.float32
    np.testing.assert_array_equal(xp.convert_to_numpy(t), np.asarray(jax_xp.convert_to_numpy(_A)))
    if torch.cuda.is_available():
        assert xp.convert_to_tensor(_A).device.type == 'cuda'
    else:                                   # the port's default device is the card
        with pytest.raises(RuntimeError):
            xp.convert_to_tensor(_A)


# -- distances and pad_to_multiple on tensors ---------------------------------------

@pytest.mark.parametrize('as_matrix', [False, True])
def test_distances_take_tensors(as_matrix):
    rng = np.random.default_rng(0)
    x = rng.random((3, 5)).astype(np.float32)
    y = rng.random((3 if not as_matrix else 4, 5)).astype(np.float32)
    for method in distances.list_metrics():
        ref = np.asarray(jax_distances.distance(jnp.asarray(x), jnp.asarray(y), method = method,
                                                as_matrix = as_matrix))
        out = distances.distance(torch.from_numpy(x), torch.from_numpy(y), method = method,
                                 as_matrix = as_matrix)
        mixed = distances.distance(torch.from_numpy(x), y, method = method,
                                   as_matrix = as_matrix)
        host = distances.distance(x, y, method = method, as_matrix = as_matrix)
        assert torch.is_tensor(out) and torch.is_tensor(mixed) and isinstance(host, np.ndarray)
        for got in (out.numpy(), mixed.numpy(), host):
            np.testing.assert_allclose(got, ref, atol = 1e-6, rtol = 0, err_msg = method)


def test_pad_to_multiple_takes_tensors():
    data = np.arange(10, dtype = np.float32).reshape(2, 5)
    ref = np.asarray(jax_pad_to_multiple(jnp.asarray(data), 4, axis = 1, constant_values = -1.))
    out = pad_to_multiple(torch.from_numpy(data), 4, axis = 1, constant_values = -1.)
    assert torch.is_tensor(out)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(pad_to_multiple(data, 4, axis = 1, constant_values = -1.), ref)
    same = torch.ones(2, 8)
    assert pad_to_multiple(same, 4, axis = 1) is same
