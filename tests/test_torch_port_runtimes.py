"""The port's `Runtime` registry (`text_to_speech_tpu_torch.runtimes`)
against the JAX package's (``tests/test_runtimes.py``), on the CPU.

  - ``'torch'`` runs a function in process (the JAX package's ``'jax'``);
  - ``'export'`` saves a `torch.export` program and loads it onto the
    caller's device; the engine cache is keyed by (runtime, path, device);
  - a tiny VITS `infer` exported and loaded: equal to the port's eager call
    to the bit, and within 1e-5 of the JAX package's `ExportRuntime` given
    the JAX draws (its noise handed in as tensors);
  - ``'aot'``: a program at the example shapes (another shape raises), its
    flops and memory from the graph, persisted under
    `enable_persistent_compilation_cache`;
  - ``'hf'``: a tiny GPT-2 built from a config and saved to a temporary
    directory (no network), equal to the JAX package's `HFRuntime`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu import runtimes as jax_runtimes
from text_to_speech_tpu_torch import runtimes
from text_to_speech_tpu_torch.runtimes import (
    AOTRuntime, ExportRuntime, HFRuntime, TorchRuntime, build_runtime, list_runtimes)


def model_fn(params, x):
    return torch.tanh(x @ params['w'] + params['b'])


def jax_model_fn(params, x):
    return jnp.tanh(x @ params['w'] + params['b'])


@pytest.fixture
def params():
    rng = np.random.default_rng(0)
    return {'w': rng.standard_normal((4, 8)).astype(np.float32),
            'b': np.zeros((8,), np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _x():
    return np.linspace(-1., 1., 8, dtype = np.float32).reshape(2, 4)


def test_torch_runtime_call(params):
    rt = TorchRuntime(model_fn)
    out = rt(_torch(params), torch.from_numpy(_x()))
    assert out.shape == (2, 8) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_model_fn(params, _x())), atol = 1e-6)


def test_export_roundtrip_and_engine_cache(params, tmp_path):
    p, x = _torch(params), torch.from_numpy(_x())
    path = str(tmp_path / 'model.pt2')
    assert ExportRuntime.export_function(model_fn, (p, x), path) == path
    rt = build_runtime('export', path, device = 'cpu')
    assert rt is build_runtime('export', path, device = 'cpu')
    assert ('export', path, 'cpu') in runtimes._ENGINE_CACHE
    out = rt(p, x)
    assert torch.equal(out, model_fn(p, x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_model_fn(params, _x())), atol = 1e-6)
    # another device is another engine, moved there at load
    on_meta = build_runtime('export', path, device = 'meta')
    assert on_meta is not rt
    out = on_meta({k: v.to('meta') for k, v in p.items()}, x.to('meta'))
    assert out.device.type == 'meta' and out.shape == (2, 8)


def test_aot_shapes_flops_and_memory(params):
    p, x = _torch(params), torch.from_numpy(_x())
    rt = AOTRuntime(model_fn, (p, x))
    assert torch.equal(rt(p, x), model_fn(p, x))
    assert rt.flops == 2 * 2 * 4 * 8                       # the one product
    memory = rt.memory_analysis
    assert memory.argument_size_in_bytes == (4 * 8 + 8 + 2 * 4) * 4
    assert memory.output_size_in_bytes == 2 * 8 * 4
    assert memory.temp_size_in_bytes == 2 * (2 * 8 * 4)     # the product and the sum
    with pytest.raises(ValueError):
        rt(p, torch.ones((3, 4)))
    jax_rt = jax_runtimes.AOTRuntime(jax_model_fn, (params, _x()))
    assert jax_rt.flops is None or jax_rt.flops > 0


def test_aot_persistent_cache(params, tmp_path, monkeypatch):
    monkeypatch.setitem(runtimes._AOT_CACHE, 'directory', None)
    directory = runtimes.enable_persistent_compilation_cache(str(tmp_path / 'cache'))
    p, x = _torch(params), torch.from_numpy(_x())
    first = AOTRuntime(model_fn, (p, x))
    assert first.cache_file.startswith(directory) and (tmp_path / 'cache').exists()
    again = AOTRuntime(model_fn, (p, x))                    # loaded from the file
    assert again.cache_file == first.cache_file and torch.equal(again(p, x), first(p, x))
    other = AOTRuntime(model_fn, (p, torch.ones((3, 4))))   # another shape, another file
    assert other.cache_file != first.cache_file


def _scaled(scale):
    """Functions of one qualname and one bytecode that differ by a closure
    value, as a dropout flag does."""
    def fn(params, x):
        return model_fn(params, x) * scale
    return fn


def _with_default(scale):
    def fn(params, x, scale = scale):
        return model_fn(params, x) * scale
    return fn


def _with_kwdefault(scale):
    def fn(params, x, *, scale = scale):
        return model_fn(params, x) * scale
    return fn


@pytest.mark.parametrize('make', [_scaled, _with_default, _with_kwdefault])
def test_aot_cache_keys_defaults_and_closures(params, tmp_path, monkeypatch, make):
    monkeypatch.setitem(runtimes._AOT_CACHE, 'directory', None)
    runtimes.enable_persistent_compilation_cache(str(tmp_path / 'cache'))
    p, x = _torch(params), torch.from_numpy(_x())
    one, two = AOTRuntime(make(1.), (p, x)), AOTRuntime(make(2.), (p, x))
    assert one.cache_file is not None and two.cache_file != one.cache_file
    assert torch.equal(two(p, x), 2. * one(p, x))
    assert AOTRuntime(make(2.), (p, x)).cache_file == two.cache_file
    # a closure over a tensor cannot be keyed by value: exported afresh, not cached
    assert AOTRuntime(make(torch.tensor(2.)), (p, x)).cache_file is None


def test_listing_and_unknown():
    assert {'torch', 'export', 'aot', 'hf'} <= set(list_runtimes())
    with pytest.raises(ValueError):
        build_runtime('nope', 'x', device = 'cpu')
    with pytest.raises(ValueError):
        build_runtime('jax', 'x', device = 'cpu')         # the port's is 'torch'


def test_vits_export_matches_jax_export_runtime(tmp_path):
    """The flagship end-to-end family from a saved program: the port's
    export of VITS `infer` against the JAX package's StableHLO artifact,
    both fed the same draws (the JAX ones, from its key).  One layer or
    stage of each kind (flows, duration flows, upsampling, dilations), so
    that both programs stay small; the loaded JAX artifact's call is
    compiled once, at `compile_fast`'s options."""
    from test_torch_port_vits import BASE, SDP, _draw_zero_inits
    from torch_port_gan_util import compile_fast
    from text_to_speech_tpu.models.vits_arch import VITS as JaxVITS
    from text_to_speech_tpu_torch.init import init_vits
    from text_to_speech_tpu_torch.models.vits_arch import VITS
    from text_to_speech_tpu_torch.weights import vits_from_jax
    config = dict(BASE, ** SDP)
    config.update(flow_layers = 1, flow_wn_layers = 1, sdp_n_flows = 1, sdp_dds_layers = 1,
                  upsample_rates = (4,), upsample_kernel_sizes = (8,),
                  resblock_dilation_sizes = ((1,),))
    jax_arch, arch = JaxVITS(** config), VITS(** config)
    jparams = init_vits(arch.hp, seed = 0)                  # the JAX layout, numpy
    _draw_zero_inits(jparams, np.random.default_rng(0))
    tokens = np.array([[3, 5, 7, 9, 11, 2, 0, 0], [4, 6, 8, 0, 0, 0, 0, 0]], np.int32)
    controls = dict(max_frames = 32, min_duration = 3)

    def jax_infer(params, tokens, rng):
        out = jax_arch.infer(params, {}, tokens, rng = rng, ** controls)
        return out.audio, out.lengths

    rng = jax.random.PRNGKey(3)
    jtree = jax.tree_util.tree_map(jnp.asarray, jparams)
    jax_path = str(tmp_path / 'vits.stablehlo')
    jax_runtimes.ExportRuntime.export_function(jax_infer, (jtree, jnp.asarray(tokens), rng),
                                               jax_path)
    jax_rt = jax_runtimes.build_runtime('export', jax_path)
    jax_args = (jtree, jnp.asarray(tokens), rng)
    ref_audio, ref_lengths = compile_fast(jax_rt.engine.call, * jax_args)(* jax_args)
    # the JAX draws: the SDP's noise from the first half of the key's split, the prior's
    # from the second
    k_dur, k_prior = jax.random.split(rng)
    noise = {'sdp': torch.from_numpy(np.array(jax.random.normal(k_dur, tokens.shape + (2,)))),
             'prior': torch.from_numpy(np.array(jax.random.normal(
                 k_prior, (2, 32, config['inter_channels']), jnp.float32)))}

    def infer(params, tokens, noise):
        out = arch.infer(params, {}, tokens, noise = noise, ** controls)
        return out.audio, out.lengths

    params, tokens = vits_from_jax(jparams), torch.from_numpy(tokens).long()
    path = str(tmp_path / 'vits.pt2')
    ExportRuntime.export_function(infer, (params, tokens, noise), path)
    audio, lengths = build_runtime('export', path, device = 'cpu')(params, tokens, noise)
    eager = infer(params, tokens, noise)
    assert torch.equal(audio, eager[0]) and torch.equal(lengths, eager[1])
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_lengths))
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), atol = 1e-5, rtol = 0)
    assert float(np.abs(np.asarray(ref_audio)).max()) > 1e-3


def test_hf_runtime_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv('USE_TF', '0')       # transformers without TensorFlow, if it loads here
    import transformers
    # scikit-learn serves only assisted generation's candidate tuning, which
    # nothing here runs: left unloaded, the model classes load seconds sooner
    from transformers.utils import import_utils
    monkeypatch.setattr(import_utils, '_sklearn_available', False)
    config = transformers.GPT2Config(vocab_size = 64, n_positions = 32, n_embd = 16,
                                     n_layer = 2, n_head = 2)
    torch.manual_seed(0)
    transformers.GPT2LMHeadModel(config).save_pretrained(str(tmp_path))
    rt = build_runtime('hf', str(tmp_path), device = 'cpu', task = 'causal-lm')
    assert isinstance(rt, HFRuntime) and rt.engine.device.type == 'cpu'
    ids = torch.tensor([[1, 5, 9, 2]])
    ref = jax_runtimes.HFRuntime(str(tmp_path), task = 'causal-lm')(ids).logits
    assert torch.equal(rt(ids).logits, ref)
