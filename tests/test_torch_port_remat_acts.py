"""WaveGlow's ``remat='acts'``: the port's `wn_block_acts` against the JAX
package's remat policy.

The tiny WaveGlow of ``test_torch_port_train.py`` (C = 128, 2 WN layers,
4 flows with early outputs every 2, 16 frames, batch 1, float32):

  - loss and gradients of ``remat='acts'`` equal to those without remat,
    and to ``remat=True``'s, to the bit;
  - gradients within 1e-5 of each leaf's largest against the JAX
    package's ``remat='acts'`` (measured 8.5e-7), the loss within 1e-5
    relative;
  - the backward runs no convolution forward again under ``'acts'`` (every
    conv of the flows is recomputed under ``remat=True``);
  - bit-equal to no remat under bfloat16 compute and with one conditioning
    conv a block (NVIDIA's layout), at 3 WN layers and batch 2;
  - what it keeps for the backward: the activation and residual-stream
    tensors that the JAX policy saves by name ('wn_acts', 'wn_x'), and two
    more a block, the start conv's output and the skip sum that the end
    conv reads (the JAX backward recomputes the start and res/skip convs
    for them), counted in bytes of the saved tensors at least C wide.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp
from jax._src.ad_checkpoint import saved_residuals

from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow

from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.weights import flatten_tree, waveglow_from_jax, waveglow_to_jax

CONFIG = dict(n_mel_channels = 8, n_flows = 4, n_group = 8, n_early_every = 2,
              n_early_size = 2, wn_layers = 2, wn_channels = 128,
              upsample_width = 1024, upsample_stride = 256)
FRAMES = 16


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args = (), kwargs = None):
        if func is torch.ops.aten.convolution.default:
            self.convs += 1
        return func(* args, ** (kwargs or {}))


@pytest.fixture(scope = 'module')
def setup():
    arch = WaveGlow(** CONFIG)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((1, FRAMES, 8)) - 5.).astype(np.float32)
    audio = (0.3 * rng.standard_normal((1, FRAMES * 256))).astype(np.float32)
    return arch, params, mel, audio


def _leaf(tree):
    return {k: _leaf(v) if isinstance(v, dict) else v.requires_grad_(True)
            for k, v in tree.items()}


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def _port(setup, remat):
    arch, params, mel, audio = setup
    p = _leaf(waveglow_from_jax(params))
    loss = arch.loss(p, torch.from_numpy(mel), torch.from_numpy(audio), remat = remat)
    counter = _CountConvs()
    with counter:
        loss.backward()
    return float(loss.detach()), flatten_tree(waveglow_to_jax(_grads(p))), counter.convs


def test_acts_equals_no_remat_and_recomputes_no_conv(setup):
    loss, grads, convs = _port(setup, False)
    assert convs == 0
    for remat in (True, 'acts'):
        loss_r, grads_r, convs_r = _port(setup, remat)
        assert loss_r == loss
        for name, g in grads.items():
            np.testing.assert_array_equal(grads_r[name], g, err_msg = name)
        # remat=True runs each flow's 8 convs again: start, and per layer its
        # cond, in and res/skip convs, and end
        assert convs_r == (0 if remat == 'acts' else CONFIG['n_flows'] * 8), (remat, convs_r)


def test_acts_gradients_match_jax(setup):
    _, params, mel, audio = setup
    loss, grads, _ = _port(setup, 'acts')
    arch = JaxWaveGlow(** CONFIG)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref_loss, ref = jax.jit(jax.value_and_grad(lambda p: arch.loss(
        p, jnp.asarray(mel), jnp.asarray(audio), remat = 'acts')))(jparams)
    ref = {k: np.asarray(v) for k, v in flatten_tree(ref).items()}
    assert sorted(grads) == sorted(ref)
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for name, r in ref.items():
        assert float(np.abs(grads[name] - r).max()) <= 1e-5 * float(np.abs(r).max()), name


def _cond_layer(params, n_layers):
    """The per-layer conditioning convs of each block as one conv."""
    for flow in params.values():
        block = flow.get('block')
        if not block: continue
        convs = [block.pop('cond_conv_{}'.format(i)) for i in range(n_layers)]
        block['cond_layer'] = {key: torch.cat([c[key] for c in convs]) for key in convs[0]}
    return params


@pytest.mark.parametrize('variant', ['bfloat16', 'cond_layer'])
def test_acts_equals_no_remat_across_dtypes_and_layouts(variant):
    config = dict(CONFIG, wn_layers = 3)
    arch = WaveGlow(** config)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 2)
    rng = np.random.default_rng(3)
    mel = torch.from_numpy((rng.standard_normal((2, FRAMES, 8)) - 5.).astype(np.float32))
    audio = torch.from_numpy((0.3 * rng.standard_normal((2, FRAMES * 256))).astype(np.float32))
    dtype = torch.bfloat16 if variant == 'bfloat16' else None
    out = {}
    for remat in (False, 'acts'):
        tree = waveglow_from_jax(params)
        if variant == 'cond_layer':
            tree = _cond_layer(tree, config['wn_layers'])
        p = _leaf(tree)
        loss = arch.loss(p, mel, audio, remat = remat, compute_dtype = dtype)
        loss.backward()
        out[remat] = float(loss.detach()), flatten_tree(_grads(p))
    assert out['acts'][0] == out[False][0]
    for name, g in out[False][1].items():
        assert torch.equal(out['acts'][1][name], g), name


def test_acts_keeps_the_jax_policy_tensors_and_two_more_a_block(setup):
    _, params, mel, audio = setup
    rows, C = FRAMES * 256 // CONFIG['n_group'], CONFIG['wn_channels']
    p = _leaf(waveglow_from_jax(params))
    weights = {t.untyped_storage().data_ptr() for t in flatten_tree(p).values()}
    spect_bytes = rows * CONFIG['n_mel_channels'] * CONFIG['n_group'] * 4
    saved, spect_copies = {}, set()

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() in weights:
            return t
        if storage.nbytes() >= rows * C * t.element_size():
            saved[storage.data_ptr()] = storage.nbytes()
        elif storage.nbytes() == spect_bytes:
            spect_copies.add(storage.data_ptr())
        return t

    arch = WaveGlow(** CONFIG)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        arch.loss(p, torch.from_numpy(mel), torch.from_numpy(audio), remat = 'acts')
    jarch = JaxWaveGlow(** CONFIG)
    residuals = saved_residuals(lambda p: jarch.loss(
        p, jnp.asarray(mel), jnp.asarray(audio), remat = 'acts'),
        jax.tree_util.tree_map(jnp.asarray, params))
    wide = [a for a, _ in residuals if a.ndim >= 2 and a.shape[-2] == rows and a.shape[-1] >= C]
    jax_bytes = sum(a.size * a.dtype.itemsize for a in wide)
    L, n_flows = CONFIG['wn_layers'], CONFIG['n_flows']
    # per block the JAX policy keeps L activations (2C) and L - 1 streams (C)
    assert jax_bytes == n_flows * (2 * L + L - 1) * C * rows * 4
    assert sum(saved.values()) == jax_bytes + n_flows * 2 * C * rows * 4
    # every conditioning conv of every flow reads one copy of the conditioning
    assert len(spect_copies) == 1
