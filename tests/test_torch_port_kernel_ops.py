"""K1, K2 and K3 as `torch.library` ops (``torch.ops.tts_torch``) on the
exported paths.

On the CPU each op runs its plain version; `torch.export` holds it as one
node, and the exported program equals the eager call to the bit:

  - a tiny WaveGlow's vocode on the bf16 (K1) and the int8 (K2) route, and
    the bf16 route within 1e-4 of scale of the JAX `WaveGlow` on its Pallas
    route, the JAX kernel run in interpret mode;
  - Tacotron-2's `decode_chunk` on K3 at 10 rows (two row groups), exported
    at step 0 with one seed and run at step 64 with another: equal to eager
    there (the step offset and the seed are inputs, not constants);
  - the fake implementations give the real outputs' shapes and dtypes, and
    each op's flop formula equals the count the bounds use.

The `cuda` cases export on the card: one launch a block or a chunk,
counted inside the exported program, and its output bit-equal to eager.
JAX is imported inside the CPU test that needs it, so that

    python -m pytest tests/test_torch_port_kernel_ops.py -m cuda --noconftest

runs the `cuda` cases on a machine without JAX.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.init import init_tacotron2, init_waveglow
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
from text_to_speech_tpu_torch.ops import decoder_kernel as dk
from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block, wn_block_work
from text_to_speech_tpu_torch.ops.wn_block_int8 import fused_wn_block_int8, wn_block_int8_work
from text_to_speech_tpu_torch.weights import tacotron2_from_jax, tree_to, waveglow_from_jax

# K1's and K2's envelope on the card: C % 128, S = n_mel * n_group % 64, L >= 2
WAVEGLOW = dict(n_mel_channels = 16, n_flows = 2, n_group = 8, n_early_every = 1,
                n_early_size = 2, wn_layers = 2, wn_channels = 128, upsample_width = 64,
                upsample_stride = 64)
TACOTRON = dict(vocab_size = 24, n_mel_channels = 8, encoder_embedding_dim = 16,
                encoder_n_conv = 1, encoder_kernel_size = 3, prenet_sizes = (8, 8),
                lsa_attention_dim = 8, lsa_attention_filters = 4,
                lsa_attention_kernel_size = 31, attention_rnn_dim = 16, decoder_rnn_dim = 16,
                postnet_n_conv = 2, postnet_filters = 8, postnet_kernel_size = 3)


@pytest.fixture(scope = 'module')
def waveglow():
    arch = WaveGlow(** WAVEGLOW)
    jparams = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    return arch, jparams, waveglow_from_jax(jparams)


@pytest.fixture(scope = 'module')
def tacotron():
    arch = Tacotron2(** TACOTRON)
    jparams, jstate = init_tacotron2(arch.hp, seed = 0)
    jparams['decoder']['gate_layer']['bias'][:] = -4.
    return arch, tacotron2_from_jax(jparams, jstate)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, * args):
        return self.fn(* args)


def _export(fn, args):
    return torch.export.export(_Fn(fn), tuple(args))


def _op_nodes(program, name):
    return [n for n in program.graph.nodes
            if n.op == 'call_function' and str(n.target) == 'tts_torch.{}.default'.format(name)]


def _equal(a, b):
    a, b = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _vocode_inputs(arch, frames, seed = 1, device = 'cpu'):
    rng = np.random.default_rng(seed)
    lg = frames * arch.hp.upsample_stride // arch.hp.n_group
    mel = rng.standard_normal((1, frames, arch.hp.n_mel_channels)).astype(np.float32)
    z = rng.standard_normal((1, lg, arch.hp.n_group)).astype(np.float32)
    return torch.from_numpy(mel).to(device), torch.from_numpy(z).to(device)


def _vocode(arch, params, mel, z):
    return arch.infer(params, mel, z = z, use_kernel = True)


def _routes(arch, params):
    return {'bf16': ('wn_block', arch.pack_kernel_params(params)),
            'int8': ('wn_block_int8', arch.quantize_kernel_params(params))}


# -- the exported vocode -------------------------------------------------------------

@pytest.mark.parametrize('route', ['bf16', 'int8'])
def test_exported_vocode_holds_the_op_and_equals_eager(waveglow, route):
    arch, _, params = waveglow
    op, packed = _routes(arch, params)[route]
    mel, z = _vocode_inputs(arch, 4)
    fn = functools.partial(_vocode, arch)
    program = _export(fn, (packed, mel, z))
    assert len(_op_nodes(program, op)) == arch.hp.n_flows
    with torch.no_grad():
        eager = fn(packed, mel, z)
        out = program.module()(packed, mel, z)
        other = _vocode_inputs(arch, 4, seed = 2)   # the program takes new inputs
        assert torch.equal(program.module()(packed, * other), fn(packed, * other))
    assert torch.equal(out, eager) and float(out.abs().max()) > 0.
    assert fused_wn_block.launches == 0 and fused_wn_block_int8.launches == 0


def test_exported_vocode_matches_jax_pallas_interpret(waveglow, monkeypatch):
    """The bf16 K1 route exported, against the JAX `WaveGlow` on its Pallas
    route (the whole-block kernel in interpret mode; it takes the block
    kernel at a grouped length that is a multiple of 512).  The JAX route
    runs bf16 buffers for float32 callers, as the port's bf16 route does,
    rounding at the same places; a float32 sum taken in another order can
    move one bf16 rounding, so the bound is 1e-4 of the waveform's scale
    (measured 4.2e-5 with these seeds; the float32 route is 1.2e-4 away).
    The JAX route is compiled once, at `compile_fast`'s options."""
    import jax
    import jax.numpy as jnp
    from torch_port_gan_util import compile_fast
    from text_to_speech_tpu.models.waveglow_arch import WaveGlow as JaxWaveGlow
    from text_to_speech_tpu.ops import pallas_kernels
    monkeypatch.setattr(pallas_kernels, 'fused_wn_block',
                        functools.partial(pallas_kernels.fused_wn_block, interpret = True))
    arch, jparams, params = waveglow
    jax_arch = JaxWaveGlow(** WAVEGLOW)
    mel, z = _vocode_inputs(arch, 64)
    jtree = jax.tree_util.tree_map(jnp.asarray, jparams)
    jax_args = (jax_arch.pack_pallas_params(jtree), jnp.asarray(mel.numpy()),
                jnp.asarray(z.numpy()))
    jax_infer = lambda p, m, noise: jax_arch.infer(p, m, z = noise, use_pallas = True)
    ref = np.asarray(compile_fast(jax_infer, * jax_args)(* jax_args))
    packed = arch.pack_kernel_params(params)
    program = _export(functools.partial(_vocode, arch), (packed, mel, z))
    with torch.no_grad():
        out = program.module()(packed, mel, z).numpy()
    scale = float(np.abs(ref).max())
    assert out.shape == ref.shape and scale > 1e-2
    np.testing.assert_allclose(out, ref, atol = 1e-4 * scale, rtol = 0)


# -- the exported decode chunk ----------------------------------------------------------

def _chunk_inputs(arch, params, state, B, S):
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, TACOTRON['vocab_size'], (B, S))).to(params['decoder']['gate_layer']['weight'].device)
    with torch.no_grad():
        enc, mask = arch.encode(params, state, tokens)
        memory, pm = arch.process_memory(params['decoder'], enc, mask)
    zero = (torch.zeros((B, arch.hp.n_mel_channels), device = memory.device),
            arch.init_cell_state(B, S, device = memory.device))
    return zero, memory, pm, mask


def _chunk(arch, params, weights, frame, cell, memory, pm, mask, seed, step0):
    return arch.decode_chunk(params, frame, cell, memory, pm, mask, n_steps = 8,
                             deterministic = False, weights = weights, seed = seed,
                             step_offset = step0)


def test_exported_chunk_serves_other_steps_and_seeds(tacotron):
    arch, (params, state) = tacotron
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = arch.hp.n_mel_channels)
    zero, memory, pm, mask = _chunk_inputs(arch, params, state, 10, 16)
    seed = lambda v: torch.tensor([v], dtype = torch.int64)
    fn = functools.partial(_chunk, arch)
    args = lambda s, offset: (params, weights, * zero, memory, pm, mask, seed(s), seed(offset))
    program = _export(fn, args(1, 0))
    assert len(_op_nodes(program, 'decoder_steps')) == 2         # two groups of <= 8 rows
    with torch.no_grad():
        runs = {(s, offset): (program.module()(* args(s, offset)), fn(* args(s, offset)))
                for s, offset in ((1, 0), (2, 64))}
    for out, eager in runs.values():
        assert _equal(out, eager)
    # the offset and the seed reach the dropout: another step draws other masks
    assert not torch.equal(runs[1, 0][0][0], runs[2, 64][0][0])
    assert dk.decoder_steps.launches == 0


# -- fake implementations and flop formulas -------------------------------------------

def _k1_args(B = 2, T = 12, C = 8, S = 16, L = 3):
    f = lambda * shape: 0.1 * torch.randn(shape, generator = torch.Generator().manual_seed(4))
    return (f(B, T, C), f(B, T, S), f(L, 3 * C + S, 2 * C), f(L, 2 * C), f(L - 1, C, 2 * C),
            f(L - 1, 2 * C), f(C, C), f(C))


def _k2_args(B = 2, T = 12, C = 8, S = 16, L = 3):
    from text_to_speech_tpu_torch.ops.wn_block_int8 import pack_wn_int8, quantize_wn_weights
    x, spect, w_in_cond, b_in_cond, w_rs, b_rs, w_rs_last, b_rs_last = _k1_args(B, T, C, S, L)
    q = pack_wn_int8(quantize_wn_weights({
        'w_in': w_in_cond[:, :3 * C].reshape(L, 3, C, 2 * C), 'w_cond': w_in_cond[:, 3 * C:],
        'b_in': b_in_cond, 'b_cond': b_in_cond, 'w_rs': w_rs, 'b_rs': b_rs,
        'w_rs_last': w_rs_last, 'b_rs_last': b_rs_last}))
    return x, spect, q


def _k3_call(arch, params, state, B = 3, S = 16, n_steps = 5):
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = arch.hp.n_mel_channels)
    _, memory, pm, mask = _chunk_inputs(arch, params, state, B, S)
    st = dk.init_decoder_state(B, S, memory.shape[-1], arch.hp.attention_rnn_dim,
                               arch.hp.n_mel_channels)
    inputs = (weights, memory.contiguous(), pm.contiguous(), mask.float(),
              mask.sum(dim = 1).to(torch.int32), torch.zeros((B, arch.hp.prenet_sizes[0])))
    return lambda: dk.decoder_steps(* inputs, st, torch.zeros((1,), dtype = torch.int64),
                                    n_steps = n_steps, deterministic = True)[:2], weights


@pytest.mark.parametrize('kernel', ['wn_block', 'wn_block_int8', 'decoder_steps'])
def test_fake_shapes_and_flop_formulas(tacotron, kernel):
    from torch._subclasses.fake_tensor import FakeTensorMode
    if kernel == 'decoder_steps':
        arch, (params, state) = tacotron
        call, weights = _k3_call(arch, params, state)
        n_mel, P0 = weights['w0'].shape
        U, A = weights['q_w'].shape
        count = sum(dk.decoder_steps_ops(3, 16, 5, n_mel, P0, weights['w1'].shape[1], U, A,
                                         weights['proj_w'].shape[0] - U))
    elif kernel == 'wn_block':
        args = _k1_args()
        call = lambda: fused_wn_block(* args)
        count = wn_block_work(2, 12, 8, 16, 3, 4)[0]
    else:
        args = _k2_args()
        call = lambda: fused_wn_block_int8(* args)
        count = wn_block_int8_work(2, 12, 8, 16, 3, 4)[0]
    real = call()
    with FakeTensorMode(allow_non_fake_inputs = True):
        fake = call()
    leaves = lambda t: torch.utils._pytree.tree_leaves(t)
    assert [(tuple(t.shape), t.dtype) for t in leaves(fake)] \
        == [(tuple(t.shape), t.dtype) for t in leaves(real)]
    with FlopCounterMode(display = False) as counter:
        call()
    assert counter.get_flop_counts()['Global'][getattr(torch.ops.tts_torch, kernel)] == count


@pytest.mark.parametrize('diagnostic', ['stamps', 'prenet_out'])
def test_plain_version_refuses_the_kernels_diagnostics(tacotron, diagnostic):
    """Every K3 call goes through the op; on CPU tensors it runs the plain
    version, which has no clock stamps and no prenet read-back: it raises."""
    arch, (params, state) = tacotron
    B, S, K = 3, 16, 5
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = arch.hp.n_mel_channels)
    _, memory, pm, mask = _chunk_inputs(arch, params, state, B, S)
    st = dk.init_decoder_state(B, S, memory.shape[-1], arch.hp.attention_rnn_dim,
                               arch.hp.n_mel_channels)
    out = {'stamps': torch.zeros((dk.stamps_size(K),), dtype = torch.int64),
           'prenet_out': torch.zeros((B, arch.hp.prenet_sizes[1]))}[diagnostic]
    with pytest.raises(ValueError, match = 'CUDA kernel only'):
        dk.decoder_steps(weights, memory.contiguous(), pm.contiguous(), mask.float(),
                         mask.sum(dim = 1).to(torch.int32),
                         torch.zeros((B, arch.hp.prenet_sizes[0])), st,
                         torch.zeros((1,), dtype = torch.int64), n_steps = K,
                         deterministic = True, ** {diagnostic: out})
    assert dk.decoder_steps.launches == 0


# -- on the card ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('route', ['bf16', 'int8'])
def test_exported_vocode_launches_on_the_card(cuda_device, waveglow, route):
    arch, _, params = waveglow
    op, packed = _routes(arch, tree_to(params, cuda_device))[route]
    counter = {'wn_block': fused_wn_block, 'wn_block_int8': fused_wn_block_int8}[op]
    mel, z = _vocode_inputs(arch, 16, device = cuda_device)
    fn = functools.partial(_vocode, arch)
    program = _export(fn, (packed, mel, z))
    with torch.no_grad():
        eager = fn(packed, mel, z)
        before = counter.launches
        out = program.module()(packed, mel, z)
        torch.cuda.synchronize()
    assert counter.launches == before + arch.hp.n_flows
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_exported_chunk_launches_on_the_card(cuda_device, tacotron):
    arch, (params, state) = tacotron
    params, state = tree_to(params, cuda_device), tree_to(state, cuda_device)
    weights = dk.kernel_weights_only(dk.pack_decoder_weights(
        params['decoder'], n_mel = arch.hp.n_mel_channels))
    zero, memory, pm, mask = _chunk_inputs(arch, params, state, 10, 16)
    seed = lambda v: torch.tensor([v], dtype = torch.int64, device = cuda_device)
    offset = lambda v: torch.tensor([v], dtype = torch.int64)
    fn = functools.partial(_chunk, arch)
    args = lambda s, o: (params, weights, * zero, memory, pm, mask, seed(s), offset(o))
    program = _export(fn, args(1, 0))
    with torch.no_grad():
        for s, o in ((1, 0), (2, 64)):
            before = dk.decoder_steps.launches
            out = program.module()(* args(s, o))
            torch.cuda.synchronize()
            assert dk.decoder_steps.launches == before + 2
            assert _equal(out, fn(* args(s, o)))


@pytest.mark.cuda
def test_chunk_exported_on_the_cpu_is_refused_on_the_card(cuda_device, tacotron):
    """A chunk exported on the CPU holds the LSTM weights in their plain
    layout; on the card the op runs the kernel, which takes its slabs
    only: it raises and launches nothing."""
    from torch.export.passes import move_to_device_pass
    arch, (params, state) = tacotron
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = arch.hp.n_mel_channels)
    zero, memory, pm, mask = _chunk_inputs(arch, params, state, 4, 16)
    seed = torch.tensor([1], dtype = torch.int64)
    fn = functools.partial(_chunk, arch)
    args = (params, weights, * zero, memory, pm, mask, seed, torch.zeros((1,), dtype = torch.int64))
    program = move_to_device_pass(_export(fn, args), cuda_device)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda_device), args[:-1]) \
        + (args[-1],)
    before = dk.decoder_steps.launches
    with torch.no_grad(), pytest.raises(ValueError, match = 'plain layout'):
        program.module()(* on_card)
    assert dk.decoder_steps.launches == before
