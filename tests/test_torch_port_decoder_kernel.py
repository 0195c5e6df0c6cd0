"""The fused decoder steps: the port's plain version and `infer_fused`
against the JAX package's TPU kernel, and the CUDA kernel against the plain
version.

One tiny Tacotron-2 (the widths of ``tests/test_decoder_kernel.py``) with
weights drawn from a numpy seed, handed to both packages.  On the CPU the
JAX kernel runs in Pallas interpret mode, deterministic (the two packages'
dropout bits differ by design), in float32:

  - `decoder_steps_plain` against JAX `decoder_steps`: frames, gates and
    alignments within 1e-4 (float32 on both sides, sums in another order);
  - the port's `infer_fused` against JAX `infer_fused`: mel and gates within
    5e-4 (the tolerance of the JAX package's own fused-vs-plain tests),
    lengths equal.

Dropout is held to its distribution and to its own contract (same seed, same
frames; the mask does not depend on how the steps are split into launches).

The `cuda` cases launch the kernel and hold it against `decoder_steps_plain`
on the same inputs; they skip without a card.  JAX is imported inside the
CPU tests only, so that on a machine with a card and without JAX the `cuda`
cases run alone:

    python -m pytest tests/test_torch_port_decoder_kernel.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.init import init_tacotron2
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
from text_to_speech_tpu_torch.ops import decoder_kernel as dk
from text_to_speech_tpu_torch.weights import cast_tree, tacotron2_from_jax, tree_to

VOCAB = 24
TINY = dict(
    vocab_size = VOCAB, n_mel_channels = 8, encoder_embedding_dim = 16,
    encoder_n_conv = 1, encoder_kernel_size = 3, prenet_sizes = (8, 8),
    lsa_attention_dim = 8, lsa_attention_filters = 4, lsa_attention_kernel_size = 31,
    attention_rnn_dim = 16, decoder_rnn_dim = 16, postnet_n_conv = 2,
    postnet_filters = 8, postnet_kernel_size = 3)


def _tokens(B, S, short_row = True):
    tokens = np.random.default_rng(1).integers(1, VOCAB, (B, S)).astype(np.int32)
    if short_row and B > 1:
        tokens[1, S - S // 4:] = 0          # unequal encoder lengths
    return tokens


@pytest.fixture(scope = 'module')
def model():
    arch = Tacotron2(** TINY)
    jparams, jstate = init_tacotron2(arch.hp, seed = 0)
    # a random stop gate fires at once: bias it off, so that lengths grow
    jparams['decoder']['gate_layer']['bias'][:] = -4.
    params, state = tacotron2_from_jax(jparams, jstate)
    return arch, (jparams, jstate), (params, state)


def _jax(tree):
    import jax.numpy as jnp
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _step_inputs(arch, params, state, tokens, dtype = torch.float32, device = 'cpu'):
    """The arguments of `decoder_steps` for `tokens`, as `infer_fused` makes them."""
    params, state = tree_to(params, device), tree_to(state, device)
    if dtype != torch.float32:
        params, state = cast_tree(params, dtype), cast_tree(state, dtype)
    tokens = torch.from_numpy(tokens).long().to(device)
    with torch.no_grad():
        enc, enc_mask = arch.encode(params, state, tokens)
        mem, pm = arch.process_memory(params['decoder'], enc, enc_mask)
    weights = dk.pack_decoder_weights(params['decoder'], n_mel = arch.hp.n_mel_channels,
                                      dtype = dtype)
    B, S = tokens.shape
    extra = torch.zeros((B, arch.hp.prenet_sizes[0]), device = device)
    new_state = lambda: dk.init_decoder_state(
        B, S, mem.shape[-1], arch.hp.attention_rnn_dim, arch.hp.n_mel_channels, dtype, device)
    args = (weights, mem.contiguous(), pm.contiguous(), enc_mask.float(),
            enc_mask.sum(dim = 1).to(torch.int32), extra)
    return args, new_state


def _seed(value, device = 'cpu'):
    return torch.tensor([value], dtype = torch.int64, device = device)


# -- against the JAX package -------------------------------------------------------

def test_plain_matches_tpu_kernel_interpret(model):
    import jax.numpy as jnp
    from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
    from text_to_speech_tpu.ops import decoder_kernel as jdk
    arch, (jparams, jstate), (params, state) = model
    jarch = JaxTacotron2(** TINY)
    jparams, jstate = _jax(jparams), _jax(jstate)
    B, S, K = 2, 32, 4
    tokens = _tokens(B, S)

    enc, mask, _ = jarch.encode(jparams, jstate, jnp.asarray(tokens), train = False)
    memory, pm = jarch.process_memory(jparams['decoder'], enc, mask)
    pad8 = lambda x: jnp.concatenate(
        [x, jnp.zeros((8 - B,) + x.shape[1:], x.dtype)], axis = 0)
    A = TINY['lsa_attention_dim']
    w = jdk.pack_decoder_weights(jparams['decoder'], n_mel = 8, dtype = jnp.float32)
    st = jdk.init_decoder_state(S, memory.shape[-1], TINY['attention_rnn_dim'], jnp.float32)
    ref_steps, ref_attn, _ = jdk.decoder_steps(
        w, jnp.transpose(pad8(memory), (1, 0, 2)),
        jnp.transpose(pad8(pm), (1, 0, 2)).reshape(S, 8 * A),
        jnp.transpose(pad8(mask).astype(jnp.float32)),
        jnp.sum(pad8(mask).astype(jnp.int32), axis = 1)[None, :],
        jnp.zeros((8, TINY['prenet_sizes'][0]), jnp.float32), st,
        jnp.zeros((1,), jnp.int32), n_steps = K, deterministic = True,
        gate_lane = 8, interpret = True)

    args, new_state = _step_inputs(arch, params, state, tokens)
    steps, attn, _ = dk.decoder_steps_plain(* args, new_state(), _seed(0), n_steps = K,
                                            deterministic = True)
    assert steps.shape == (K, B, 9) and attn.shape == (K, B, S)
    np.testing.assert_allclose(steps.numpy(), np.asarray(ref_steps)[:, :B, :9],
                               atol = 1e-4, rtol = 0)
    np.testing.assert_allclose(attn.numpy(),
                               np.transpose(np.asarray(ref_attn), (0, 2, 1))[:, :B],
                               atol = 1e-4, rtol = 0)


@pytest.mark.parametrize('S,max_length,window', [
    (32, 16, None),          # two whole launches of 8 steps
    (32, 16, 8),             # the sliding attention window
    (32, 12, None),          # max_length no multiple of the launch
    (8, 16, None),           # memory shorter than the location conv's reach
])
def test_infer_fused_matches_jax(model, S, max_length, window):
    import jax.numpy as jnp
    from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
    arch, (jparams, jstate), (params, state) = model
    tokens = _tokens(2, S)
    kw = dict(deterministic = True, early_stopping = False, max_length = max_length,
              attn_mask_win_len = window, chunk = 8)
    ref = JaxTacotron2(** TINY).infer_fused(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), interpret = True, ** kw)
    with torch.no_grad():
        out = arch.infer_fused(params, state, torch.from_numpy(tokens).long(), ** kw)
    assert out.mel.shape == (2, max_length, 8)
    np.testing.assert_allclose(out.mel.numpy(), np.asarray(ref.mel), atol = 5e-4, rtol = 0)
    np.testing.assert_allclose(out.stop_tokens.numpy(), np.asarray(ref.stop_tokens),
                               atol = 5e-4, rtol = 0)
    np.testing.assert_allclose(out.attention_weights.numpy(),
                               np.asarray(ref.attention_weights), atol = 5e-4, rtol = 0)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert int(out.lengths.max()) == max_length


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_lstm_weights_is_bit_identical(model, dtype):
    """From the packed weights in the compute dtype, as the JAX package
    quantizes them."""
    import jax.numpy as jnp
    from text_to_speech_tpu.ops import decoder_kernel as jdk
    arch, (jparams, _), (params, _) = model
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jdk.quantize_lstm_weights(
        jdk.pack_decoder_weights(_jax(jparams)['decoder'], n_mel = 8, dtype = jdt))
    out = dk.quantize_lstm_weights(dk.pack_decoder_weights(
        cast_tree(params['decoder'], tdt), n_mel = 8, dtype = tdt))
    for key in ('att_w', 'dec_w', 's_att_w', 's_dec_w'):
        value = np.asarray(ref[key])
        assert out[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(out[key].numpy(), value, err_msg = key)
    assert out['att_w'].dtype == torch.int8 and out['q_w'].dtype == tdt


@pytest.mark.parametrize('window', [None, 8])
def test_infer_fused_int8_lstm_matches_jax(model, window):
    """`infer_fused(int8_lstm=True)` on the CPU (`decoder_steps_plain` on
    int8 LSTM weights) against the JAX kernel in interpret mode, float32 on
    both sides, 16 steps: within 1e-4 of each tensor's largest value
    (measured 6.3e-7 on the mel; tanh and sigmoid differ between the
    libraries in the last place, which could move an LSTM input row's amax
    and so its int8 grid).  The int8 decode itself is 4e-3 to 6e-3 away
    from the float32 one, so the bound tells the two apart."""
    import jax.numpy as jnp
    from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
    arch, (jparams, jstate), (params, state) = model
    tokens = _tokens(2, 32)
    kw = dict(deterministic = True, early_stopping = False, max_length = 16,
              attn_mask_win_len = window, chunk = 8, int8_lstm = True)
    ref = JaxTacotron2(** TINY).infer_fused(
        _jax(jparams), _jax(jstate), jnp.asarray(tokens), interpret = True, ** kw)
    with torch.no_grad():
        out = arch.infer_fused(params, state, torch.from_numpy(tokens).long(), ** kw)
        plain = arch.infer_fused(params, state, torch.from_numpy(tokens).long(),
                                 ** dict(kw, int8_lstm = False))
    for name in ('mel', 'stop_tokens', 'attention_weights'):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    # the int8 products are in use: not the float32 decode
    assert float((out.mel - plain.mel).abs().max()) > 1e-3 * float(plain.mel.abs().max())


# -- the port against itself ---------------------------------------------------------

@pytest.mark.parametrize('window', [None, 8])
def test_infer_fused_matches_infer(model, window):
    arch, _, (params, state) = model
    tokens = torch.from_numpy(_tokens(2, 32)).long()
    kw = dict(deterministic = True, early_stopping = False, max_length = 20,
              attn_mask_win_len = window)
    with torch.no_grad():
        ref = arch.infer(params, state, tokens, ** kw)
        out = arch.infer_fused(params, state, tokens, chunk = 8, ** kw)
    for name in ('mel', 'decoder_output', 'stop_tokens', 'attention_weights'):
        np.testing.assert_allclose(getattr(out, name).numpy(), getattr(ref, name).numpy(),
                                   atol = 1e-5, rtol = 0, err_msg = name)
    np.testing.assert_array_equal(out.lengths.numpy(), ref.lengths.numpy())


def test_early_stopping_stops_at_a_launch_boundary(model):
    """The gate fires early; the fused loop reads it once per launch, so it
    stops after the first launch, and `lengths` is the plain decoder's."""
    arch, (jparams, jstate), _ = model
    jparams = {** jparams, 'decoder': {** jparams['decoder'], 'gate_layer': {
        'kernel': jparams['decoder']['gate_layer']['kernel'],
        'bias': np.full((1,), 4., np.float32)}}}
    params, state = tacotron2_from_jax(jparams, jstate)
    tokens = torch.from_numpy(_tokens(2, 32)).long()
    before = dk.decoder_steps.launches
    with torch.no_grad():
        ref = arch.infer(params, state, tokens, deterministic = True, max_length = 32)
        out = arch.infer_fused(params, state, tokens, deterministic = True,
                               max_length = 32, chunk = 8)
    np.testing.assert_array_equal(out.lengths.numpy(), ref.lengths.numpy())
    assert out.mel.shape == ref.mel.shape == (2, 32, 8)
    assert float(out.decoder_output[:, 8:].abs().max()) == 0.     # launches skipped
    assert dk.decoder_steps.launches == before                    # CPU: the plain version


def test_state_carries_across_launches(model):
    arch, _, (params, state) = model
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32))
    full, full_attn, st_full = dk.decoder_steps(* args, new_state(), _seed(0), n_steps = 4,
                                                deterministic = True)
    st = new_state()
    a, attn_a, st_a = dk.decoder_steps(* args, st, _seed(0), n_steps = 2, deterministic = True)
    assert st_a is st                                # updated in place, and returned
    b, attn_b, st = dk.decoder_steps(* args, st, _seed(0), n_steps = 2, step0 = 2,
                                     deterministic = True)
    assert torch.equal(torch.cat([a, b]), full)
    assert torch.equal(torch.cat([attn_a, attn_b]), full_attn)
    for key, value in st_full.items():
        assert torch.equal(value, st[key]), key
    assert float(st['cum'].sum(dim = 1).min()) == pytest.approx(4., abs = 1e-5)


def test_bf16_rounding_contract(model):
    """In bfloat16 h and ctx are bfloat16, c, frame and the alignments stay
    float32, and the frames stay close to the float32 decode (bf16 keeps
    about 3 significant digits)."""
    arch, _, (params, state) = model
    tokens = _tokens(2, 32)
    args16, new16 = _step_inputs(arch, params, state, tokens, dtype = torch.bfloat16)
    args32, new32 = _step_inputs(arch, params, state, tokens)
    steps16, attn16, st = dk.decoder_steps(* args16, new16(), _seed(0), n_steps = 4,
                                           deterministic = True)
    steps32, _, _ = dk.decoder_steps(* args32, new32(), _seed(0), n_steps = 4,
                                     deterministic = True)
    assert args16[0]['att_w'].dtype == torch.bfloat16
    assert args16[0]['att_b'].dtype == args16[0]['v_w'].dtype == torch.float32
    for key in ('h_att', 'h_dec', 'ctx'):
        assert st[key].dtype == torch.bfloat16, key
    for key in ('c_att', 'c_dec', 'frame', 'prev', 'cum'):
        assert st[key].dtype == torch.float32, key
    assert st['main'].dtype == torch.int32
    assert steps16.dtype == attn16.dtype == torch.float32
    assert float((steps16 - steps32).abs().max()) < 3e-2 * float(steps32.abs().max())
    assert float((steps16 - steps32).abs().max()) > 0.


def _unslab(slabs):
    """The kernel's (U / 8, K, 32) slabs → the (K, 4U) weight they hold."""
    n, K = slabs.shape[:2]
    return slabs.reshape(n, K, 8, 4).permute(1, 3, 0, 2).reshape(K, 32 * n)


def _unslab_int8(slabs):
    """The kernel's int8 (U / 8, K / 4, 32, 4) slabs → the (K, 4U) weight."""
    n, K4 = slabs.shape[:2]
    return slabs.reshape(n, K4, 8, 4, 4).permute(1, 4, 3, 0, 2).reshape(4 * K4, 32 * n)


def test_pack_layouts(model):
    """The packed names and shapes, the gate order against `lstm_cell`, and
    the kernel's slab layout of an LSTM weight, which unpacks to the packed
    matrices bit for bit."""
    from text_to_speech_tpu_torch.nn import layers as nn
    arch, _, (params, _) = model
    dec = params['decoder']
    w = dk.pack_decoder_weights(dec, n_mel = 8)
    P, D, U, A = 8, 16, 16, 8
    shapes = {k: tuple(v.shape) for k, v in w.items()}
    assert shapes == {
        'w0': (8, P), 'b0': (P,), 'w1': (P, P), 'b1': (P,),
        'att_w': (P + D + U, 4 * U), 'att_b': (4 * U,), 'q_w': (U, A),
        'loc_w': (62, A), 'v_w': (A,), 'dec_w': (2 * U + D, 4 * U), 'dec_b': (4 * U,),
        'proj_w': (U + D, 9), 'proj_b': (9,)}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, P + D)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, U)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, U)).astype(np.float32))
    ref_h, (_, ref_c) = nn.lstm_cell(dec['attention_rnn'], x, (h, c))
    got_h, got_c = dk._lstm(torch.cat([x, h], dim = -1) @ w['att_w'] + w['att_b'], c, U)
    np.testing.assert_allclose(got_h.numpy(), ref_h.numpy(), atol = 1e-6, rtol = 0)
    np.testing.assert_allclose(got_c.numpy(), ref_c.numpy(), atol = 1e-6, rtol = 0)
    slabs = dk._slabs(w['att_w'])
    assert slabs.shape == (U // 8, P + D + U, 32)
    for slab, k, unit, gate in ((0, 0, 0, 0), (1, 5, 3, 2), (1, 39, 7, 3)):
        assert slabs[slab, k, 4 * unit + gate] == w['att_w'][k, gate * U + slab * 8 + unit]
    kw = dk._kernel_weights(dict(w))
    assert torch.equal(_unslab(kw['att_k']), w['att_w'])
    assert torch.equal(_unslab(kw['dec_k']), w['dec_w'])


def test_int8_slab_layout(model):
    """int8 LSTM weights: the kernel's (U / 8, K / 4, 32, 4) slabs hold, for
    each group of 4 inputs, column ``4 * unit + gate`` as the group's bytes;
    `_check` takes the int8 layouts with their column scales, on the weights
    a card keeps (`kernel_weights_only`)."""
    arch, _, (params, state) = model
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32))
    w = dk.quantize_lstm_weights(args[0])
    assert '_kernel' not in w
    P, D, U = 8, 16, 16
    slabs = dk._slabs_int8(w['dec_w'])
    assert slabs.shape == (U // 8, (2 * U + D) // 4, 32, 4) and slabs.dtype == torch.int8
    for slab, k, unit, gate in ((0, 0, 0, 0), (1, 5, 3, 2), (1, 47, 7, 3)):
        assert slabs[slab, k // 4, 4 * unit + gate, k % 4] == \
            w['dec_w'][k, gate * U + slab * 8 + unit]
    kw = dk._kernel_weights(dict(w))
    assert torch.equal(_unslab_int8(kw['att_k']), w['att_w'])
    assert torch.equal(_unslab_int8(kw['dec_k']), w['dec_w'])
    only = dk.kernel_weights_only(w)
    assert dk._check(only, * args[1:], new_state(), _seed(0), 2)[0] == 2
    with pytest.raises(ValueError, match = 's_att_w'):
        dk._check({k: v for k, v in only.items() if k != 's_att_w'}, * args[1:],
                  new_state(), _seed(0), 2)
    with pytest.raises(ValueError, match = 'K % 4'):
        dk._slabs_int8(w['att_w'][:-1])


# -- dropout ---------------------------------------------------------------------------

def test_philox_known_answer_and_keep_rate():
    z = torch.zeros((), dtype = torch.int64)
    # philox4x32-10 of the zero key and counter (Random123's known answer)
    assert int(dk.philox_bits(_seed(0), z, z, z, z)) == 0x6627E8D5
    bits = dk.philox_bits(_seed(1234567890123), torch.arange(64)[:, None, None],
                          torch.arange(2)[None, :, None], torch.arange(256)[None, None, :],
                          torch.ones((), dtype = torch.int64))
    n = bits.numel()
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    keep = float((bits >= dk.drop_threshold(0.5)).float().mean())
    assert abs(keep - 0.5) < 4 * 0.5 / n ** 0.5                  # 4 sigma
    x = torch.ones((2, 256))
    dropped = dk._dropout(x, _seed(7), 3, 0, 0.5)
    assert set(dropped.unique().tolist()) == {0., 2.}            # survivors scale by 2
    assert torch.equal(dropped, dk._dropout(x, _seed(7), 3, 0, 0.5))
    assert not torch.equal(dropped, dk._dropout(x, _seed(7), 3, 1, 0.5))   # per layer
    assert not torch.equal(dropped, dk._dropout(x, _seed(7), 4, 0, 0.5))   # per step
    assert dk.drop_threshold(0.) == 0 and dk.drop_threshold(0.5) == 2 ** 31
    with pytest.raises(ValueError):
        dk.drop_threshold(1.)


def test_dropout_seed_and_launch_split(model):
    arch, _, (params, state) = model
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32))
    run = lambda seed, ** kw: dk.decoder_steps(* args, new_state(), _seed(seed), ** kw)[0]
    whole = run(5, n_steps = 4)
    assert torch.equal(whole, run(5, n_steps = 4))               # same seed, same frames
    assert not torch.equal(whole, run(6, n_steps = 4))
    assert not torch.equal(whole, run(5, n_steps = 4, deterministic = True))
    st = new_state()
    a = dk.decoder_steps(* args, st, _seed(5), n_steps = 2)[0]
    b = dk.decoder_steps(* args, st, _seed(5), n_steps = 2, step0 = 2)[0]
    assert torch.equal(torch.cat([a, b]), whole)                 # the mask ignores the split

    tokens = torch.from_numpy(_tokens(2, 32)).long()
    decode = lambda seed, chunk: arch.infer_fused(
        params, state, tokens, generator = torch.Generator().manual_seed(seed),
        early_stopping = False, max_length = 16, chunk = chunk).mel
    with torch.no_grad():
        assert torch.equal(decode(0, 8), decode(0, 4))
        assert not torch.equal(decode(0, 8), decode(1, 8))


# -- envelope ------------------------------------------------------------------------------

def test_envelope_errors(model):
    arch, _, (params, state) = model
    tokens = torch.from_numpy(_tokens(2, 32)).long()
    with pytest.raises(ValueError):                      # 30 tokens: no multiple of 8
        arch.infer_fused(params, state, tokens[:, :30], deterministic = True, max_length = 8)
    with pytest.raises(ValueError):                      # more rows than the kernel takes
        arch.infer_fused(params, state, tokens[:1].repeat(9, 1), deterministic = True,
                         max_length = 8)
    assert not Tacotron2(** {** TINY, 'lsa_attention_kernel_size': 15}) \
        .supports_fused_decoder(2, 32)
    assert arch.supports_fused_decoder(8, 32)
    # the CUDA kernel's alignment is no part of the envelope: its check raises
    assert Tacotron2(** {** TINY, 'attention_rnn_dim': 12, 'decoder_rnn_dim': 12}) \
        .supports_fused_decoder(2, 32)
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32))
    weights = dict(args[0], q_w = args[0]['q_w'][:12].contiguous())     # U = 12
    with pytest.raises(ValueError, match = 'U % 8'):
        dk._check(weights, * args[1:], new_state(), _seed(0), 2)
    with pytest.raises(ValueError, match = 'U % 8'):
        dk.kernel_weights_only({** args[0], 'att_w': args[0]['att_w'][:, :48]})
    only = dk.kernel_weights_only(dict(args[0]))
    assert not {'att_w', 'dec_w'} & set(only) and 'proj_w' in only
    assert dk._check(only, * args[1:], new_state(), _seed(0), 2)[0] == 2
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32))
    with pytest.raises(ValueError, match = 'stamps'):    # only the kernel takes stamps
        dk.decoder_steps(* args, new_state(), _seed(0), n_steps = 2,
                         stamps = torch.zeros((20,), dtype = torch.int64))
    with pytest.raises(ValueError, match = 'prenet_out'):
        dk.decoder_steps(* args, new_state(), _seed(0), n_steps = 2,
                         prenet_out = torch.zeros((2, args[0]['w1'].shape[1])))
    with pytest.raises(ValueError, match = 'int8 LSTM mode'):
        dk.int8_lstm_lockstep(* args, new_state(), _seed(0), n_steps = 2)
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32), device = 'meta')
    with pytest.raises(ValueError, match = 'cuda'):      # neither the card nor the CPU
        dk.decoder_steps(* args, new_state(), _seed(0, 'meta'), n_steps = 2)


def test_grid_difference_finds_a_tie_flip():
    """Two rows a float32 ulp apart at a value whose int8 grid rounding
    changes between them: one value, one grid step, the row scale equal."""
    row = torch.tensor([[3., -1., 0.25, 0.]])
    scale = dk._row_quant8(row)[1][0, 0]
    v = torch.tensor(10.5) * scale
    up = lambda t: torch.nextafter(t, torch.tensor(1.))
    while torch.round(v / scale) == torch.round(up(v) / scale):
        v = up(v) if v / scale < 10.5 else torch.nextafter(v, torch.tensor(0.))
    lo, hi = row.clone(), row.clone()
    lo[0, 3], hi[0, 3] = v, up(v)
    assert dk._grid_difference(lo, lo.clone(), (('x', 4),)) is None
    moved = dk._grid_difference(hi, lo, (('x', 2), ('h', 2)))
    assert moved['values'] == 1 and moved['max_grid_steps'] == 1. and moved['scales_equal']
    assert moved['row_diff_rel_amax'] < 1e-7
    first = moved['first']
    assert (first['segment'], first['index'], first['ulps_apart']) == ('h', 1, 1.)


def test_phase_times_from_stamps():
    """Two steps, a stamp every 100 clocks, 2 clocks a nanosecond."""
    n = dk.stamps_size(2) - 4
    assert n == 2 * 2 * len(dk.PHASES)
    clock1 = 1000 + 100 * n
    stamps = torch.cat([1000 + 100 * torch.arange(n),                 # ns, clock, ns, clock
                        torch.tensor([5000, 900, 5000 + (clock1 - 900) // 2, clock1])])
    times = dk.phase_times_us(stamps)
    assert times['work'].shape == times['barrier'].shape == (2, len(dk.PHASES))
    np.testing.assert_allclose(times['barrier'].numpy(), 0.05)
    np.testing.assert_allclose(times['work'].numpy(), 0.05)


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _tiny_model():
    arch = Tacotron2(** TINY)
    jparams, jstate = init_tacotron2(arch.hp, seed = 0)
    jparams['decoder']['gate_layer']['bias'][:] = -4.
    return (arch,) + tacotron2_from_jax(jparams, jstate)


# (dtype, tolerance): float32 differs from the plain version in summation
# order and in expf/tanhf against torch's; bfloat16 rounds h and ctx every
# step, where another float32 sum can flip a rounding that the next steps
# carry on.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype,atol', [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize('deterministic', [True, False])
@pytest.mark.parametrize('B,S,window', [(1, 32, False), (3, 40, True), (8, 8, False)])
def test_kernel_matches_plain(cuda_device, dtype, atol, deterministic, B, S, window):
    arch, params, state = _tiny_model()
    args, new_state = _step_inputs(arch, params, state, _tokens(B, S), dtype, cuda_device)
    kw = dict(n_steps = 7, deterministic = deterministic, use_window = window,
              win_len = 8, win_offset = 4)
    before = dk.decoder_steps.launches
    st = new_state()
    steps, attn, _ = dk.decoder_steps(* args, st, _seed(11, cuda_device), ** kw)
    torch.cuda.synchronize()
    assert dk.decoder_steps.launches == before + 1
    ref_st = new_state()
    ref_steps, ref_attn, _ = dk.decoder_steps_plain(* args, ref_st, _seed(11, cuda_device), ** kw)
    assert steps.shape == (7, B, 9) and attn.shape == (7, B, S)
    assert float((steps - ref_steps).abs().max()) <= atol
    assert float((attn - ref_attn).abs().max()) <= atol
    for key in ('c_att', 'c_dec', 'cum', 'h_att', 'h_dec', 'ctx'):
        assert float((st[key].float() - ref_st[key].float()).abs().max()) <= atol, key


# int8 LSTM mode: the integer sums are exact on both sides and the scales
# apply in the same order, so float32 is held as above where both sides'
# LSTM input rows quantize to the same int8 grid.  A staged value that
# differs by a rounding can cross a rounding tie and move one product by a
# grid step, which a decode carries on: with dropout, float32 is held step by
# step from the plain version's state (`int8_lstm_lockstep`), and the
# float32-LSTM kernel (the control) must miss the same limit.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype,atol', [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize('deterministic', [True, False])
@pytest.mark.parametrize('B,S,window', [(1, 32, False), (3, 40, True), (8, 8, False)])
def test_kernel_int8_lstm_matches_plain(cuda_device, dtype, atol, deterministic, B, S, window):
    arch, params, state = _tiny_model()
    args, new_state = _step_inputs(arch, params, state, _tokens(B, S), dtype, cuda_device)
    control = args[0]
    args = (dk.quantize_lstm_weights(args[0]),) + args[1:]
    kw = dict(n_steps = 7, deterministic = deterministic, use_window = window, win_len = 8,
              win_offset = 4)
    if dtype == torch.float32 and not deterministic:
        steps, frames = dk.int8_lstm_lockstep(* args, new_state(), _seed(11, cuda_device),
                                              control = control, ** kw)
        whole = dk.decoder_steps(* args, new_state(), _seed(11, cuda_device), ** kw)[0]
        assert torch.equal(frames, whole)
        held = [s for s in steps if s['grids_equal']]
        assert len(held) >= len(steps) // 2
        assert max(s['rel_err'] for s in held) <= atol
        assert max(s['control_rel_err'] for s in held) > atol
        for s in steps:
            if not s['grids_equal']:
                moved = s.get('att', s.get('dec'))
                assert moved['row_diff_rel_amax'] <= 1e-5 and moved['max_grid_steps'] <= 1.
        for s in steps:
            if not s['path_grids_equal']:
                break
            assert s['path_rel_err'] <= atol
        return
    before = dk.decoder_steps.launches
    st = new_state()
    steps, attn, _ = dk.decoder_steps(* args, st, _seed(11, cuda_device), ** kw)
    torch.cuda.synchronize()
    assert dk.decoder_steps.launches == before + 1
    ref_st = new_state()
    ref_steps, ref_attn, _ = dk.decoder_steps_plain(* args, ref_st, _seed(11, cuda_device), ** kw)
    assert float((steps - ref_steps).abs().max()) <= atol
    assert float((attn - ref_attn).abs().max()) <= atol
    for key in ('c_att', 'c_dec', 'h_att', 'h_dec', 'ctx'):
        assert float((st[key].float() - ref_st[key].float()).abs().max()) <= atol, key


@pytest.mark.cuda
def test_kernel_state_carries_across_launches(cuda_device):
    arch, params, state = _tiny_model()
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32), device = cuda_device)
    seed = _seed(3, cuda_device)
    whole = dk.decoder_steps(* args, new_state(), seed, n_steps = 6)[0]
    st = new_state()
    a = dk.decoder_steps(* args, st, seed, n_steps = 3)[0]        # an odd launch
    b = dk.decoder_steps(* args, st, seed, n_steps = 3, step0 = 3)[0]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([a, b]), whole)


@pytest.mark.cuda
def test_kernel_phase_stamps(cuda_device):
    arch, params, state = _tiny_model()
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32), device = cuda_device)
    stamps = torch.zeros((dk.stamps_size(5),), dtype = torch.int64, device = cuda_device)
    dk.decoder_steps(* args, new_state(), _seed(3, cuda_device), n_steps = 5, stamps = stamps)
    torch.cuda.synchronize()
    times = dk.phase_times_us(stamps)
    assert times['work'].shape == (5, len(dk.PHASES))
    assert float(times['work'].min()) > 0. and float(times['barrier'].min()) > 0.
    # the spans tile the launch from its first clock stamp to its last: in
    # clocks, no more than the launch's own
    ns0, clock0, ns1, clock1 = (float(v) for v in stamps[-4:].cpu())
    us_per_clock = 1e-3 * (ns1 - ns0) / (clock1 - clock0)
    spans = float(times['work'].sum() + times['barrier'].sum()) / us_per_clock
    assert spans <= clock1 - clock0
    with pytest.raises(ValueError, match = 'stamps'):
        dk.decoder_steps(* args, new_state(), _seed(3, cuda_device), n_steps = 5,
                         stamps = stamps[:8])


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes(cuda_device):
    arch, params, state = _tiny_model()
    args, new_state = _step_inputs(arch, params, state, _tokens(2, 32), device = cuda_device)
    before = dk.decoder_steps.launches
    rows9 = tuple(a.repeat_interleave(5, dim = 0)[:9].contiguous() if torch.is_tensor(a) else a
                  for a in args)
    st = {k: v.repeat_interleave(5, dim = 0)[:9].contiguous() for k, v in new_state().items()}
    with pytest.raises(ValueError):
        dk.decoder_steps(* rows9, st, _seed(0, cuda_device), n_steps = 2)
    with pytest.raises(TypeError):
        half = tuple(a.half() if torch.is_tensor(a) and a.is_floating_point() else a
                     for a in args)
        dk.decoder_steps(* half, new_state(), _seed(0, cuda_device), n_steps = 2)
    assert dk.decoder_steps.launches == before


# -- on the card, at NVIDIA width ----------------------------------------------------------
# U = 1024, D = 512, P = 256, A = 128: the LSTM slabs exceed shared memory in
# float32 and bfloat16, so these cases reach the streamed tail of the ring,
# and the attention of each row is split over 8 energies items and 16
# context items.  Random weights from a numpy seed, scaled by 1 / sqrt(fan-in).

_WIDE = dict(n_mel = 80, P = 256, U = 1024, D = 512, A = 128)


def _wide_weights(device, dtype):
    n_mel, P, U, D, A = (_WIDE[k] for k in ('n_mel', 'P', 'U', 'D', 'A'))
    rng = np.random.default_rng(7)

    def w(* shape):
        v = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
        return torch.from_numpy(v).to(device)

    bias = lambda n: torch.from_numpy(
        0.1 * rng.standard_normal(n).astype(np.float32)).to(device)
    packed = {'w0': w(n_mel, P), 'b0': bias(P), 'w1': w(P, P), 'b1': bias(P),
              'att_w': w(P + D + U, 4 * U), 'att_b': bias(4 * U), 'q_w': w(U, A),
              'loc_w': w(2 * dk.LOC_KERNEL, A), 'v_w': bias(A) * 10.,
              'dec_w': w(2 * U + D, 4 * U), 'dec_b': bias(4 * U),
              'proj_w': w(U + D, n_mel + 1), 'proj_b': bias(n_mel + 1)}
    return {k: v.to(dtype) if v.dim() > 1 else v for k, v in packed.items()}


def _wide_inputs(device, dtype, B, S):
    rng = np.random.default_rng(11 + B + S)
    lengths = [S - 7 * b for b in range(B)]
    mask = np.zeros((B, S), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.
    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(device)
    mem = t(rng.standard_normal((B, S, _WIDE['D'])) * mask[..., None]).to(dtype)
    pm = t(0.5 * rng.standard_normal((B, S, _WIDE['A']))).to(dtype)
    enc_len = torch.tensor(lengths, dtype = torch.int32, device = device)
    extra = torch.zeros((B, _WIDE['P']), device = device)
    new_state = lambda: dk.init_decoder_state(B, S, _WIDE['D'], _WIDE['U'], _WIDE['n_mel'],
                                              dtype, device)
    return (mem, pm, t(mask), enc_len, extra), new_state


def _max_rel_err(a, b):
    """Largest error over frames and gates, alignments and every state
    tensor, each relative to its largest magnitude."""
    keys = ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum')
    return max([dk._rel_err(a[0], b[0]), dk._rel_err(a[1], b[1])]
               + [dk._rel_err(a[2][k], b[2][k]) for k in keys])


# (mode, tolerance of scale): float32 and bfloat16 as in
# `test_kernel_matches_plain`; the int8 LSTM mode (float32 compute) through
# `int8_lstm_lockstep`, as in `test_kernel_int8_lstm_matches_plain`
@pytest.mark.cuda
@pytest.mark.parametrize('mode,tol', [('float32', 1e-4), ('bfloat16', 5e-2), ('int8_lstm', 1e-4)])
@pytest.mark.parametrize('deterministic', [True, False])
@pytest.mark.parametrize('B,S', [(1, 64), (1, 256), (8, 64), (8, 256)])
def test_kernel_matches_plain_at_nvidia_width(cuda_device, mode, tol, deterministic, B, S):
    dtype = torch.bfloat16 if mode == 'bfloat16' else torch.float32
    weights = _wide_weights(cuda_device, dtype)
    inputs, new_state = _wide_inputs(cuda_device, dtype, B, S)
    seed = _seed(5, cuda_device)
    kw = dict(n_steps = 8, deterministic = deterministic)
    if mode == 'int8_lstm':
        control, weights = weights, dk.quantize_lstm_weights(weights)
        steps, frames = dk.int8_lstm_lockstep(weights, * inputs, new_state(), seed,
                                              control = control, ** kw)
        whole = dk.decoder_steps(weights, * inputs, new_state(), seed, ** kw)[0]
        assert torch.equal(frames, whole)
        held = [s for s in steps if s['grids_equal']]
        assert len(held) >= len(steps) // 2
        assert max(s['rel_err'] for s in held) <= tol
        assert max(s['control_rel_err'] for s in held) > tol
        for s in steps:
            if not s['grids_equal']:
                moved = s.get('att', s.get('dec'))
                assert moved['row_diff_rel_amax'] <= 1e-5 and moved['max_grid_steps'] <= 1.
        for s in steps:
            if not s['path_grids_equal']:
                break
            assert s['path_rel_err'] <= tol
        # every int8 weight of a block fits beside the work area at B = 1
        if B == 1:
            assert dk.decoder_steps.last_plan['streamed_bytes_per_step'] == 0
        return
    before = dk.decoder_steps.launches
    out = dk.decoder_steps(weights, * inputs, new_state(), seed, ** kw)
    torch.cuda.synchronize()
    assert dk.decoder_steps.launches == before + 1
    assert dk.decoder_steps.last_plan['streamed_bytes_per_step'] > 0
    ref = dk.decoder_steps_plain(weights, * inputs, new_state(), seed, ** kw)
    assert out[0].shape == (8, B, _WIDE['n_mel'] + 1) and out[1].shape == (8, B, S)
    assert bool(torch.isfinite(out[0]).all())
    assert _max_rel_err(out, ref) <= tol
    assert torch.equal(out[2]['main'], ref[2]['main'])


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8_lstm'])
def test_kernel_launch_split_at_nvidia_width(cuda_device, mode):
    """Two launches of 4 steps equal one of 8 to the bit (same plan, same
    summation order, dropout keyed by the absolute step)."""
    dtype = torch.bfloat16 if mode == 'bfloat16' else torch.float32
    weights = _wide_weights(cuda_device, dtype)
    if mode == 'int8_lstm':
        weights = dk.quantize_lstm_weights(weights)
    inputs, new_state = _wide_inputs(cuda_device, dtype, 4, 64)
    seed = _seed(5, cuda_device)
    whole = dk.decoder_steps(weights, * inputs, new_state(), seed, n_steps = 8)
    st = new_state()
    a = dk.decoder_steps(weights, * inputs, st, seed, n_steps = 4)
    b = dk.decoder_steps(weights, * inputs, st, seed, n_steps = 4, step0 = 4)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([a[0], b[0]]), whole[0])
    assert torch.equal(torch.cat([a[1], b[1]]), whole[1])
    for key in dk._STATE_KEYS:
        assert torch.equal(st[key], whole[2][key]), key
