"""The port's transformer stack against the JAX package's, on the CPU.

  - `nn.activations.get_activation` for every name, `nn.layers.rms_norm`;
  - `attention.mha` with a KV cache, RoPE, grouped KV heads and a
    relative bias, with a scalar cache index and with one index a row
    (against the JAX `mha` under `jax.vmap` over rows, as the JAX serving
    stepper runs it), outputs and caches;
  - `Transformer` for each hparam branch (learned, sinusoidal, rotary and
    no positions; layer and RMS norm; pre- and post-norm; gated and MoE
    FFN; T5's relative bias; cross attention; token types; an embedding
    norm; BART's position offset; the Whisper stem; tied and untied
    heads): `encode`, `decode` without a cache, `decode` over `init_caches`
    (a prefill and single steps), and a decode with a per-row index against
    the JAX vmapped one-row decode; logits within 1e-5, the caches too;
  - the MoE load-balancing loss, `t5_relative_buckets`, the weight bridge
    (`transformer_to_jax(transformer_from_jax(p))` gives back `p` exactly;
    the stacked experts' layout), the registry's ``'transformer'``, and
    `text/tokens.py`.

The JAX side runs eagerly (tiny shapes); the weights are the JAX `init`'s,
carried across by `weights.transformer_from_jax`.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import compile_fast

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models import registry as jax_registry
from text_to_speech_tpu.models.transformers import attention as jax_attention
from text_to_speech_tpu.models.transformers import transformer_arch as jax_arch
from text_to_speech_tpu.nn import activations as jax_activations
from text_to_speech_tpu.nn import layers as jax_layers
from text_to_speech_tpu.text import tokens as jax_tokens
from text_to_speech_tpu_torch.models import registry
from text_to_speech_tpu_torch.models.transformers import attention, transformer_arch
from text_to_speech_tpu_torch.nn import activations, layers
from text_to_speech_tpu_torch.text import tokens
from text_to_speech_tpu_torch.weights import transformer_from_jax, transformer_to_jax

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jax_params):
    return transformer_from_jax(_np(jax_params))


def _close(port, ref, atol = ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol = atol, rtol = 0)


# -- activations and norms --------------------------------------------------------

@pytest.mark.parametrize('name', [k for k in jax_activations._ACTIVATIONS if k
                                  and k != 'linear'])
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(0., 3., (3, 8)).astype(np.float32)
    ref = jax_activations.get_activation(name)(jnp.asarray(x))
    _close(activations.get_activation(name)(torch.from_numpy(x)), ref, atol = 2e-6)


def test_gelu_names_keep_the_jax_meanings():
    x = torch.linspace(-4., 4., 33)
    tanh = torch.nn.functional.gelu(x, approximate = 'tanh')
    assert torch.equal(activations.get_activation('gelu')(x), tanh)
    assert torch.allclose(activations.get_activation('gelu_new')(x), tanh, atol = 1e-6)
    assert torch.equal(activations.get_activation('gelu_exact')(x),
                       torch.nn.functional.gelu(x))
    assert activations.get_activation(None) is None
    with pytest.raises(ValueError):
        activations.get_activation('nope')


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size = (2, 5, 16)).astype(np.float32)
    gamma = rng.normal(size = (16,)).astype(np.float32)
    ref = jax_layers.rms_norm({'gamma': jnp.asarray(gamma)}, jnp.asarray(x), 1e-6)
    _close(layers.rms_norm({'gamma': torch.from_numpy(gamma)}, torch.from_numpy(x)), ref)


# -- attention ------------------------------------------------------------------

def _mha_case(seed = 2, dim = 32, n_heads = 4, n_kv = 2, L = 12):
    rng = np.random.default_rng(seed)
    jp = jax_attention.init_mha(jax.random.PRNGKey(seed), dim, n_heads, n_kv_heads = n_kv)
    jp = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.normal(size = a.shape).astype(np.float32),
                                jp)                     # non-zero biases
    cache_k = rng.normal(size = (2, L, n_kv, dim // n_heads)).astype(np.float32)
    cache_v = rng.normal(size = (2, L, n_kv, dim // n_heads)).astype(np.float32)
    return rng, jp, cache_k, cache_v


def _port_cache(k, v, index):
    return {'k': torch.from_numpy(k.transpose(0, 2, 1, 3).copy()),
            'v': torch.from_numpy(v.transpose(0, 2, 1, 3).copy()), 'index': index}


def _cache_close(port, ref):
    _close(port['k'].transpose(1, 2), ref['k'])
    _close(port['v'].transpose(1, 2), ref['v'])


@pytest.mark.parametrize('index', ['scalar', 'per_row', 'per_row_clamped'])
def test_mha_with_cache_rope_gqa_and_bias_matches_jax(index):
    """A scalar index writes Tq = 3 steps for both rows; a (B,) index one
    step at each row's own position (the JAX `mha` vmapped over rows), once
    with a row at the cache's end (the write clamps, the mask does not)."""
    rng, jp, ck, cv = _mha_case()
    pp = _port(jp)
    H, L = 4, ck.shape[1]
    kw = dict(n_heads = H, use_rope = True, rope_base = 500.)
    if index == 'scalar':
        x = rng.normal(size = (2, 3, 32)).astype(np.float32)
        bias = rng.normal(size = (1, H, 3, L)).astype(np.float32)
        mask = np.arange(L)[None, None, None, :] <= (4 + np.arange(3))[None, None, :, None]
        fn = lambda * a: jax_attention.mha(jp, a[0], mask = a[1], rel_bias = a[2],
                                           cache = {'k': a[3], 'v': a[4], 'index': a[5]}, ** kw)
        args = tuple(jnp.asarray(a) for a in (x, mask, bias, ck, cv, 4))
        ref, ref_cache = compile_fast(fn, * args)(* args)
        out, cache = attention.mha(pp, torch.from_numpy(x), mask = torch.from_numpy(mask),
                                   rel_bias = torch.from_numpy(bias),
                                   cache = _port_cache(ck, cv, 4), ** kw)
        assert cache['index'] == 7
    else:
        idx = np.array([3, 9] if index == 'per_row' else [5, L], np.int32)
        x = rng.normal(size = (2, 1, 32)).astype(np.float32)
        bias = rng.normal(size = (2, H, 1, L)).astype(np.float32)
        mask = np.arange(L)[None, None, None, :] <= idx[:, None, None, None]

        def row(x, k, v, i, m, b):
            out, c = jax_attention.mha(jp, x[None], mask = m[None], rel_bias = b[None],
                                       cache = {'k': k[None], 'v': v[None], 'index': i}, ** kw)
            return out[0], {'k': c['k'][0], 'v': c['v'][0], 'index': c['index']}
        args = tuple(jnp.asarray(a) for a in (x, ck, cv, idx, mask, bias))
        ref, ref_cache = compile_fast(jax.vmap(row), * args)(* args)
        out, cache = attention.mha(pp, torch.from_numpy(x), mask = torch.from_numpy(mask),
                                   rel_bias = torch.from_numpy(bias),
                                   cache = _port_cache(ck, cv, torch.from_numpy(idx).long()),
                                   ** kw)
        assert cache['index'].tolist() == (idx + 1).tolist()
    _close(out, ref)
    _cache_close(cache, ref_cache)


def test_rope_interleaves_pairs_and_masks_combine():
    rng = np.random.default_rng(3)
    x = rng.normal(size = (2, 5, 3, 8)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    ref = jax_attention.rope(jnp.asarray(x), jnp.asarray(pos), base = 10000.)
    _close(attention.rope(torch.from_numpy(x), torch.from_numpy(pos)), ref)
    # the pair (x[0], x[1]) rotates together, not (x[0], x[D/2])
    y = attention.rope(torch.from_numpy(x), torch.from_numpy(pos))
    assert torch.allclose(y[..., :2].norm(dim = -1), torch.from_numpy(x[..., :2]).norm(dim = -1),
                          atol = 1e-5)
    look = attention.build_look_ahead_mask(4)
    assert np.array_equal(look.numpy(), np.asarray(jax_attention.build_look_ahead_mask(4)))
    pad = attention.build_padding_mask(tokens = torch.tensor([[3, 4, 0, 0]]))
    both = attention.combine_masks(look, None, pad)
    ref = jax_attention.combine_masks(jax_attention.build_look_ahead_mask(4), None,
                                      jax_attention.build_padding_mask(
                                          tokens = jnp.asarray([[3, 4, 0, 0]])))
    assert np.array_equal(both.numpy(), np.asarray(ref))


# -- the stack ------------------------------------------------------------------

BASE = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 2, ffn_dim = 64, max_position = 40)
MISTRAL = dict(positional = 'rope', n_heads = 4, n_kv_heads = 2, norm = 'rms', gated_ffn = True,
               ffn_activation = 'silu', use_bias = False, tie_embeddings = False,
               rope_theta = 500000.)
BRANCHES = {
    'gpt2': dict(ffn_activation = 'gelu_new'),
    'bert': dict(norm_first = False, use_token_type = True, ffn_activation = 'gelu_exact',
                 use_final_norm = False, epsilon = 1e-12),
    'sinusoidal_untied': dict(positional = 'sinusoidal', scale_embedding = True,
                              tie_embeddings = False),
    'mistral': MISTRAL,
    'mixtral': dict(MISTRAL, n_experts = 4, n_experts_per_token = 2),
    't5': dict(positional = 'none', norm = 'rms', use_bias = False, use_relative_bias = True,
               rel_buckets = 8, rel_max_distance = 16, attention_scale = 1.0, epsilon = 1e-6,
               ffn_activation = 'relu', use_cross_attention = True),
    'bart': dict(norm_first = False, position_offset = 2, use_final_norm = False,
                 ffn_activation = 'gelu_exact', use_cross_attention = True),
    'whisper': dict(use_cross_attention = True, ffn_activation = 'gelu'),
}
TOKENS = np.array([[5, 9, 13, 2, 7, 11, 3], [4, 8, 1, 0, 6, 12, 10]])


def _enc_kwargs(enc, port):
    if enc is None:
        return {}
    x, m = enc
    if port:
        return {'encoder_output': torch.from_numpy(x), 'encoder_mask': torch.from_numpy(m)}
    return {'encoder_output': jnp.asarray(x), 'encoder_mask': jnp.asarray(m)}


STEPS = ((0, 4), (4, 5), (5, 6), (6, 7))     # a prefill, then single steps
ROW_INDEX = np.array([2, 6], np.int32)
ROW_TOKENS = np.array([9, 4])


def _jax_refs(jm, jp, token_type, enc, row_k, row_v):
    """Every JAX output the stack tests compare against, in one program:
    `encode`, `decode`, the cached decode over `STEPS` and the one-row
    decode vmapped over rows at `ROW_INDEX`."""
    refs = {'encode': jm.encode(jp, jnp.asarray(TOKENS), token_type = token_type)}
    aux = []
    refs['decode'] = jm.decode(jp, jnp.asarray(TOKENS), aux = aux, ** enc)[0]
    refs['aux'] = aux
    caches, refs['steps'] = jm.init_caches(2, 10), []
    for lo, hi in STEPS:
        logits, caches = jm.decode(jp, jnp.asarray(TOKENS[:, lo: hi]), caches = caches, ** enc)
        refs['steps'].append(logits)
    refs['caches'] = caches

    def row(kr, vr, i, t, e):
        caches = [{'k': a[None], 'v': b[None], 'index': i} for a, b in zip(kr, vr)]
        e = jax.tree_util.tree_map(lambda a: a[None], e)
        logits, new = jm.decode(jp, t[None, None], caches = caches, ** e)
        return logits[0, -1], [{'k': c['k'][0], 'v': c['v'][0]} for c in new]
    refs['row'] = jax.vmap(row)(row_k, row_v, jnp.asarray(ROW_INDEX), jnp.asarray(ROW_TOKENS),
                                enc)
    return refs


@pytest.fixture(scope = 'module', params = sorted(BRANCHES))
def stack(request):
    """(name, port model, port params, JAX refs, token types, encoder
    inputs, the per-row caches): the JAX side compiled once a branch."""
    name = request.param
    cfg = dict(BASE, ** BRANCHES[name])
    jm, pm = jax_arch.Transformer(** cfg), transformer_arch.Transformer(** cfg)
    jp = jm.init(jax.random.PRNGKey(7), decoder = True if cfg.get('use_cross_attention') else None)
    rng = np.random.default_rng(8)
    if name == 'bert':                  # the embedding norm only an importer adds
        jp['embedding_norm'] = {'gamma': jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32),
                                'beta': jnp.asarray(rng.normal(size = 32), jnp.float32)}
    enc = None
    if cfg.get('use_cross_attention'):
        enc = (rng.normal(size = (2, 6, 32)).astype(np.float32),
               np.array([1] * 9 + [0] * 3, bool).reshape(2, 1, 1, 6))
    tt = np.array([[0, 1, 1, 0, 1, 0, 0], [1, 1, 0, 0, 0, 1, 1]]) if name == 'bert' else None
    n_kv, hd = jm.hp.n_kv_heads or jm.hp.n_heads, 32 // jm.hp.n_heads
    rows = [[rng.normal(size = (2, 10, n_kv, hd)).astype(np.float32) for _ in range(2)]
            for _ in range(2)]
    args = (jp, None if tt is None else jnp.asarray(tt), _enc_kwargs(enc, False),
            [jnp.asarray(a) for a in rows[0]], [jnp.asarray(a) for a in rows[1]])
    refs = compile_fast(lambda * a: _jax_refs(jm, * a), * args)(* args)
    return name, pm, _port(jp), refs, tt, enc, rows


def test_encode_and_decode_match_jax(stack):
    name, pm, pp, refs, tt, enc, _ = stack
    out, mask = pm.encode(pp, torch.from_numpy(TOKENS),
                          token_type = None if tt is None else torch.from_numpy(tt))
    _close(out, refs['encode'][0])
    assert np.array_equal(mask.numpy(), np.asarray(refs['encode'][1]))
    aux = []
    out, _ = pm.decode(pp, torch.from_numpy(TOKENS), aux = aux, ** _enc_kwargs(enc, True))
    _close(out, refs['decode'])
    assert len(aux) == len(refs['aux'])
    if name == 'mixtral':
        assert len(aux) == 2
        for a, b in zip(aux, refs['aux']):
            _close(a, b)
        loss = transformer_arch.moe_load_balancing_loss(aux, 4, 2)
        ref_loss = jax_arch.moe_load_balancing_loss(refs['aux'], 4, 2)
        assert abs(float(loss) - float(ref_loss)) < 1e-6 and float(loss) >= 1. - 1e-4


def test_cached_decode_matches_jax(stack):
    """A 4-token prefill over `init_caches`, then three single steps."""
    name, pm, pp, refs, tt, enc, _ = stack
    pc = pm.init_caches(2, 10, device = 'cpu')
    for a, b in zip(pc, refs['caches']):
        assert tuple(a['k'].transpose(1, 2).shape) == b['k'].shape and a['index'] == 0
    for (lo, hi), ref in zip(STEPS, refs['steps']):
        out, pc = pm.decode(pp, torch.from_numpy(TOKENS[:, lo: hi]), caches = pc,
                            ** _enc_kwargs(enc, True))
        _close(out, ref)
    for a, b in zip(pc, refs['caches']):
        _cache_close(a, b)
        assert a['index'] == int(b['index']) == 7


def test_per_row_index_decode_matches_jax_vmap(stack):
    """Rows at different cache positions in one decode: the port's (B,)
    index against the JAX one-row decode vmapped over rows (the JAX serving
    stepper's `_row_decode`)."""
    name, pm, pp, refs, tt, enc, (k, v) = stack
    index = torch.from_numpy(ROW_INDEX).long()
    caches = [_port_cache(a, b, index) for a, b in zip(k, v)]
    out, caches = pm.decode(pp, torch.from_numpy(ROW_TOKENS)[:, None], caches = caches,
                            ** _enc_kwargs(enc, True))
    ref, ref_caches = refs['row']
    _close(out[:, -1], ref)
    for a, b in zip(caches, ref_caches):
        _cache_close(a, b)
        assert a['index'].tolist() == [3, 7]


def test_whisper_stem_matches_jax():
    """The stem's second conv pads (1, 1) at stride 2 (not XLA's SAME,
    which pads (0, 1) for an even length): odd and even lengths, and with
    the learned position table of an imported Whisper encoder."""
    cfg = dict(BASE, audio_stem = True, positional = 'none', n_mels = 12, max_position = 20)
    jm, pm = jax_arch.Transformer(** cfg), transformer_arch.Transformer(** cfg)
    jp = jm.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    mels = [rng.normal(size = (2, T, 12)).astype(np.float32) for T in (16, 13)]
    table = {'embeddings': jnp.asarray(rng.normal(size = (20, 32)), jnp.float32)}

    def refs(jp, mels):
        return [jm.encode_audio(jp, m)[0] for m in mels] + \
            [jm.encode_audio(dict(jp, position_embedding = table), mels[1])[0]]
    args = (jp, [jnp.asarray(m) for m in mels])
    ref = compile_fast(refs, * args)(* args)
    pp = _port(jp)
    for mel, r in zip(mels, ref):
        out, mask = pm.encode_audio(pp, torch.from_numpy(mel))
        assert mask is None and out.shape == (2, (mel.shape[1] + 1) // 2, 32)
        _close(out, r)
    pp['position_embedding'] = {'weight': torch.from_numpy(np.array(table["embeddings"]))}
    _close(pm.encode_audio(pp, torch.from_numpy(mels[1]))[0], ref[2])


def test_t5_relative_buckets_match_jax():
    rel = np.arange(-200, 200)[None, :] - np.arange(0, 3)[:, None]
    for bidirectional, nb, md in ((True, 32, 128), (False, 32, 128), (True, 8, 16)):
        ref = jax_arch.t5_relative_buckets(jnp.asarray(rel, jnp.int32), bidirectional = bidirectional,
                                           num_buckets = nb, max_distance = md)
        out = transformer_arch.t5_relative_buckets(torch.from_numpy(rel),
                                                   bidirectional = bidirectional,
                                                   num_buckets = nb, max_distance = md)
        assert np.array_equal(out.numpy(), np.asarray(ref))


def test_init_gives_the_jax_tree_and_draws_from_a_generator():
    for cfg in (BRANCHES['mixtral'], BRANCHES['t5'], dict(audio_stem = True, n_mels = 8)):
        cfg = dict(BASE, ** cfg)
        jp = jax_arch.Transformer(** cfg).init(jax.random.PRNGKey(0), decoder = True)
        pm = transformer_arch.Transformer(** cfg)
        pp = pm.init(3, decoder = True, device = 'cpu')
        ref = _port(jp)
        shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
        assert shapes(pp) == shapes(ref)
        again = pm.init(torch.Generator().manual_seed(3), decoder = True, device = 'cpu')
        assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(pp),
                                                      jax.tree_util.tree_leaves(again)))


def test_weights_round_trip_and_the_expert_layout():
    cfg = dict(BASE, ** BRANCHES['mixtral'])
    jp = _np(jax_arch.Transformer(** cfg).init(jax.random.PRNGKey(1)))
    pp = transformer_from_jax(jp)
    gate = jp['layer_0']['ffn']['experts']['gate']['kernel']           # (E, in, out)
    assert pp['layer_0']['ffn']['experts']['gate']['weight'].shape == (4, 64, 32)
    assert np.array_equal(pp['layer_0']['ffn']['experts']['gate']['weight'][2].numpy(),
                          gate[2].T)
    assert set(pp['layer_0']['attention_norm']) == {'gamma'}
    t5 = _np(jax_arch.Transformer(** dict(BASE, ** BRANCHES['t5'])).init(
        jax.random.PRNGKey(2), decoder = True))
    stem = _np(jax_arch.Transformer(** dict(BASE, audio_stem = True, n_mels = 8)).init(
        jax.random.PRNGKey(3)))
    for tree in (jp, {'encoder': t5, 'decoder': t5}, stem):
        back = transformer_to_jax(transformer_from_jax(tree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_registry_builds_the_jax_hparams():
    kw = dict(vocab_size = 64, dim = 32, n_layers = 2, positional = 'rope', n_experts = 4)
    port = registry.get_architecture('Transformer', ** kw)
    ref = jax_registry.get_architecture('transformer', ** kw)
    assert isinstance(port, transformer_arch.Transformer)
    assert port.get_config() == ref.get_config()
    assert registry.get_architecture({'architecture': 'transformer', 'dim': 16}).hp.dim == 16


# -- text/tokens.py ---------------------------------------------------------------

def test_token_masks_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.normal(size = (3, 10)).astype(np.float32)
    idx = np.array([[0, 2], [2, 7]])
    cases = [(jax_tokens.mask_tokens, tokens.mask_tokens, (idx,)),
             (jax_tokens.mask_batch_tokens, tokens.mask_batch_tokens, ([1, 4, 9],)),
             (jax_tokens.mask_slice_tokens, tokens.mask_slice_tokens, (4, True)),
             (jax_tokens.mask_slice_tokens, tokens.mask_slice_tokens, (6, False))]
    for jax_fn, fn, args in cases:
        ref = np.asarray(jax_fn(logits, * args))
        assert np.array_equal(fn(torch.from_numpy(logits), * args).numpy(), ref)
        assert np.array_equal(np.asarray(fn(logits, * args)), ref)
    out = tokens.mask_slice_tokens(torch.from_numpy(logits), torch.tensor(3), False)
    assert np.array_equal(out.numpy(), np.asarray(jax_tokens.mask_slice_tokens(logits, 3, False)))


def test_process_model_output_and_filter_texts_match_jax():
    class Out:
        def __init__(self, tokens, lengths):
            self.tokens, self.lengths = tokens, lengths
    toks = np.arange(12).reshape(2, 6)
    ref = jax_tokens.process_model_output(Out(toks, np.array([3, 5])))
    out = tokens.process_model_output(Out(torch.from_numpy(toks), torch.tensor([3, 5])))
    assert [a.tolist() for a in out] == [np.asarray(a).tolist() for a in ref]
    assert tokens.process_model_output(toks[0], 1, 4).tolist() == \
        np.asarray(jax_tokens.process_model_output(toks[0], 1, 4)).tolist()

    rng = np.random.default_rng(12)
    texts = rng.integers(1, 50, (6, 9))
    lengths = np.array([3, 9, 5, 2, 7, 4])
    multi = rng.integers(1, 50, (4, 3, 5))
    multi_len = np.array([[5, 2, 0], [3, 3, 3], [1, 0, 0], [5, 5, 4]])
    for kw in (dict(min_text_length = 3, max_text_length = 8),
               dict(max_total_length = 15, sort_by_length = True, return_indices = True),
               dict(max_texts = 3, select_mode = 'end', required_idx = 4),
               dict(max_total_length = 12, required_idx = 1)):
        ref = jax_tokens.filter_texts(texts, lengths, ** kw)
        out = tokens.filter_texts(torch.from_numpy(texts), lengths, ** kw)
        for a, b in zip(out, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for kw in (dict(max_sentences = 2), dict(max_sentence_length = 4, flatten = False),
               dict(max_total_length = 20)):
        ref = jax_tokens.filter_texts(multi, multi_len, ** kw)
        out = tokens.filter_texts(multi, [list(r) for r in multi_len], ** kw)
        for a, b in zip(out, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    ref = jax_tokens.filter_texts([t[:n] for t, n in zip(texts, lengths)], lengths,
                                  max_text_length = 5)
    out = tokens.filter_texts([t[:n] for t, n in zip(texts, lengths)], lengths,
                              max_text_length = 5)
    assert [t.tolist() for t in out[0]] == [t.tolist() for t in ref[0]]
