"""Port `nn/layers.py` and the text front end against the JAX package.

Each layer gets the same numpy parameter dict twice: as is for
`text_to_speech_tpu.nn.layers`, and through the weight bridge
(`weights.convert_tree`) for the port.  Tolerance: 1e-5 absolute, float32
on the CPU on both sides; only the summation order differs.  The text
front end must agree exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.nn import layers as jnn
from text_to_speech_tpu import text as jtext
from text_to_speech_tpu_torch.nn import layers as tnn
from text_to_speech_tpu_torch import text as ttext
from text_to_speech_tpu_torch.weights import (
    convert_tree, conv_transpose_from_jax, flatten_tree, unflatten_tree, load_tree)

ATOL = 1e-5


def _rng(seed = 0):
    return np.random.default_rng(seed)


def _f32(rng, * shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol = ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol = atol, rtol = 0)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_dense_and_embedding():
    rng = _rng()
    p = {'kernel': _f32(rng, 6, 4), 'bias': _f32(rng, 4)}
    x = _f32(rng, 3, 5, 6)
    _close(tnn.dense(convert_tree(p), torch.from_numpy(x)), jnn.dense(_jax(p), x))
    e = {'embeddings': _f32(rng, 10, 4)}
    ids = np.array([[1, 0, 9], [3, 3, 2]])
    _close(tnn.embedding(convert_tree(e), torch.from_numpy(ids)),
           jnn.embedding(_jax(e), jnp.asarray(ids)))


@pytest.mark.parametrize('width,dilation,padding', [
    (5, 1, 'SAME'), (3, 4, 'SAME'), (4, 1, 'SAME'), (3, 1, 'VALID'), (2, 3, 'VALID')])
def test_conv1d(width, dilation, padding):
    rng = _rng(width)
    p = {'kernel': _f32(rng, width, 3, 6), 'bias': _f32(rng, 6)}
    x = _f32(rng, 2, 11, 3)
    _close(tnn.conv1d(convert_tree(p), torch.from_numpy(x), padding = padding,
                      dilation = dilation),
           jnn.conv1d(_jax(p), x, padding = padding, dilation = dilation))


def test_conv1d_transpose():
    rng = _rng(1)
    p = {'kernel': _f32(rng, 8, 3, 5), 'bias': _f32(rng, 5)}
    x = _f32(rng, 2, 6, 3)
    _close(tnn.conv1d_transpose(conv_transpose_from_jax(p), torch.from_numpy(x), stride = 4),
           jnn.conv1d_transpose(_jax(p), x, stride = 4))


def test_batch_norm_inference():
    rng = _rng(2)
    params = {'gamma': _f32(rng, 4), 'beta': _f32(rng, 4)}
    state = {'moving_mean': _f32(rng, 4), 'moving_var': rng.uniform(0.5, 2., 4).astype(np.float32)}
    x = _f32(rng, 2, 7, 4)
    ref, _ = jnn.batch_norm(_jax(params), _jax(state), x, train = False, epsilon = 1e-3)
    _close(tnn.batch_norm(convert_tree(params), convert_tree(state), torch.from_numpy(x),
                          epsilon = 1e-3), ref)


def _lstm_params(rng, n_in, units):
    return {'kernel': _f32(rng, n_in, 4 * units) * 0.5,
            'recurrent_kernel': _f32(rng, units, 4 * units) * 0.5,
            'bias': _f32(rng, 4 * units)}


def test_lstm_cell():
    rng = _rng(3)
    p = _lstm_params(rng, 5, 7)
    x, h, c = _f32(rng, 3, 5), _f32(rng, 3, 7), _f32(rng, 3, 7)
    th, (_, tc) = tnn.lstm_cell(convert_tree(p), torch.from_numpy(x),
                                (torch.from_numpy(h), torch.from_numpy(c)))
    jh, (_, jc) = jnn.lstm_cell(_jax(p), x, (h, c))
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_masked(reverse):
    rng = _rng(4)
    p = _lstm_params(rng, 4, 6)
    xs = _f32(rng, 3, 9, 4)
    mask = np.arange(9)[None, :] < np.array([9, 5, 2])[:, None]
    tout, (th, tc) = tnn.lstm(convert_tree(p), torch.from_numpy(xs),
                              mask = torch.from_numpy(mask), reverse = reverse)
    jout, (jh, jc) = jnn.lstm(_jax(p), xs, mask = jnp.asarray(mask), reverse = reverse)
    _close(tout, jout)
    _close(th, jh)
    _close(tc, jc)


def test_bilstm_padded_batch():
    """The reverse scan carries its state through the padded steps (Keras
    masking); a padded row must equal its unpadded run."""
    rng = _rng(5)
    p = {'forward': _lstm_params(rng, 4, 3), 'backward': _lstm_params(rng, 4, 3)}
    xs = _f32(rng, 2, 8, 4)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    tp = convert_tree(p)
    out = tnn.bilstm(tp, torch.from_numpy(xs), mask = torch.from_numpy(mask))
    _close(out, jnn.bilstm(_jax(p), xs, mask = jnp.asarray(mask)))
    alone = tnn.bilstm(tp, torch.from_numpy(xs[1:, :5]))
    _close(out[1:, :5], alone.detach().numpy())
    assert float(out[1, 5:].abs().max()) == 0.


def test_dropout_generator():
    x = torch.ones(4000)
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(x, 0.5, generator = g)
    assert set(np.unique(y.numpy())) <= {0., 2.}
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.05
    again = tnn.dropout(x, 0.5, generator = torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert tnn.dropout(x, 0.) is x


def test_tree_round_trip(tmp_path):
    rng = _rng(6)
    tree = {'a': {'b': _f32(rng, 2), 'c': {'d': _f32(rng, 3)}}, 'e': _f32(rng, 1)}
    flat = flatten_tree(tree)
    assert set(flat) == {'a/b', 'a/c/d', 'e'}
    np.savez(tmp_path / 't.npz', ** flat)
    back = load_tree(str(tmp_path / 't.npz'))
    assert flatten_tree(back).keys() == flat.keys()
    np.testing.assert_array_equal(back['a']['c']['d'], tree['a']['c']['d'])
    assert flatten_tree(unflatten_tree(flat)).keys() == flat.keys()


TEXTS = [
    'Hello world!',
    'Dr. Smith paid $3.50 for 2 apples at 10:30 on the 1st of May.',
    'The 1990s — “quoted” text, 45% off & more…',
    'Mr. Brown   lives at No. 12,   St. James  street.',
    'Café naïve résumé: façade, 1,234,567 items.',
]


@pytest.mark.parametrize('text', TEXTS)
def test_text_front_end(text):
    jt = jtext.default_english_tokenizer()
    tt = ttext.default_english_tokenizer()
    assert tt.vocab == jt.vocab
    assert tt.clean_text(text) == jt.clean_text(text)
    np.testing.assert_array_equal(tt.encode(text), jt.encode(text))
    assert ttext.split_sentences(text) == jtext.split_sentences(text)
    assert ttext.split_text(text, 20) == jtext.split_text(text, 20)


def test_symbols_and_tokenizer_file(tmp_path):
    for lang in ('en', 'fr'):
        for kwargs in ({}, {'arpabet': False}, {'punctuation': 2, 'numbers': True}):
            assert ttext.get_symbols(lang, ** kwargs) == jtext.get_symbols(lang, ** kwargs)
    path = 'pretrained_models/overfit_demo/saving/tokenizer.json'
    jt, tt = jtext.Tokenizer.load_from_file(path), ttext.Tokenizer.load_from_file(path)
    assert tt.blank_token_idx == jt.blank_token_idx
    np.testing.assert_array_equal(tt.encode(TEXTS[1]), jt.encode(TEXTS[1]))


def test_tokenizer_save_is_the_jax_packages(tmp_path):
    """`Tokenizer.get_config` / `save` write what the JAX package writes,
    and each package reads the other's file."""
    jt, tt = jtext.default_english_tokenizer(), ttext.default_english_tokenizer()
    assert tt.get_config() == jt.get_config()
    port_file, jax_file = tt.save(str(tmp_path / 'port')), str(tmp_path / 'jax.json')
    jt.save(jax_file)
    assert port_file.endswith('.json')
    with open(port_file) as a, open(jax_file) as b:
        assert a.read() == b.read()
    for path in (port_file, jax_file):
        j, t = jtext.Tokenizer.load_from_file(path), ttext.Tokenizer.load_from_file(path)
        assert t.get_config() == j.get_config() == jt.get_config()
        np.testing.assert_array_equal(t.encode(TEXTS[1]), j.encode(TEXTS[1]))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('epsilon', [1e-9, 1e-5])
def test_layer_norm_matches_jax(dtype, epsilon):
    """float32 within 1e-5; bfloat16 (both reduce in float32 and round the
    mean and variance once) within two bfloat16 steps of the output's scale."""
    rng = _rng(7)
    p = {'gamma': 1. + 0.1 * _f32(rng, 16), 'beta': 0.1 * _f32(rng, 16)}
    x = 3. * _f32(rng, 2, 5, 16) + 1.
    jdt, tdt = {'float32': (jnp.float32, torch.float32),
                'bfloat16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jnn.layer_norm({k: jnp.asarray(v, jdt) for k, v in p.items()},
                         jnp.asarray(x, jdt), epsilon)
    out = tnn.layer_norm({k: v.to(tdt) for k, v in convert_tree(p).items()},
                         torch.from_numpy(x).to(tdt), epsilon)
    assert out.dtype == tdt
    ref = np.asarray(ref, np.float32)
    atol = ATOL if dtype == 'float32' else 2 * 2 ** -8 * float(np.abs(ref).max())
    _close(out.float(), ref, atol = atol)


def test_attention_and_positions_match_jax():
    """FastSpeech-2's self-attention with a key mask, the padding masks and
    the sinusoidal table, against the JAX package's."""
    from text_to_speech_tpu.models.transformers import attention as jattn
    from text_to_speech_tpu.models.transformers.transformer_arch import (
        sinusoidal_embedding as jax_sinusoidal)
    from text_to_speech_tpu_torch.models.transformers import attention as tattn
    from text_to_speech_tpu_torch.models.transformers.transformer_arch import (
        sinusoidal_embedding)
    rng = _rng(8)
    p = {name: {'kernel': 0.3 * _f32(rng, 16, 16), 'bias': 0.1 * _f32(rng, 16)}
         for name in ('query', 'key', 'value', 'output')}
    x = _f32(rng, 2, 7, 16)
    tokens = np.array([[3, 4, 5, 6, 7, 8, 9], [3, 4, 5, 0, 0, 0, 0]])
    mask = tattn.build_padding_mask(tokens = torch.from_numpy(tokens))
    jmask = jattn.build_padding_mask(tokens = jnp.asarray(tokens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    lengths = np.array([7, 3])
    np.testing.assert_array_equal(
        tattn.build_padding_mask(lengths = torch.from_numpy(lengths), max_length = 9).numpy(),
        np.asarray(jattn.build_padding_mask(lengths = jnp.asarray(lengths), max_length = 9)))
    out, cache = tattn.mha(convert_tree(p), torch.from_numpy(x), n_heads = 2, mask = mask)
    ref, _ = jattn.mha(_jax(p), jnp.asarray(x), n_heads = 2, mask = jmask)
    assert cache is None
    _close(out, ref)
    # a masked key changes nothing
    x2 = x.copy()
    x2[1, 3:] = 9.
    out2, _ = tattn.mha(convert_tree(p), torch.from_numpy(x2), n_heads = 2, mask = mask)
    _close(out2[1, :3], out[1, :3].detach().numpy(), atol = 1e-6)
    _close(sinusoidal_embedding(64, 16), jax_sinusoidal(64, 16), atol = 1e-6)


def test_tacotron2_to_jax_round_trip():
    """`weights.tree_to_jax` of the port's Tacotron-2 params and state
    inverts `tacotron2_from_jax` exactly, batch-norm statistics and the
    speaker projection included."""
    from text_to_speech_tpu_torch.init import init_tacotron2
    from text_to_speech_tpu_torch.models.tacotron2_arch import HParamsTacotron2
    from text_to_speech_tpu_torch.weights import tacotron2_from_jax, tree_to_jax
    params, state = init_tacotron2(HParamsTacotron2(
        vocab_size = 20, encoder_embedding_dim = 8, encoder_n_conv = 2, prenet_sizes = (8, 8),
        attention_rnn_dim = 8, decoder_rnn_dim = 8, lsa_attention_dim = 4,
        lsa_attention_filters = 2, postnet_n_conv = 2, postnet_filters = 8,
        speaker_embedding_dim = 4, speaker_concat_pos = 'start'), seed = 3)
    state['postnet']['conv_0']['bn']['moving_var'] += 0.5
    port = tacotron2_from_jax(params, state)
    back = tuple(tree_to_jax(tree) for tree in port)
    for tree, want in zip(back, (params, state)):
        got, ref = flatten_tree(tree), flatten_tree(want)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg = key)
    again = tacotron2_from_jax(* back)
    for tree, want in zip(again, port):
        got, ref = flatten_tree(tree), flatten_tree(want)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert torch.equal(got[key], ref[key]), key
