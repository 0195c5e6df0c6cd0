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
