"""The port's `models.weights_converter` against the JAX package's, on seeded
numpy trees: every result equal to the bit.

  - names, the mapping and its report, on a source with an ambiguous
    suffix (two same-shape candidates) given in both path orders: the
    transfer takes the first candidate in the source's order, in both
    packages;
  - the name-based transfer in each fill mode ('zeros', 'ones', 'normal'
    on ``RandomState(0)``, 'keep'), with widened, narrowed, unmatched and
    strict cases; the shape-based transfer;
  - `convert_state_dict` with the torch layout transforms, and the Keras
    naming helpers.
"""

import numpy as np
import pytest

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models import weights_converter as jwc

from text_to_speech_tpu_torch.models import weights_converter as wc
from text_to_speech_tpu_torch.weights import flatten_tree


def _tree(spec, seed):
    rng = np.random.default_rng(seed)
    flat = {path: rng.standard_normal(shape).astype(np.float32) for path, shape in spec}
    return wc.unflatten_tree(flat)


SOURCE = [
    ('encoder/conv_0/conv/kernel', (3, 4, 4)), ('encoder/conv_0/conv/bias', (4,)),
    ('encoder/embedding/embeddings', (10, 4)),
    ('decoder/attention_rnn/kernel', (6, 16)), ('decoder/attention_rnn/recurrent_kernel', (4, 16)),
    ('decoder/attention_rnn/bias', (16,)), ('decoder/Layer1/kernel', (4, 4)),
    ('head/dense/kernel', (4, 2)), ('other/dense/kernel', (4, 2)),
    ('wide/proj/kernel', (8, 3)),
]
TARGET = [
    ('encoder/conv_0/conv/kernel', (3, 4, 4)), ('encoder/conv_0/conv/bias', (4,)),
    ('encoder/embedding/embeddings', (10, 4)),
    ('decoder/attention_rnn/kernel', (9, 16)), ('decoder/attention_rnn/recurrent_kernel', (4, 16)),
    ('decoder/attention_rnn/bias', (16,)), ('decoder/layer_1/kernel', (4, 4)),
    ('dense/kernel', (4, 2)), ('wide/proj/kernel', (5, 3)), ('new/gate/kernel', (4, 1)),
]


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _equal_trees(out, ref):
    out, ref = _flat(out), _flat(ref)
    assert list(out) == list(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg = key)


@pytest.mark.parametrize('reverse', [False, True])
def test_mapping_and_report_match_jax(reverse):
    spec = SOURCE[::-1] if reverse else SOURCE
    source, target = _tree(spec, 0), _tree(TARGET, 1)
    names = [p for p, _ in SOURCE + TARGET] + ['Block-3/Flow2/conv.7', 'a.b_c/cell3']
    assert [wc._normalize_name(n) for n in names] == [jwc._normalize_name(n) for n in names]
    s_flat, t_flat = flatten_tree(source), flatten_tree(target)
    mapping = wc.find_layers_mapping(s_flat, t_flat)
    assert mapping == jwc.find_layers_mapping(s_flat, t_flat)
    # the ambiguous suffix: both sources, in the source's order
    assert mapping['dense/kernel'] == [p for p, _ in spec if p.endswith('/dense/kernel')]
    assert wc.describe_mapping(source, target, show_values = True) \
        == jwc.describe_mapping(source, target, show_values = True)


@pytest.mark.parametrize('fill_mode', ['zeros', 'ones', 'normal', 'keep'])
@pytest.mark.parametrize('reverse', [False, True])
def test_name_based_transfer_matches_jax(fill_mode, reverse):
    source = _tree(SOURCE[::-1] if reverse else SOURCE, 2)
    target = _tree(TARGET, 3)
    out = wc.name_based_partial_transfer_learning(source, target, fill_mode = fill_mode)
    ref = jwc.name_based_partial_transfer_learning(source, target, fill_mode = fill_mode)
    _equal_trees(out, ref)
    flat, s_flat, t_flat = _flat(out), _flat(source), _flat(target)
    first = next(p for p, _ in (SOURCE[::-1] if reverse else SOURCE)
                 if p.endswith('/dense/kernel'))
    np.testing.assert_array_equal(flat['dense/kernel'], s_flat[first])
    # widened: the source's block, the rest filled; narrowed: the block
    np.testing.assert_array_equal(flat['decoder/attention_rnn/kernel'][:6],
                                  s_flat['decoder/attention_rnn/kernel'])
    rest = flat['decoder/attention_rnn/kernel'][6:]
    if fill_mode == 'keep':
        np.testing.assert_array_equal(rest, t_flat['decoder/attention_rnn/kernel'][6:])
    elif fill_mode in ('zeros', 'ones'):
        assert np.all(rest == (fill_mode == 'ones'))
    np.testing.assert_array_equal(flat['wide/proj/kernel'], s_flat['wide/proj/kernel'][:5])
    np.testing.assert_array_equal(flat['new/gate/kernel'], t_flat['new/gate/kernel'])
    for strict in (wc, jwc):
        with pytest.raises(ValueError, match = 'new/gate/kernel'):
            strict.name_based_partial_transfer_learning(source, target, strict = True)


def test_partial_fill_and_shape_transfer_match_jax():
    rng = np.random.default_rng(4)
    target, source = (rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (3, 9)))
    for mode in ('zeros', 'ones', 'normal', 'keep'):
        np.testing.assert_array_equal(wc._partial_fill(target, source, mode),
                                      jwc._partial_fill(target, source, mode))
    source, target = _tree(SOURCE, 5), _tree(TARGET, 6)
    _equal_trees(wc.partial_transfer_learning(source, target),
                 jwc.partial_transfer_learning(source, target))


def test_state_dict_and_keras_conversion_match_jax():
    rng = np.random.default_rng(7)
    sd = {'encoder.convolutions.0.0.conv.weight': rng.standard_normal((4, 3, 5)),
          'decoder.linear.weight': rng.standard_normal((6, 4)),
          'decoder.lstm.weight_ih': rng.standard_normal((16, 3)),
          'unmapped.thing': rng.standard_normal((2,))}
    patterns = {r'^encoder\.convolutions\.(\d+)\.0\.conv\.weight$': r'encoder/conv_\1/conv/kernel',
                r'^decoder\.linear\.weight$': 'decoder/linear/kernel',
                r'^decoder\.lstm\.weight_ih$': 'decoder/lstm/kernel'}
    transforms = lambda package: {r'conv\.weight$': package.torch_conv1d_kernel,
                                  r'linear\.weight$': package.torch_dense_kernel,
                                  r'weight_ih$': package.torch_lstm_kernel}
    _equal_trees(wc.convert_state_dict(sd, patterns, transforms = transforms(wc)),
                 jwc.convert_state_dict(sd, patterns, transforms = transforms(jwc)))
    keras = {'tacotron2/encoder/conv_1/kernel/.ATTRIBUTES/VARIABLE_VALUE': (5, 4, 4),
             'model/encoder/norm_1/moving_variance': (4,), 'encoder/norm_1/gamma': (4,),
             'tacotron2/decoder_rnn/stacked_rnn_cells/cell_0/lstm_cell/kernel': (8, 16),
             'prenet/layer_1/bias': (4,), 'postnet/conv_2/bias': (8,),
             'char_embeddings/embeddings': (10, 4), 'gate_output/kernel': (8, 1),
             'already/canonical/kernel': (2, 2)}
    variables = {k: rng.standard_normal(s).astype(np.float32) for k, s in keras.items()}
    assert [wc.normalize_keras_name(k) for k in keras] \
        == [jwc.normalize_keras_name(k) for k in keras]
    out, ref = wc.apply_keras_patterns(variables), jwc.apply_keras_patterns(variables)
    assert list(out) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key])
    for o, r in zip(wc.convert_keras_variables(variables), jwc.convert_keras_variables(variables)):
        _equal_trees(o, r)
