"""Port `Tacotron2.infer` against the JAX package's on the trained
``pretrained_models/overfit_demo`` checkpoint (location kernel 15, so the
JAX package runs it on its plain while-loop decoder too).

Prenet dropout is always on at inference, and the two packages draw
different random numbers, so only ``deterministic=True`` is comparable.
Tolerance: 1e-4 absolute on mel, gates and alignments — float32 on both
sides over up to 128 autoregressive steps, where summation-order
differences feed back through the decoder state."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models.tacotron2_arch import Tacotron2 as JaxTacotron2
from text_to_speech_tpu_torch.models.saving import load_model_files
from text_to_speech_tpu_torch.models.tacotron2_arch import Tacotron2
from text_to_speech_tpu_torch.text import Tokenizer
from text_to_speech_tpu_torch.weights import tacotron2_from_jax

ATOL = 1e-4
TEXTS = ['The quick brown fox jumps over the lazy dog.', 'Hello world!']


@pytest.fixture(scope = 'module')
def setup():
    files = load_model_files('overfit_demo')
    arch = {k: v for k, v in files['architecture'].items() if k != 'architecture'}
    tok = Tokenizer.load_from_file(
        'pretrained_models/overfit_demo/saving/tokenizer.json')
    encoded = [tok.encode(t) for t in TEXTS]
    tokens = np.zeros((len(encoded), 64), np.int32)        # padded to x64
    for i, e in enumerate(encoded):
        tokens[i, :len(e)] = e
    jparams = _jax(files['params'])
    jstate = _jax(files['state'])
    params, state = tacotron2_from_jax(files['params'], files['state'])
    return JaxTacotron2(** arch), (jparams, jstate), Tacotron2(** arch), (params, state), tokens


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _run(setup, ** kwargs):
    jax_arch, (jparams, jstate), port, (params, state), tokens = setup
    ref = jax_arch.infer(jparams, jstate, jnp.asarray(tokens), deterministic = True, ** kwargs)
    with torch.no_grad():
        out = port.infer(params, state, torch.from_numpy(tokens).long(),
                         deterministic = True, ** kwargs)
    return ref, out


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol = ATOL, rtol = 0)


def test_infer_without_early_stopping(setup):
    ref, out = _run(setup, max_length = 128, early_stopping = False)
    assert out.mel.shape == (2, 128, 80)
    _close(out.mel, ref.mel)
    _close(out.decoder_output, ref.decoder_output)
    _close(out.stop_tokens, ref.stop_tokens)
    _close(out.attention_weights, ref.attention_weights)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))


def test_infer_early_stopping_lengths(setup):
    ref, out = _run(setup, max_length = 256, early_stopping = True)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert 0 < int(out.lengths.min()) < 256      # one row stops on its gate
    _close(out.mel, ref.mel)


def test_infer_attention_window(setup):
    ref, out = _run(setup, max_length = 64, early_stopping = False,
                    attn_mask_win_len = 8, attn_mask_offset = 0.25)
    _close(out.attention_weights, ref.attention_weights)
    _close(out.mel, ref.mel)
    # the window leaves most of every alignment at exactly zero
    assert float((out.attention_weights[:, 1:] == 0).float().mean()) > 0.5


def test_supports_fused_decoder_envelope(setup):
    jax_arch, _, port, _, _ = setup
    for batch, seq_len in ((1, 64), (8, 64), (9, 64), (2, 60)):
        assert port.supports_fused_decoder(batch, seq_len) == \
            jax_arch.supports_fused_decoder(batch, seq_len)
    assert not port.supports_fused_decoder(1, 64)      # location kernel 15


def test_task_buckets_and_refuses_the_fused_decoder(monkeypatch):
    """Tokens pad to x64 and a float `max_length` scales the padded token
    length, rounded up to x64.  The decoder route: the plain loop by default
    on the CPU and outside the fused decoder's envelope; the fused decoder by
    default on a card at every batch inside the envelope, and wherever the
    caller asks for it; asking for it outside the envelope is refused.  On a
    card a model inside the envelope whose widths the CUDA kernel cannot take
    is not sent to the plain loop: the kernel's own check raises."""
    from text_to_speech_tpu_torch.init import init_tacotron2
    from text_to_speech_tpu_torch.models.tts import Tacotron2 as Tacotron2Task
    from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols
    model = Tacotron2Task.from_pretrained('overfit_demo', device = 'cpu')
    tokens = model.encode_text('Hi.')
    out = model.compiled_infer(tokens, max_length = 0.6, deterministic = True,
                               early_stopping = False)
    assert out.mel.shape == (1, 64, 80)            # int(64 * 0.6) = 38 → 64
    assert out.attention_weights.shape == (1, 64, 64)
    with pytest.raises(ValueError):                # location kernel 15: no envelope
        model.compiled_infer(tokens, use_fused_decoder = True)

    tiny = dict(vocab_size = len(en_symbols), n_mel_channels = 8, encoder_embedding_dim = 16,
                encoder_n_conv = 1, encoder_kernel_size = 3, prenet_sizes = (8, 8),
                lsa_attention_dim = 8, lsa_attention_filters = 4, attention_rnn_dim = 16,
                decoder_rnn_dim = 16, postnet_n_conv = 2, postnet_filters = 8,
                postnet_kernel_size = 3)
    model = Tacotron2Task.from_jax(
        * init_tacotron2(Tacotron2(** tiny).hp, seed = 0), device = 'cpu',
        tokenizer = default_english_tokenizer(), ** tiny)
    routes = []
    for name in ('infer', 'infer_fused'):
        original = getattr(model.arch, name)
        monkeypatch.setattr(model.arch, name, lambda * a, _name = name, _fn = original, ** kw:
                            routes.append(_name) or _fn(* a, ** kw))
    kw = dict(max_length = 64, deterministic = True, early_stopping = False)
    plain = model.compiled_infer(tokens, ** kw)
    fused = model.compiled_infer(tokens, use_fused_decoder = True, ** kw)
    model.compiled_infer(tokens, use_fused_decoder = False, ** kw)
    assert routes == ['infer', 'infer_fused', 'infer']
    np.testing.assert_allclose(fused.mel.numpy(), plain.mel.numpy(), atol = ATOL, rtol = 0)
    with pytest.raises(ValueError):                # nine rows
        model.compiled_infer(np.tile(tokens, (9, 1)), use_fused_decoder = True, ** kw)

    # new parameters drop the decoder packed from the old ones
    packed = model._decoder_weights(None)
    assert model._decoder_weights(None) is packed
    model.params = model.params
    assert model._decoder_weights(None) is not packed

    # the default on a card (the model's tensors stay where they are)
    assert not model._use_fused_decoder(1, 64, None)
    monkeypatch.setattr(model, 'device', torch.device('cuda'))
    assert all(model._use_fused_decoder(batch, 64, None) for batch in (1, 2, 4, 8))
    assert not model._use_fused_decoder(9, 64, None)        # outside the envelope
    assert not model._use_fused_decoder(2, 60, None)
    assert model._use_fused_decoder(4, 64, True)

    # 12 units: inside the envelope, no whole slabs of 8 for the CUDA kernel
    from text_to_speech_tpu_torch.ops import decoder_kernel as dk
    odd = dict(tiny, attention_rnn_dim = 12, decoder_rnn_dim = 12)
    odd_model = Tacotron2Task.from_jax(
        * init_tacotron2(Tacotron2(** odd).hp, seed = 0), device = 'cpu',
        tokenizer = default_english_tokenizer(), ** odd)
    plain = odd_model.compiled_infer(tokens, ** kw)
    fused = odd_model.compiled_infer(tokens, use_fused_decoder = True, ** kw)   # plain version
    np.testing.assert_allclose(fused.mel.numpy(), plain.mel.numpy(), atol = ATOL, rtol = 0)
    weights = odd_model._decoder_weights(None)
    assert 'att_w' in weights                               # logical copies stay on the CPU
    monkeypatch.setattr(odd_model, 'device', torch.device('cuda'))
    assert odd_model._use_fused_decoder(1, 64, None)        # not quietly the plain loop
    B, S, D, U = 1, 64, odd['encoder_embedding_dim'], 12
    z = lambda * shape, dtype = torch.float32: torch.zeros(shape, dtype = dtype)
    with pytest.raises(ValueError, match = 'U % 8'):
        dk._check(weights, z(B, S, D), z(B, S, 8), z(B, S), z(B, dtype = torch.int32),
                  z(B, 8), dk.init_decoder_state(B, S, D, U, 8), z(1, dtype = torch.int64), 4)
