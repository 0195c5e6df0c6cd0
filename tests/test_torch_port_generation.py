"""The port's generation (`models/transformers/generation_utils.py`) against
the JAX package's, on the CPU.

  - `process_logits`: temperature, top-k, nucleus, forbidden tokens, a
    length temperature, a filter list and a filter callable;
  - greedy `generate` and `beam_search` on a GPT-2-style and a
    Mistral-style MoE decoder (RoPE, grouped KV heads, RMS norm, experts):
    tokens, lengths and scores equal to the JAX package's, with an eos that
    stops some rows early; the logits along the generated tokens within
    1e-5;
  - an encoder-decoder (T5-style) greedy decode, equal to the JAX
    `beam_search` with one beam (the JAX greedy loop drops the encoder
    output after the prompt; ROADMAP §3);
  - the all-finished flag read every `CHECK_EVERY` steps gives the tokens,
    lengths and scores of a check at every step;
  - sampling by properties (its draws are a `torch.Generator`'s, not
    ``jax.random``'s): a seed repeats, ``top_k=1`` is greedy, every token in
    the vocabulary.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from torch_port_gan_util import compile_fast

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models.transformers import generation_utils as jax_generation
from text_to_speech_tpu.models.transformers import transformer_arch as jax_arch
from text_to_speech_tpu.models.transformers.families import EncoderDecoder as JaxEncoderDecoder
from text_to_speech_tpu_torch.models.transformers import generation_utils, transformer_arch
from text_to_speech_tpu_torch.models.transformers.families import EncoderDecoder
from text_to_speech_tpu_torch.weights import transformer_from_jax

BASE = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 2, ffn_dim = 64, max_position = 40)
MODELS = {
    'gpt2': dict(ffn_activation = 'gelu_new'),
    'mixtral': dict(positional = 'rope', n_heads = 4, n_kv_heads = 2, norm = 'rms',
                    gated_ffn = True, ffn_activation = 'silu', use_bias = False,
                    tie_embeddings = False, n_experts = 4, n_experts_per_token = 2),
}
PROMPTS = np.array([[5, 9, 13, 2], [7, 3, 1, 8], [11, 4, 6, 10]])
NEW = 8


def _port(tree):
    return transformer_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _equal(out, ref):
    assert out.tokens.tolist() == np.asarray(ref.tokens).tolist()
    assert out.lengths.tolist() == np.asarray(ref.lengths).tolist()
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), atol = 1e-5, rtol = 0)


@pytest.fixture(scope = 'module', params = sorted(MODELS))
def decoder(request):
    cfg = dict(BASE, ** MODELS[request.param])
    jm = jax_arch.Transformer(** cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    pm = transformer_arch.Transformer(** cfg)
    pp = _port(jp)
    # an eos that the greedy decode emits mid-way in some row, not at once
    greedy = generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = NEW, device = 'cpu')
    eos = int(greedy.tokens[0, 4 + 3])
    return jm, jp, pm, pp, eos


# -- process_logits ------------------------------------------------------------------

LOGITS_CASES = {
    'temperature': dict(temperature = 0.7),
    'top_k': dict(top_k = 5),
    'top_p': dict(top_p = 0.6),
    'forbidden': dict(forbidden_tokens = [1, 3, 7]),
    'length_temperature': dict(length_temperature = 0.5, lengths = [1, 4, 9]),
    'filter_ids': dict(logits_filter = [0, 2], top_k = 3),
    'filter_callable': dict(logits_filter = 'callable', temperature = 2., top_p = 0.9),
}


@pytest.mark.parametrize('case', sorted(LOGITS_CASES))
def test_process_logits_matches_jax(case):
    kw = dict(LOGITS_CASES[case])
    logits = np.random.default_rng(0).normal(0., 2., (3, 16)).astype(np.float32)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get('logits_filter') == 'callable':
        jkw['logits_filter'] = lambda x: x * 0.5 + 1.
        pkw['logits_filter'] = lambda x: x * 0.5 + 1.
    ref = np.asarray(jax_generation.process_logits(jnp.asarray(logits), ** jkw))
    out = generation_utils.process_logits(torch.from_numpy(logits), ** pkw).numpy()
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[~np.isinf(out)], ref[~np.isinf(ref)], atol = 1e-6, rtol = 0)


# -- greedy and beam against the JAX package ----------------------------------------

@pytest.mark.parametrize('method', ['greedy', 'beam'])
def test_generate_matches_jax(decoder, method):
    jm, jp, pm, pp, eos = decoder
    kw = dict(max_new_tokens = NEW, eos_token = eos, method = method, num_beams = 3,
              length_penalty = 0.8)

    def jax_run(jp, prompts):
        out = jax_generation.generate(jm, jp, prompts, ** kw)
        return out, jm.decode(jp, out.tokens)[0]       # the logits along its tokens
    args = (jp, jnp.asarray(PROMPTS, jnp.int32))
    ref, ref_logits = compile_fast(jax_run, * args)(* args)
    out = generation_utils.generate(pm, pp, PROMPTS, device = 'cpu', ** kw)
    _equal(out, ref)
    if method == 'greedy':
        assert out.lengths.min() < out.lengths.max()      # the eos stopped a row
    logits, _ = pm.decode(pp, out.tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol = 1e-5, rtol = 0)


def test_encoder_decoder_greedy_matches_jax_single_beam():
    cfg = dict(BASE, positional = 'none', norm = 'rms', use_bias = False,
               use_relative_bias = True, rel_buckets = 8, attention_scale = 1.0,
               use_cross_attention = True, ffn_activation = 'relu')
    jm = JaxEncoderDecoder(jax_arch.Transformer(** cfg), jax_arch.Transformer(** cfg))
    jp = jm.init(jax.random.PRNGKey(5))
    pm = EncoderDecoder(transformer_arch.Transformer(** cfg), transformer_arch.Transformer(** cfg))
    pp = _port(jp)
    src = np.array([[5, 9, 13, 2, 7], [4, 8, 1, 0, 0]])
    start = np.zeros((2, 1), np.int64)

    def jax_run(jp, src, start):
        enc, mask = jm.encode(jp, src)
        return enc, jax_generation.beam_search(jm, jp, start, max_new_tokens = 6, num_beams = 1,
                                               encoder_output = enc, encoder_mask = mask)
    args = (jp, jnp.asarray(src, jnp.int32), jnp.asarray(start, jnp.int32))
    enc, ref = compile_fast(jax_run, * args)(* args)
    penc, pmask = pm.encode(pp, torch.from_numpy(src))
    np.testing.assert_allclose(penc.numpy(), np.asarray(enc), atol = 1e-5, rtol = 0)
    out = generation_utils.generate(pm, pp, start, max_new_tokens = 6, encoder_output = penc,
                                    encoder_mask = pmask, device = 'cpu')
    _equal(out, ref)
    beam = generation_utils.generate(pm, pp, start, max_new_tokens = 6, method = 'beam',
                                     num_beams = 1, encoder_output = penc,
                                     encoder_mask = pmask, device = 'cpu')
    _equal(beam, ref)


# -- the port alone -----------------------------------------------------------------

@pytest.mark.parametrize('method', ['greedy', 'beam'])
def test_check_every_equals_a_check_at_every_step(decoder, method, monkeypatch):
    """Rows finish at different steps, all before the end (the eos is a
    token of every row's greedy continuation); reading the all-finished flag
    every 1, 3 or 64 steps gives the same result."""
    _, _, pm, pp, _ = decoder
    prompts = np.random.default_rng(1).integers(1, 64, (16, 4))
    free = generation_utils.generate(pm, pp, prompts, max_new_tokens = 16,
                                     device = 'cpu').tokens[:, 4:].tolist()
    counts = np.bincount([t for row in free for t in set(row)], minlength = 64)
    eos = int(np.argmax(counts))
    prompts = prompts[[eos in row for row in free]]
    assert len(prompts) >= 2
    outs = []
    for n in (1, 3, 64):
        monkeypatch.setattr(generation_utils, 'CHECK_EVERY', n)
        outs.append(generation_utils.generate(pm, pp, prompts, max_new_tokens = 16,
                                              eos_token = eos, method = method, num_beams = 2,
                                              device = 'cpu'))
    if method == 'greedy':
        assert outs[0].lengths.max() < 4 + 16 and outs[0].lengths.min() < outs[0].lengths.max()
    for out in outs[1:]:
        assert torch.equal(out.tokens, outs[0].tokens)
        assert torch.equal(out.lengths, outs[0].lengths)
        assert torch.equal(out.scores, outs[0].scores)


def test_sampling_properties(decoder):
    _, _, pm, pp, _ = decoder
    run = lambda ** kw: generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = NEW,
                                                  method = 'sample', device = 'cpu', ** kw)
    a, b = run(rng = 11), run(rng = torch.Generator().manual_seed(11))
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.scores, b.scores)
    assert ((a.tokens >= 0) & (a.tokens < 64)).all()
    hot = [run(rng = s, temperature = 5.) for s in range(3)]
    assert len({tuple(h.tokens.flatten().tolist()) for h in hot}) > 1
    greedy = generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = NEW, device = 'cpu')
    assert torch.equal(run(rng = 4, top_k = 1).tokens, greedy.tokens)


def test_generate_needs_a_device(decoder):
    _, _, pm, pp, _ = decoder
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is unavailable to refuse')
    with pytest.raises(RuntimeError, match = 'device'):
        generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = 2)


def test_trace_records_each_choice_margin(decoder):
    """`trace` (the tie rule of `chip_smoke.py`'s card-against-CPU checks):
    greedy, each step's top-two logit gap along the generated tokens; beam,
    a gap a step and one for the choice of beam, none negative."""
    _, _, pm, pp, _ = decoder
    trace = []
    out = generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = NEW, device = 'cpu',
                                    trace = trace)
    assert len(trace) == NEW
    logits, _ = pm.decode(pp, out.tokens)
    top = torch.topk(logits[:, 3: 3 + NEW], 2, dim = -1).values
    np.testing.assert_allclose(torch.stack(trace, dim = 1).numpy(),
                               (top[..., 0] - top[..., 1]).numpy(), atol = 1e-5, rtol = 0)
    beam = []
    generation_utils.generate(pm, pp, PROMPTS, max_new_tokens = NEW, method = 'beam',
                              num_beams = 3, device = 'cpu', trace = beam)
    assert len(beam) == NEW + 1 and all(bool((m >= 0).all()) for m in beam)
