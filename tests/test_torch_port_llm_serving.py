"""Token-level LLM serving (`runtimes/llm_serving.py`) against the JAX
package's, on the CPU.

  - the port's stepper and the JAX stepper, each in its package's
    `ContinuousServingEngine`, on the same greedy requests (prompts of
    three lengths, budgets that end at different chunks, more requests
    than slots): every request's tokens equal;
  - the behaviours that the JAX package's ``tests/test_llm_serving.py``
    pins, on the port: greedy rows equal the offline `generate`; budgets
    and methods mixed in one batch; a per-request eos stops its row and is
    not emitted; `allowed_tokens`; abort mid-decode; a reused slot does not
    see its previous occupant; streamed text fragments and a regex stop
    condition; `make_llm_engine`; prompt validation; `warmup`; and the
    port's own `warm_thread`, ``mesh=`` and device rule.

Sampled rows draw from a `torch.Generator` a chunk, not ``jax.random``:
they are held by properties (in the vocabulary, the budget met).
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
from text_to_speech_tpu.models.transformers import Transformer as JaxTransformer
from text_to_speech_tpu.runtimes.llm_serving import make_transformer_stepper as jax_stepper
from text_to_speech_tpu.runtimes.serving import ContinuousServingEngine as JaxEngine
from text_to_speech_tpu_torch.models.transformers import Transformer, generate
from text_to_speech_tpu_torch.runtimes.llm_serving import make_llm_engine, make_transformer_stepper
from text_to_speech_tpu_torch.runtimes.serving import ContinuousServingEngine
from text_to_speech_tpu_torch.weights import transformer_from_jax

TINY = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 2, ffn_dim = 64,
            max_position = 128)
TIMEOUT = 120
STEPPER = dict(max_batch = 4, max_length = 64, chunk = 4, prompt_multiple = 8)


class _FakeTokenizer:
    """Duck-typed char tokenizer: id = 1 + (ord - 97); decode inverse."""

    def encode(self, text):
        return [1 + (ord(c) - 97) % 26 for c in text if c.isalpha()] or [1]

    def decode(self, ids):
        return ''.join(chr(97 + (i - 1) % 26) for i in ids)


@pytest.fixture(scope = 'module')
def lm():
    cfg = dict(TINY, norm_first = True, positional = 'learned')
    jm = JaxTransformer(** cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return Transformer(** cfg), params, jm, jp


@pytest.fixture(scope = 'module')
def stepper(lm):
    model, params, _, _ = lm
    return make_transformer_stepper(model, params, device = 'cpu', ** STEPPER)


def _serve(engine_cls, stepper, jobs, max_batch = 4):
    start_fn, step_fn, finish_fn = stepper
    with engine_cls(start_fn, step_fn, finish_fn, max_batch_size = max_batch,
                    name = 'llm-t') as eng:
        reqs = [eng.submit(inputs, ** kw) for inputs, kw in jobs]
        return [r.result.get(timeout = TIMEOUT) for r in reqs], eng


def _offline(lm, prompt, n):
    model, params, _, _ = lm
    out = generate(model, params, prompt[None], max_new_tokens = n, device = 'cpu')
    return out.tokens[0, len(prompt):].tolist()


PROMPT = np.asarray([3, 7, 11, 2], np.int64)


def test_greedy_rows_match_the_jax_stepper(lm, stepper):
    model, params, jm, jp = lm
    rng = np.random.default_rng(0)
    jobs = [(rng.integers(1, 64, n), dict(max_new_tokens = b))
            for n, b in ((4, 11), (9, 6), (1, 13), (12, 3), (5, 9), (7, 7))]
    ref, _ = _serve(JaxEngine, jax_stepper(jm, jp, ** STEPPER), jobs)
    outs, eng = _serve(ContinuousServingEngine, stepper, jobs)
    for out, r, (prompt, kw) in zip(outs, ref, jobs):
        assert out['tokens'] == r['tokens']
        assert out['n_tokens'] == kw['max_new_tokens']
        assert out['prompt_tokens'] == r['prompt_tokens'] == prompt.tolist()
    assert eng.stats['requests'] == len(jobs)


def test_greedy_parity_with_offline_generate(lm, stepper):
    outs, _ = _serve(ContinuousServingEngine, stepper, [(PROMPT, dict(max_new_tokens = 12))])
    assert outs[0]['tokens'] == _offline(lm, PROMPT, 12)
    assert outs[0]['n_tokens'] == 12 and outs[0]['first_token_s'] > 0


def test_concurrent_heterogeneous_requests(stepper):
    jobs = [(PROMPT, dict(max_new_tokens = 9)),
            (np.asarray([5, 9]), dict(max_new_tokens = 3)),
            (np.asarray([1]), dict(max_new_tokens = 6, method = 'sample', temperature = 1.3))]
    outs, eng = _serve(ContinuousServingEngine, stepper, jobs)
    assert [o['n_tokens'] for o in outs] == [9, 3, 6]
    assert all(0 <= t < TINY['vocab_size'] for o in outs for t in o['tokens'])
    assert eng.stats['requests'] == 3


def test_eos_stops_and_is_stripped(lm, stepper):
    ref = _offline(lm, PROMPT, 12)
    eos = next(t for t in ref if t != ref[0])
    outs, _ = _serve(ContinuousServingEngine, stepper,
                     [(PROMPT, dict(max_new_tokens = 12, eos_token = eos))])
    assert outs[0]['tokens'] == ref[:ref.index(eos)]
    assert eos not in outs[0]['tokens']


def test_allowed_tokens_mask(stepper):
    allowed = [4, 8, 15]
    outs, _ = _serve(ContinuousServingEngine, stepper, [
        (np.asarray([3, 7]), dict(max_new_tokens = 8, allowed_tokens = allowed)),
        (np.asarray([5, 9]), dict(max_new_tokens = 4))])
    assert outs[0]['n_tokens'] == 8 and all(t in allowed for t in outs[0]['tokens'])
    assert outs[1]['n_tokens'] == 4


def test_abort_mid_decode(stepper):
    start_fn, step_fn, finish_fn = stepper
    cell = {}
    with ContinuousServingEngine(start_fn, step_fn, finish_fn, max_batch_size = 4,
                                 name = 'llm-abort') as eng:
        # the victim aborts itself at its first streamed chunk
        victim = eng.submit(np.asarray([2, 4]), max_new_tokens = 50,
                            on_token = lambda f, t: cell['req'].abort() if 'req' in cell
                            else None)
        cell['req'] = victim
        keeper = eng.submit(PROMPT, max_new_tokens = 8)
        out = keeper.result.get(timeout = TIMEOUT)
        with pytest.raises(Exception):
            victim.result.get(timeout = TIMEOUT)
    assert out['n_tokens'] == 8


def test_slot_reuse_isolation(lm, stepper):
    ref = _offline(lm, PROMPT, 6)
    start_fn, step_fn, finish_fn = stepper
    with ContinuousServingEngine(start_fn, step_fn, finish_fn, max_batch_size = 4,
                                 name = 'llm-churn') as eng:
        churn = [eng.submit(np.asarray([i + 1, i + 2]), max_new_tokens = 3) for i in range(6)]
        for r in churn:
            r.result.get(timeout = TIMEOUT)
        assert eng.submit(PROMPT, max_new_tokens = 6).result.get(timeout = TIMEOUT)['tokens'] \
            == ref


def test_streaming_detok_and_stop_condition(lm):
    model, params, _, _ = lm
    start_fn, step_fn, finish_fn = make_transformer_stepper(
        model, params, _FakeTokenizer(), max_batch = 2, max_length = 64, chunk = 2,
        prompt_multiple = 8, device = 'cpu')
    frags, ids = [], []
    with ContinuousServingEngine(start_fn, step_fn, finish_fn, max_batch_size = 2,
                                 name = 'llm-stream') as eng:
        out = eng.infer('hello', max_new_tokens = 20, timeout = TIMEOUT,
                        on_token = lambda f, t: (frags.append(f), ids.extend(t)))
        assert ''.join(frags) == out['text'] and ids == out['tokens']
        assert out['first_token_s'] > 0
        stop_char = out['text'][0]
        out2 = eng.infer('hello', max_new_tokens = 20, stop_condition = stop_char,
                         timeout = TIMEOUT)
        assert len(out2['tokens']) < 20 and stop_char in out2['text']
        out3 = eng.infer('hello', max_new_tokens = 20, timeout = TIMEOUT,
                         stop_condition = lambda text: len(text) >= 3)
        assert 3 <= len(out3['tokens']) <= 4                     # a chunk boundary


def test_make_llm_engine_warmup_and_validation(lm, stepper):
    model, params, _, _ = lm
    eng = make_llm_engine(model, params, max_batch = 2, max_length = 64, chunk = 4,
                          prompt_multiple = 8, max_new_tokens = 4, device = 'cpu')
    assert eng.start_fn.batchable_kwargs[-1] == 'rng' and eng.finish_fn.async_ok
    eng.warmup(np.asarray([3, 7]))
    with eng:
        out = eng.infer(np.asarray([3, 7, 11]), timeout = TIMEOUT)
    assert out['n_tokens'] == 4
    start_fn = stepper[0]
    with pytest.raises(ValueError):
        start_fn(np.arange(70))                      # > max_length - 1
    with pytest.raises(ValueError):
        start_fn(np.asarray([], np.int64))
    with pytest.raises(ValueError):
        start_fn('text without tokenizer')


def test_mesh_device_and_warm_thread(lm, stepper):
    model, params, _, _ = lm
    # a mesh serves only across the ranks of a process group (parallel.spawn),
    # and its slots divide over the data shards, as in the JAX package
    from text_to_speech_tpu_torch.parallel import create_mesh
    with pytest.raises(RuntimeError, match = 'process group'):
        make_transformer_stepper(model, params, max_batch = 4,
                                 mesh = create_mesh({'dp': 2}, devices = [0, 1], platform = 'cpu'))
    with pytest.raises(ValueError, match = 'divide'):
        make_transformer_stepper(model, params, max_batch = 4,
                                 mesh = create_mesh({'dp': 3}, devices = [0, 1, 2],
                                                    platform = 'cpu'))
    stepper[1].warm_thread()                         # nothing to warm on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match = 'device'):
            make_transformer_stepper(model, params)
