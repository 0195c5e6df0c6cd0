"""Autoregressive token generation over KV caches.

Counterpart of ``text_to_speech_tpu/models/transformers/generation_utils.py``:
`InferenceOutput`, `process_logits`, `generate` (greedy, sampling, beam)
and `beam_search` with the beams folded into the batch.  The JAX
``lax.while_loop`` becomes a Python loop over preallocated buffers and the
caches, written in place.  The loop reads the all-finished flag to the host
once every `CHECK_EVERY` steps, not at every step: a finished row writes 0
and adds nothing to its length or score (a finished beam extends with 0 at
no cost and keeps its rank), so the steps past the last finish change
nothing and the result equals a check at every step.

Sampling draws Gumbel noise from a `torch.Generator` (``rng``: a seed or a
generator), not ``jax.random.categorical`` over ``fold_in`` keys: a sampled
run is reproducible in the port but not equal to the JAX run.

The greedy and sampling loop passes `encoder_output` to every step; the
JAX loop passes it to the prompt's pass only, so an encoder-decoder's
later steps there skip cross-attention.  The port's greedy tokens equal
the JAX `beam_search` with one beam, which passes it at every step.
"""

import collections

import torch

from ...devices import default_device
from ...nn import layers as nn

InferenceOutput = collections.namedtuple('InferenceOutput', ['tokens', 'lengths', 'scores'])

#: steps between two reads of the all-finished flag (each read waits for the device)
CHECK_EVERY = 8


def _forbid(logits, ids):
    logits = logits.clone()
    logits[..., torch.as_tensor(ids, device = logits.device)] = float('-inf')
    return logits


def process_logits(logits, *, temperature = 1.0, top_k = None, top_p = None,
                   forbidden_tokens = None, lengths = None, length_temperature = None,
                   logits_filter = None):
    """Temperature + top-k + nucleus filtering (masked entries → -inf).

    `length_temperature` scales logits by ``(length + 1) ** t`` given the
    current `lengths`; `logits_filter` is a callable ``logits -> logits`` or
    a list of token ids to forbid."""
    if temperature != 1.0:
        logits = logits / temperature
    if length_temperature is not None and lengths is not None:
        scale = (torch.as_tensor(lengths, dtype = logits.dtype, device = logits.device)
                 + 1.) ** length_temperature
        logits = logits * scale.reshape((-1,) + (1,) * (logits.dim() - 1))
    if logits_filter is not None:
        logits = logits_filter(logits) if callable(logits_filter) \
            else _forbid(logits, logits_filter)
    if forbidden_tokens is not None:
        logits = _forbid(logits, forbidden_tokens)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim = -1).values[..., -1:]
        logits = torch.where(logits < kth, float('-inf'), logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim = -1, descending = True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim = -1), dim = -1)
        cutoff_idx = torch.clamp((cum < top_p).sum(dim = -1, keepdim = True),
                                 max = logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float('-inf'), logits)
    return logits


def gumbel_argmax(logits, gen):
    """A draw from ``softmax(logits)`` per row: the argmax of the logits
    plus Gumbel noise from `gen`."""
    noise = torch.empty_like(logits, dtype = torch.float32).exponential_(generator = gen)
    return torch.argmax(logits - torch.log(noise), dim = -1)


def _prompt(prompt_tokens, device):
    return torch.as_tensor(prompt_tokens, device = device).to(torch.long)


def generate(model, params, prompt_tokens, *, max_new_tokens = 64, eos_token = None,
             method = 'greedy', temperature = 1.0, top_k = None, top_p = None,
             num_beams = 4, length_penalty = 1.0, encoder_output = None,
             encoder_mask = None, rng = None, device = None, trace = None):
    """Generate continuations of `prompt_tokens` (B, T0) on `device` (cuda
    unless given; `params` live there).

    method: 'greedy' | 'sample' | 'beam'.  `trace`: a list that receives
    the margin of each step's choice, a (B,) tensor: the gap between the
    top two processed logits of each row (beam: `beam_search`'s).  Returns
    InferenceOutput(tokens (B, T0 + max_new_tokens), lengths, scores)."""
    device = default_device(device)
    if method == 'beam':
        return beam_search(model, params, prompt_tokens, max_new_tokens = max_new_tokens,
                           eos_token = eos_token, num_beams = num_beams,
                           length_penalty = length_penalty, encoder_output = encoder_output,
                           encoder_mask = encoder_mask, device = device, trace = trace)
    prompt = _prompt(prompt_tokens, device)
    B, T0 = prompt.shape
    gen = nn.generator(0 if rng is None else rng, device) if method == 'sample' else None

    caches = model.init_caches(B, T0 + max_new_tokens, device = device)
    logits, caches = model.decode(params, prompt, caches = caches,
                                  encoder_output = encoder_output, encoder_mask = encoder_mask)
    logits = logits[:, -1]
    tokens = torch.cat([prompt, torch.zeros((B, max_new_tokens), dtype = prompt.dtype,
                                            device = device)], dim = 1)
    finished = torch.zeros((B,), dtype = torch.bool, device = device)
    lengths = torch.zeros((B,), dtype = torch.long, device = device)
    scores = torch.zeros((B,), device = device)
    for t in range(max_new_tokens):
        if t and t % CHECK_EVERY == 0 and bool(finished.all()):
            break
        processed = process_logits(logits, temperature = temperature, top_k = top_k,
                                   top_p = top_p)
        tok = gumbel_argmax(processed, gen) if method == 'sample' \
            else torch.argmax(processed, dim = -1)
        if trace is not None:
            top = torch.topk(processed, 2, dim = -1).values
            trace.append(top[:, 0] - top[:, 1])
        tok_score = torch.log_softmax(logits, dim = -1).gather(-1, tok[:, None])[:, 0]
        now_finished = finished | (tok == eos_token) if eos_token is not None else finished
        tok = torch.where(finished, 0, tok)
        tokens[:, T0 + t] = tok
        lengths = lengths + (~finished).to(torch.long)
        scores = scores + torch.where(finished, 0., tok_score)
        finished = now_finished
        if t + 1 < max_new_tokens:
            logits, caches = model.decode(params, tok[:, None], caches = caches,
                                          encoder_output = encoder_output,
                                          encoder_mask = encoder_mask)
            logits = logits[:, -1]
    return InferenceOutput(tokens = tokens, lengths = T0 + lengths, scores = scores)


def beam_search(model, params, prompt_tokens, *, max_new_tokens = 64, eos_token = None,
                num_beams = 4, length_penalty = 1.0, encoder_output = None,
                encoder_mask = None, device = None, trace = None):
    """Batched beam search: beams folded into the batch axis (B*K rows).
    Returns the best beam of each row by length-penalized score.  `trace`:
    a list that receives, each step, each row's gap between its last kept
    and its first dropped candidate (B,), and at the end the gap between
    its best and second-best length-penalized beam."""
    device = default_device(device)
    prompt = _prompt(prompt_tokens, device)
    B, T0 = prompt.shape
    K = num_beams
    flat = torch.repeat_interleave(prompt, K, dim = 0)
    if encoder_output is not None:
        encoder_output = torch.repeat_interleave(encoder_output, K, dim = 0)
        if encoder_mask is not None:
            encoder_mask = torch.repeat_interleave(encoder_mask, K, dim = 0)

    caches = model.init_caches(B * K, T0 + max_new_tokens, device = device)
    logits, caches = model.decode(params, flat, caches = caches,
                                  encoder_output = encoder_output, encoder_mask = encoder_mask)
    logits = logits[:, -1]
    V = logits.shape[-1]
    tokens = torch.cat([flat, torch.zeros((B * K, max_new_tokens), dtype = flat.dtype,
                                          device = device)], dim = 1)
    # beam 0 starts live, the others at -1e9 so that the first expansion
    # seeds from it
    scores = torch.tensor([0.] + [-1e9] * (K - 1), device = device).repeat(B)
    finished = torch.zeros((B * K,), dtype = torch.bool, device = device)
    lengths = torch.zeros((B * K,), dtype = torch.long, device = device)
    base = torch.arange(B, device = device)[:, None] * K
    pad_only = torch.full((V,), -1e9, device = device)
    pad_only[0] = 0.

    for t in range(max_new_tokens):
        if t and t % CHECK_EVERY == 0 and bool(finished.all()):
            break
        logp = torch.log_softmax(logits, dim = -1)
        # finished beams only extend with a pad at no cost
        logp = torch.where(finished[:, None], pad_only, logp)
        cand = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = torch.topk(cand, K, dim = -1)
        if trace is not None:
            dropped = torch.topk(cand, K + 1, dim = -1).values[:, K]
            trace.append(top_scores[:, -1] - dropped)
        src = (torch.div(top_idx, V, rounding_mode = 'floor') + base).reshape(-1)
        new_tok = (top_idx % V).reshape(-1)
        tokens = tokens[src]
        tokens[:, T0 + t] = new_tok
        was_finished = finished[src]
        finished = was_finished | (new_tok == eos_token) if eos_token is not None \
            else was_finished
        lengths = lengths[src] + (~was_finished).to(torch.long)
        scores = top_scores.reshape(-1)
        if t + 1 < max_new_tokens:
            caches = [{'k': c['k'][src], 'v': c['v'][src], 'index': c['index']}
                      for c in caches]
            logits, caches = model.decode(params, new_tok[:, None], caches = caches,
                                          encoder_output = encoder_output,
                                          encoder_mask = encoder_mask)
            logits = logits[:, -1]

    scores = scores.reshape(B, K)
    lengths = lengths.reshape(B, K)
    norm = scores / torch.clamp(lengths.to(torch.float32), min = 1.) ** length_penalty
    best = torch.argmax(norm, dim = -1)
    if trace is not None and K > 1:
        top = torch.topk(norm, 2, dim = -1).values
        trace.append(top[:, 0] - top[:, 1])
    rows = torch.arange(B, device = device)
    return InferenceOutput(tokens = tokens[best + rows * K], lengths = T0 + lengths[rows, best],
                           scores = scores[rows, best])
