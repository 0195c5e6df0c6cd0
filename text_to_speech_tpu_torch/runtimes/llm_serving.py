"""Token-level LLM serving: continuous (in-flight) batching over KV caches.

Counterpart of ``text_to_speech_tpu/runtimes/llm_serving.py``: batched
streaming autoregressive generation of a decoder-only `Transformer` with
per-request stop conditions (eos, a token budget, a regex or a callable on
the decoded text), allowed-token masks, abort and incremental
detokenization, served through the same `ContinuousServingEngine` that
runs the TTS steppers (`runtimes/serving.py`).  The design is the JAX
module's:

- **One slot batch on the device.** The KV caches are one
  (max_batch, kv_heads, max_length, head_dim) buffer a layer; every
  request owns a row for its lifetime, and every chunk steps all rows,
  the inactive ones frozen.
- **A per-row cache index.** The JAX stepper `vmap`s a one-row decode to
  turn its scalar cache index into one a row; the port's attention takes
  a (B,) index directly (`models/transformers/attention.py`), from which
  the causal mask, the positions and the write position follow per row.
  A frozen row writes its pad token's keys at its parked index, which the
  next admission into the slot overwrites.
- **Chunks.** Each engine step runs `chunk` decode steps for all rows,
  then reads the tokens, counts and finish flags to the host in one
  transfer; admission happens at chunk boundaries.
- **Right-padded prefill.** An admission burst is one batched prefill of
  the prompts padded to a multiple of `prompt_multiple` (its caches only
  as long as the padded prompts), and one scatter of the burst's rows into
  their slots; row r's valid keys are [0, P_r) and its index is P_r: the
  pad keys beyond are never attended (``key <= index``) and are
  overwritten by the decode.

Each chunk's random draws come from a `torch.Generator` seeded ``seed +``
the chunk counter (the JAX stepper splits ``PRNGKey(seed + counter)``), so
sampled rows are reproducible in the port but not equal to the JAX
stepper's.

``mesh=`` (a `parallel.Mesh`) serves across its data shards through
`runtimes.serving.mesh_stepper`: every rank holds ``max_batch / n_data``
slots (``max_batch % n_data`` raises, as in the JAX package) on its device
with the first rank's weights, and a request's prefill, slot and chunks
stay on the rank that admitted it.  Greedy rows equal the single-device
stepper's; a sampled row draws from its own rank's chunk seeds.
"""

import itertools
import logging
import re
import threading
import time

import numpy as np
import torch

from ..devices import default_device
from ..models.transformers.generation_utils import gumbel_argmax
from ..weights import tree_to
from ..parallel import data_size, shard_params
from .serving import ContinuousServingEngine, mesh_stepper, warm_thread

logger = logging.getLogger(__name__)


def _compile_stop_condition(stop_condition):
    """str = regex searched in the decoded text; callable passes through."""
    if stop_condition is None:
        return None
    if callable(stop_condition):
        return stop_condition
    pattern = re.compile(stop_condition)
    return lambda text: pattern.search(text) is not None


def make_transformer_stepper(model, params, tokenizer = None, *,
                             max_batch = 8,
                             max_length = 512,
                             chunk = 8,
                             prompt_multiple = 32,
                             eos_token = None,
                             pad_token = 0,
                             temperature = 1.0,
                             top_k = None,
                             top_p = None,
                             max_new_tokens = None,
                             cache_dtype = None,
                             mesh = None,
                             seed = 0,
                             device = None):
    """(start_fn, step_fn, finish_fn) serving a decoder-only `Transformer`
    through `ContinuousServingEngine`, on `device` (cuda unless given).

    Per-request kwargs (all optional): ``max_new_tokens``, ``eos_token``,
    ``temperature``, ``method`` ('greedy'|'sample'), ``stop_condition``
    (regex str or ``text -> bool``, checked on the decoded text at every
    chunk boundary), ``allowed_tokens`` (token ids the row may emit; its
    eos stays allowed), ``on_token(fragment, token_ids)`` streaming
    callback, ``rng`` (accepted; the draws are the stepper's).  Inputs may
    be raw text (requires `tokenizer`) or a token-id sequence.
    `top_k`/`top_p` are stepper-level; temperature and greedy/sample are
    per row."""
    if mesh is not None:
        n_data = data_size(mesh)
        if max_batch % n_data:
            raise ValueError('max_batch (%d) must divide over the %d-device data axis'
                             % (max_batch, n_data))
        local = make_transformer_stepper(
            model, shard_params(None if params is None else tree_to(params, mesh.device), mesh),
            tokenizer,
            max_batch = max_batch // n_data, max_length = max_length, chunk = chunk,
            prompt_multiple = prompt_multiple, eos_token = eos_token, pad_token = pad_token,
            temperature = temperature, top_k = top_k, top_p = top_p,
            max_new_tokens = max_new_tokens, cache_dtype = cache_dtype, seed = seed,
            device = mesh.device)
        return mesh_stepper(mesh, local, capacity = max_batch // n_data)
    if chunk < 1:
        raise ValueError('chunk must be >= 1')
    device = default_device(device)
    params = tree_to(params, device)
    vocab = model.hp.vocab_size
    default_eos = eos_token if eos_token is not None else -1
    default_budget = max_new_tokens or max_length
    dtype = cache_dtype or torch.float32

    # ---- device programs ---------------------------------------------------

    def _prefill(prompts, lengths):
        """Prefill of right-padded prompts: their caches (index → the
        lengths) and each row's next-token logits, from position P_r - 1."""
        caches = model.init_caches(prompts.shape[0], prompts.shape[1], dtype = dtype,
                                   device = device)
        logits, caches = model.decode(params, prompts, caches = caches)
        rows = torch.arange(prompts.shape[0], device = device)
        return caches, logits[rows, lengths - 1].to(torch.float32)

    def _sample(logits, temp, greedy, gen):
        scaled = logits / torch.clamp(temp, min = 1e-6)[:, None]
        if top_k is not None:
            kth = torch.topk(scaled, top_k, dim = -1).values[..., -1:]
            scaled = torch.where(scaled < kth, float('-inf'), scaled)
        if top_p is not None:
            srt = torch.sort(scaled, dim = -1, descending = True).values
            cum = torch.cumsum(torch.softmax(srt, dim = -1), dim = -1)
            cut_i = torch.clamp((cum < top_p).sum(dim = -1, keepdim = True), max = vocab - 1)
            scaled = torch.where(scaled < torch.gather(srt, -1, cut_i), float('-inf'), scaled)
        tok = torch.argmax(scaled, dim = -1)
        if gen is None:
            return tok
        return torch.where(greedy, tok, gumbel_argmax(scaled, gen))

    def _chunk(active, finished, remaining, eos, temp, greedy, logits_mask, gen):
        """`chunk` decode steps of every slot → (finished, count, tokens
        (B, chunk)); the caches, index and logits advance in `dev`."""
        caches, logits, index = dev['caches'], dev['logits'], dev['index']
        for c in caches:
            c['index'] = index
        count = torch.zeros((max_batch,), dtype = torch.long, device = device)
        toks = []
        for _ in range(chunk):
            masked = logits if logits_mask is None \
                else torch.where(logits_mask, logits, float('-inf'))
            tok = _sample(masked, temp, greedy, gen)
            stepped = active & ~finished
            tok = torch.where(stepped, tok, pad_token)
            now_finished = torch.where(stepped, (tok == eos) | (remaining <= 1), finished)
            remaining = torch.where(stepped, remaining - 1, remaining)
            count = count + stepped.to(torch.long)
            new_logits, _ = model.decode(params, tok[:, None], caches = caches)
            # frozen rows park their index: their pad write lands at the
            # old index, re-overwritten when the slot is admitted again
            index = torch.where(stepped, index + 1, index)
            for c in caches:
                c['index'] = index
            logits = torch.where(stepped[:, None], new_logits[:, -1].to(torch.float32), logits)
            finished = now_finished
            toks.append(tok)
        dev['logits'], dev['index'] = logits, index
        return finished, count, torch.stack(toks, dim = 1)

    # ---- device-resident slot state ---------------------------------------

    dev = {'caches': None, 'logits': None, 'index': None}
    slot_of = {}                       # seq id -> row
    free_slots = list(range(max_batch))
    counter = itertools.count()
    step_counter = itertools.count()
    lock = threading.Lock()            # slot maps: engine loop + warmup

    def _ensure_dev():
        if dev['caches'] is None:
            dev['index'] = torch.zeros((max_batch,), dtype = torch.long, device = device)
            dev['caches'] = model.init_caches(max_batch, max_length, dtype = dtype,
                                              device = device)
            for c in dev['caches']:
                c['index'] = dev['index']
            dev['logits'] = torch.zeros((max_batch, vocab), device = device)

    # ---- admission ---------------------------------------------------------

    def _encode(inputs):
        if isinstance(inputs, str):
            if tokenizer is None:
                raise ValueError('text inputs need a tokenizer')
            ids = np.asarray(tokenizer.encode(inputs), np.int64)
        else:
            ids = np.asarray(inputs, np.int64).reshape(-1)
        if ids.shape[0] > max_length - 1:
            raise ValueError('prompt length %d exceeds max_length - 1 = %d'
                             % (ids.shape[0], max_length - 1))
        if ids.shape[0] == 0:
            raise ValueError('empty prompt')
        return ids

    def _make_state(ids, kwargs):
        budget = int(kwargs.get('max_new_tokens') or default_budget)
        budget = max(1, min(budget, max_length - int(ids.shape[0])))
        eos = kwargs.get('eos_token', default_eos)
        allowed = kwargs.get('allowed_tokens')
        if allowed is not None:
            mask = np.zeros((vocab,), bool)
            mask[np.asarray(list(allowed), np.int64)] = True
            if eos is not None and eos >= 0:
                mask[eos] = True       # the row must stay able to stop
            allowed = mask
        return {
            '_seq': next(counter),
            'prompt': ids,
            'tokens': [],              # generated ids (host)
            'text': '',                # decoded-so-far (host)
            'budget': budget,
            'eos': int(eos) if eos is not None else -1,
            'temperature': float(kwargs.get('temperature', temperature)),
            'greedy': kwargs.get('method', 'greedy') != 'sample',
            'stop': _compile_stop_condition(kwargs.get('stop_condition')),
            'allowed': allowed,
            'on_token': kwargs.get('on_token'),
            'fresh': None,             # (burst caches, burst logits, lengths, row)
            'done': False,
            't_start': time.perf_counter(),
            't_first': None,
        }

    def _prefill_batch(ids_list):
        s = max(len(t) for t in ids_list)
        s = min(-(-s // prompt_multiple) * prompt_multiple, max_length)
        prompts = np.stack([np.pad(t, (0, s - len(t)), constant_values = pad_token)
                            for t in ids_list])
        lengths = torch.as_tensor([len(t) for t in ids_list], device = device)
        with torch.no_grad():
            caches, logits = _prefill(torch.as_tensor(prompts, device = device), lengths)
        return caches, logits, lengths

    def start_fn(inputs, ** kwargs):
        ids = _encode(inputs)
        fresh = _prefill_batch([ids])
        st = _make_state(ids, kwargs)
        st['fresh'] = fresh + (0,)
        return st

    def start_many(inputs_list, kwargs_list):
        """One prefill for a whole admission burst."""
        ids_list = [_encode(x) for x in inputs_list]
        fresh = _prefill_batch(ids_list)
        states = []
        for i, ids in enumerate(ids_list):
            st = _make_state(ids, kwargs_list[i])
            st['fresh'] = fresh + (i,)
            states.append(st)
        return states

    start_fn.start_many = start_many
    start_fn.batchable_kwargs = (
        'max_new_tokens', 'eos_token', 'temperature', 'method',
        'stop_condition', 'allowed_tokens', 'on_token', 'rng')

    # ---- stepping ----------------------------------------------------------

    def _admit_fresh(states):
        """Assign slots, and one scatter per admission burst for every
        not-yet-inserted state."""
        pending = [st for st in states if st['fresh'] is not None]
        if not pending:
            return
        by_src = {}                    # one burst = one shared prefill
        for st in pending:
            if not free_slots:         # engine guarantees <= max_batch rows
                raise RuntimeError('no free slot (engine max_batch_size '
                                   'must be <= stepper max_batch)')
            row = free_slots.pop()
            slot_of[st['_seq']] = row
            caches, logits, lengths, i = st['fresh']
            by_src.setdefault(id(caches), (caches, logits, lengths, []))[3].append((row, i, st))
        for caches, logits, lengths, entries in by_src.values():
            target = torch.as_tensor([r for r, _, _ in entries], device = device)
            src = torch.as_tensor([i for _, i, _ in entries], device = device)
            s = caches[0]['k'].shape[2]
            for c, f in zip(dev['caches'], caches):
                c['k'][target, :, :s] = f['k'][src]
                c['v'][target, :, :s] = f['v'][src]
            dev['index'][target] = lengths[src]
            dev['logits'][target] = logits[src]
            for _, _, st in entries:
                st['fresh'] = None

    def _detok(st, new_ids):
        """Incremental detokenization: decode-all + emit the new suffix
        (robust to BPE merges that rewrite the tail)."""
        st['tokens'].extend(int(t) for t in new_ids)
        fragment = ''
        if tokenizer is not None:
            full = tokenizer.decode(st['tokens'])
            if isinstance(full, (list, tuple)):
                full = ''.join(full)
            fragment = full[len(st['text']):] if full.startswith(st['text']) else full
            st['text'] = full
        if st['t_first'] is None and len(new_ids):
            st['t_first'] = time.perf_counter()
        if st['on_token'] is not None and len(new_ids):
            try:
                st['on_token'](fragment, [int(t) for t in new_ids])
            except Exception:
                logger.exception('on_token callback failed')

    def step_fn(states):
        with lock, torch.no_grad():
            _ensure_dev()
            # release slots owned by requests no longer in the active set
            # (resolved or aborted rows the engine dropped); step_fn is the
            # only freer, so a row can never be freed twice
            seqs = {st['_seq'] for st in states}
            for seq in [s for s in slot_of if s not in seqs]:
                free_slots.append(slot_of.pop(seq))
            _admit_fresh(states)

            row_of = {st['_seq']: slot_of[st['_seq']] for st in states}
            active = np.zeros((max_batch,), bool)
            finished = np.ones((max_batch,), bool)
            remaining = np.zeros((max_batch,), np.int64)
            eos = np.full((max_batch,), -1, np.int64)
            temp = np.ones((max_batch,), np.float32)
            greedy = np.ones((max_batch,), bool)
            need_mask = any(st['allowed'] is not None for st in states)
            mask = np.ones((max_batch, vocab), bool) if need_mask else None
            for st in states:
                r = row_of[st['_seq']]
                active[r] = not st['done']
                finished[r] = st['done']
                remaining[r] = max(0, st['budget'] - len(st['tokens']))
                eos[r] = st['eos']
                temp[r] = st['temperature']
                greedy[r] = st['greedy']
                if need_mask and st['allowed'] is not None:
                    mask[r] = st['allowed']

            chunk_seed = (seed + next(step_counter)) % (2 ** 31)
            gen = None
            if not greedy[active].all():
                gen = torch.Generator(device = device).manual_seed(chunk_seed)
            on = lambda a: torch.as_tensor(a, device = device)
            fin, counts, toks = _chunk(on(active), on(finished), on(remaining), on(eos),
                                       on(temp), on(greedy),
                                       on(mask) if need_mask else None, gen)
            # one transfer: [finished, count, tokens...] a row
            host = torch.cat([fin[:, None].to(torch.long), counts[:, None], toks],
                             dim = 1).cpu().numpy()
            fin, counts, toks = host[:, 0].astype(bool), host[:, 1], host[:, 2:]

            done = []
            for st in states:
                r = row_of[st['_seq']]
                n = int(counts[r])
                if n and not st['done']:
                    new_ids = toks[r, :n]
                    # the eos itself is not part of the emitted stream
                    if fin[r] and st['eos'] >= 0 and new_ids[-1] == st['eos']:
                        new_ids = new_ids[:-1]
                    _detok(st, new_ids)
                    if fin[r]:
                        st['done'] = True
                    elif st['stop'] is not None and tokenizer is not None \
                            and st['stop'](st['text']):
                        st['done'] = True
                done.append(bool(st['done']))
            return states, done

    # ---- finish ------------------------------------------------------------

    def finish_fn(st):
        # slot release happens in step_fn's sweep (single-freer invariant)
        out = {'tokens': list(st['tokens']),
               'n_tokens': len(st['tokens']),
               'prompt_tokens': st['prompt'].tolist()}
        if tokenizer is not None:
            out['text'] = st['text']
        if st['t_first'] is not None:
            out['first_token_s'] = st['t_first'] - st['t_start']
        return out

    finish_fn.async_ok = True          # pure host work
    step_fn.warm_thread = lambda: warm_thread(device)
    step_fn._dev = dev                 # introspection
    step_fn._slots = slot_of
    return start_fn, step_fn, finish_fn


def make_llm_engine(model, params, tokenizer = None, *, max_batch = 8,
                    engine_name = 'llm-serving', ** stepper_kwargs):
    """`ContinuousServingEngine` wired with `make_transformer_stepper`.
    With ``mesh=``, every rank builds it; the first rank runs the engine,
    the others ``engine.step_fn.follow()`` until it stops."""
    start_fn, step_fn, finish_fn = make_transformer_stepper(
        model, params, tokenizer, max_batch = max_batch, ** stepper_kwargs)
    return ContinuousServingEngine(start_fn, step_fn, finish_fn,
                                   max_batch_size = max_batch, name = engine_name)
