"""Token-level utilities: logits masking and batch text filtering.

Counterpart of ``text_to_speech_tpu/text/tokens.py``.  The masks take a
tensor (on any device; a new tensor comes back) or a numpy array (a new
array comes back); `process_model_output` and `filter_texts` are host-side
numpy, as in the JAX package (tensors are read to the host first).
"""

import numpy as np
import torch

from ..utils.sequence_utils import pad_batch


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def mask_tokens(logits, indices, value = float('-inf')):
    """Set ``logits[b, t] = value`` for each (b, t) row of `indices` (N, 2)."""
    out = logits.clone() if torch.is_tensor(logits) else np.array(logits)
    indices = np.asarray(_numpy(indices))
    out[indices[:, 0], indices[:, 1]] = value
    return out


def mask_batch_tokens(logits, token_ids, value = float('-inf')):
    """Set ``logits[:, token_ids] = value`` for every batch row."""
    out = logits.clone() if torch.is_tensor(logits) else np.array(logits)
    out[:, np.asarray(_numpy(token_ids))] = value
    return out


def mask_slice_tokens(logits, index, remove_after, value = float('-inf')):
    """Mask ``logits[:, :index]`` (`remove_after=False`) or
    ``logits[:, index:]`` (`remove_after=True`); `index` may be a 0-d tensor
    on the logits' device (no read to the host)."""
    if torch.is_tensor(logits):
        positions = torch.arange(logits.shape[-1], device = logits.device)
        keep = positions < index if remove_after else positions >= index
        return torch.where(keep[None, :], logits,
                           torch.tensor(value, dtype = logits.dtype, device = logits.device))
    logits = np.asarray(logits)
    positions = np.arange(logits.shape[-1])
    keep = positions < index if remove_after else positions >= index
    return np.where(keep[None, :], logits, np.asarray(value, logits.dtype))


def process_model_output(output, offset = None, lengths = None):
    """Strip padding from model outputs: slice each row to
    `[offset:length]` and return numpy (lists of rows for batched input).
    Accepts an output object carrying `.tokens` / `.lengths` / `.offset`."""
    if hasattr(output, 'lengths') or hasattr(output, 'offset'):
        lengths = np.asarray(_numpy(output.lengths))
        if hasattr(output, 'offset'):
            offset = np.asarray(_numpy(output.offset))
            if lengths.ndim == 2 and offset.ndim == 1:
                offset = np.tile(offset[:, None], [1, lengths.shape[1]])
        else:
            offset = np.zeros_like(lengths)
        output = _numpy(output.tokens)
    elif lengths is None:
        return getattr(output, 'tokens', output)
    output = _numpy(output)
    lengths = np.asarray(_numpy(lengths))
    if offset is None:
        offset = np.zeros_like(lengths)

    if lengths.ndim:
        return [process_model_output(out, off, length)
                for out, off, length in zip(output, np.asarray(_numpy(offset)), lengths)]
    return np.asarray(output)[int(offset):int(lengths)]


def filter_texts(encoded_texts,
                 lengths,
                 *,
                 min_text_length = -1,
                 max_text_length = -1,
                 max_sentences = -1,
                 max_sentence_length = -1,
                 max_total_length = -1,
                 sort_by_length = False,
                 max_texts = -1,
                 select_mode = 'start',
                 required_idx = -1,
                 flatten = True,
                 return_indices = False,
                 rng = None,
                 ** _):
    """Filter a ragged batch of encoded texts by per-text / total length
    budgets and count limits.

    `lengths` is (N,) or (N, S) for multi-sentence rows (filtered on total,
    per-sentence max, and sentence count).  `max_total_length` drops texts
    (shortest-first when `sort_by_length`) once the running total exceeds
    the budget; `max_texts` keeps at most that many ('start'/'end'/'random'
    `select_mode`).  `required_idx` pins one text: it is always counted
    first, and if IT gets filtered everything is dropped.  2-D batches are
    flattened to (total_sentences, T) unless `flatten=False`.
    """
    required_idx = int(required_idx)
    encoded_texts = _numpy(encoded_texts)
    lengths = _numpy(lengths)
    if not isinstance(lengths, np.ndarray):
        lengths = pad_batch([np.asarray(_numpy(l), np.int32) for l in lengths], pad_value = 0)
    is_multi = lengths.ndim == 2
    text_lengths = lengths.sum(axis = -1) if is_multi else lengths

    valid = np.ones((len(text_lengths),), dtype = bool)
    if min_text_length > -1:
        valid[text_lengths < min_text_length] = False
    if max_text_length > -1:
        valid[text_lengths > max_text_length] = False
    if is_multi:
        if max_sentences > 0:
            valid[(lengths > 0).sum(axis = -1) > max_sentences] = False
        if max_sentence_length > -1:
            valid[lengths.max(axis = -1) > max_sentence_length] = False

    if max_total_length > 0 and text_lengths[valid].sum() > max_total_length:
        if sort_by_length:
            order = np.argsort(text_lengths)
            order = order[valid[order]]
        else:
            order = np.where(valid)[0]
        if required_idx != -1:
            order = np.concatenate([[required_idx], order[order != required_idx]])
        over = np.cumsum(text_lengths[order]) > max_total_length
        valid[order[over]] = False

    if max_texts > 0:
        budget = max_texts - (1 if required_idx != -1 else 0)
        if valid.sum() > budget:
            order = np.where(valid)[0]
            if required_idx != -1:
                order = order[order != required_idx]
            if select_mode == 'random':
                drop = (rng or np.random.default_rng()).choice(
                    order, size = max(0, len(order) - budget), replace = False)
            elif select_mode == 'start':
                drop = order[budget:]
            elif select_mode == 'end':
                drop = order[:-budget] if budget else order
            else:
                raise ValueError('Unknown select_mode {!r}'.format(select_mode))
            valid[drop] = False

    if required_idx != -1 and not valid[required_idx]:
        valid[:] = False

    lengths = lengths[valid]
    if isinstance(encoded_texts, list):
        encoded_texts = [t for t, ok in zip(encoded_texts, valid) if ok]
    else:
        encoded_texts = encoded_texts[valid]
        if is_multi and flatten:
            encoded_texts = encoded_texts.reshape(-1, encoded_texts.shape[-1])
            lengths = lengths.reshape(-1)
            encoded_texts = encoded_texts[lengths > 0]
            lengths = lengths[lengths > 0]
        if len(encoded_texts) > 0:
            encoded_texts = encoded_texts[..., :lengths.max()]
            if is_multi and not flatten:
                encoded_texts = encoded_texts[:, :(lengths > 0).sum(axis = -1).max(), :]

    if return_indices:
        return encoded_texts, lengths, np.where(valid)[0]
    return encoded_texts, lengths
