"""Distance and similarity metrics on numpy arrays.

Counterpart of ``text_to_speech_tpu/utils/distances.py``: the metric
registry (euclidean, manhattan, dot, cosine, cosine_distance, dice) with the
pairwise ``as_matrix`` mode, `distance` and the `knn` vote; used by
embedding selection, centroids and `SpeakerEncoder.identify`.
"""

import numpy as np

_METRICS = {}


def register_metric(name):
    def deco(fn):
        _METRICS[name] = fn
        return fn
    return deco


def _prepare(x, y, as_matrix):
    x, y = np.asarray(x), np.asarray(y)
    if x.ndim == 1: x = x[None, :]
    if y.ndim == 1: y = y[None, :]
    if as_matrix:
        x = x[:, None, :]
        y = y[None, :, :]
    return x, y


@register_metric('euclidean')
def euclidean_distance(x, y, as_matrix = False, ** kwargs):
    x, y = _prepare(x, y, as_matrix)
    return np.sqrt(np.sum(np.square(x - y), axis = -1))


@register_metric('manhattan')
def manhattan_distance(x, y, as_matrix = False, ** kwargs):
    x, y = _prepare(x, y, as_matrix)
    return np.sum(np.abs(x - y), axis = -1)


@register_metric('dot')
def dot_product(x, y, as_matrix = False, ** kwargs):
    x, y = _prepare(x, y, as_matrix)
    return np.sum(x * y, axis = -1)


@register_metric('cosine')
def cosine_similarity(x, y, as_matrix = False, epsilon = 1e-9, ** kwargs):
    x, y = _prepare(x, y, as_matrix)
    num = np.sum(x * y, axis = -1)
    den = np.sqrt(np.sum(x * x, axis = -1)) * np.sqrt(np.sum(y * y, axis = -1))
    return num / (den + epsilon)


@register_metric('cosine_distance')
def cosine_distance(x, y, ** kwargs):
    return 1. - cosine_similarity(x, y, ** kwargs)


@register_metric('dice')
def dice_coeff(x, y, as_matrix = False, ** kwargs):
    """Dice coefficient 2|x∩y| / (|x|+|y|) for mask-like vectors."""
    x, y = _prepare(x, y, as_matrix)
    inter = np.sum(x * y, axis = -1)
    union = np.sum(x, axis = -1) + np.sum(y, axis = -1)
    return np.where(union > 0, 2. * inter / np.maximum(union, 1e-9), 0.)


def knn(query, embeddings, ids, *, k = 5, method = 'euclidean',
        weighted = False, return_scores = False, ** kwargs):
    """k-nearest-neighbour vote: query (Q, D) or (D,), embeddings (N, D),
    ids (N,) → the predicted id of each query (the majority among its k
    nearest under `method`; `weighted` scores each neighbour by its
    similarity, or by 1 / distance)."""
    query = np.atleast_2d(np.asarray(query))
    embeddings = np.asarray(embeddings)
    ids = np.asarray(ids)
    scores_qn = np.asarray(distance(
        query, embeddings, method = method, as_matrix = True, ** kwargs))
    similarity = method in ('cosine', 'dot', 'dice')   # larger = closer
    order = -scores_qn if similarity else scores_qn
    k = min(int(k), embeddings.shape[0])
    nearest = np.argsort(order, axis = -1)[:, :k]
    out, scores = [], []
    for q in range(query.shape[0]):
        votes = {}
        for j in nearest[q]:
            if not weighted:
                w = 1.
            elif similarity:
                w = max(float(scores_qn[q, j]), 1e-9)
            else:
                w = 1. / (1e-9 + max(float(scores_qn[q, j]), 0.))
            votes[ids[j]] = votes.get(ids[j], 0.) + w
        best = max(votes, key = votes.get)
        out.append(best)
        scores.append(votes[best])
    out = np.asarray(out)
    return (out, np.asarray(scores)) if return_scores else out


def distance(x, y, method = 'euclidean', ** kwargs):
    """A registered metric; ``as_matrix=True`` → pairwise (N, M)."""
    if method not in _METRICS:
        raise ValueError('Unknown distance {!r} (known: {})'.format(
            method, sorted(_METRICS)
        ))
    return _METRICS[method](x, y, ** kwargs)


def list_metrics():
    return sorted(_METRICS)
