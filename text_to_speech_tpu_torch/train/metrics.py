"""Metric registry: classification, speaker verification, text and TTS
quality metrics, numpy in and a float out.

Counterpart of ``text_to_speech_tpu/train/metrics.py``: `register_metric`,
`get_metric` (a name, a dict config with ``name`` or ``class_name``, or a
callable; keywords bound with `functools.partial`) and `list_metrics`;
`accuracy`, `binary_accuracy`, `equal_error_rate` (``eer``, the GE2E
encoder's evaluation), `exact_match`, `text_f1` (``f1``),
`word_error_rate` (``wer``), `character_error_rate` (``cer``),
`mel_cepstral_distortion` (``mcd``, frames cut to the common length or
aligned by DTW), `mel_snr`, and the reduction-factor policy
`choose_reduction_factor`.
"""

import re

import numpy as np

_METRICS = {}


def register_metric(name):
    def deco(fn):
        _METRICS[name.lower()] = fn
        return fn
    return deco


def get_metric(metric, ** kwargs):
    if callable(metric) and not isinstance(metric, str):
        return metric
    if isinstance(metric, dict):
        kwargs = {** metric, ** kwargs}
        metric = kwargs.pop('name', None) or kwargs.pop('class_name')
    key = metric.lower()
    if key not in _METRICS:
        raise ValueError('Unknown metric {!r} (known: {})'.format(
            metric, sorted(_METRICS)))
    fn = _METRICS[key]
    if kwargs:
        import functools
        return functools.partial(fn, ** kwargs)
    return fn


def list_metrics():
    return sorted(_METRICS)


@register_metric('accuracy')
def accuracy(y_true, y_pred, ** kwargs):
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_pred.ndim > y_true.ndim:
        y_pred = np.argmax(y_pred, axis = -1)
    return float(np.mean(y_true == y_pred))


@register_metric('binary_accuracy')
def binary_accuracy(y_true, y_pred, threshold = 0.5, ** kwargs):
    return float(np.mean(np.asarray(y_true) == (np.asarray(y_pred) > threshold)))


@register_metric('eer')
def equal_error_rate(labels, scores, ** kwargs):
    """EER for verification: labels 1=same-speaker, scores=similarity."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores)
    labels = labels[order]
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    frr = 1. - tp / max(n_pos, 1)         # false reject at each threshold
    far = fp / max(n_neg, 1)              # false accept
    idx = np.argmin(np.abs(far - frr))
    return float((far[idx] + frr[idx]) / 2.)


# -- text metrics --------------------------------------------------------------

def _normalize_text(text):
    text = re.sub(r'[^\w\s]', '', text.lower())
    return re.sub(r'\s+', ' ', text).strip()


@register_metric('exact_match')
def exact_match(y_true, y_pred, normalize = True, ** kwargs):
    if isinstance(y_true, str): y_true, y_pred = [y_true], [y_pred]
    hits = 0
    for t, p in zip(y_true, y_pred):
        if normalize: t, p = _normalize_text(t), _normalize_text(p)
        hits += int(t == p)
    return hits / max(len(y_true), 1)


@register_metric('f1')
def text_f1(y_true, y_pred, normalize = True, ** kwargs):
    """Token-overlap F1 (SQuAD-style)."""
    if isinstance(y_true, str): y_true, y_pred = [y_true], [y_pred]
    scores = []
    for t, p in zip(y_true, y_pred):
        if normalize: t, p = _normalize_text(t), _normalize_text(p)
        t_toks, p_toks = t.split(), p.split()
        if not t_toks or not p_toks:
            scores.append(float(t_toks == p_toks))
            continue
        common = {}
        for tok in t_toks: common[tok] = common.get(tok, 0) + 1
        overlap = 0
        for tok in p_toks:
            if common.get(tok, 0) > 0:
                overlap += 1
                common[tok] -= 1
        if overlap == 0:
            scores.append(0.)
            continue
        precision = overlap / len(p_toks)
        recall = overlap / len(t_toks)
        scores.append(2 * precision * recall / (precision + recall))
    return float(np.mean(scores))


@register_metric('wer')
def word_error_rate(y_true, y_pred, ** kwargs):
    """Levenshtein word error rate."""
    if isinstance(y_true, str): y_true, y_pred = [y_true], [y_pred]
    total_err, total_words = 0, 0
    for t, p in zip(y_true, y_pred):
        ref, hyp = t.split(), p.split()
        d = np.zeros((len(ref) + 1, len(hyp) + 1), np.int32)
        d[:, 0] = np.arange(len(ref) + 1)
        d[0, :] = np.arange(len(hyp) + 1)
        for i in range(1, len(ref) + 1):
            for j in range(1, len(hyp) + 1):
                sub = d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
                d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
        total_err += int(d[-1, -1])
        total_words += len(ref)
    return total_err / max(total_words, 1)


@register_metric('cer')
def character_error_rate(y_true, y_pred, ** kwargs):
    if isinstance(y_true, str): y_true, y_pred = [y_true], [y_pred]
    return word_error_rate([' '.join(t) for t in y_true],
                           [' '.join(p) for p in y_pred])


# -- objective TTS quality ------------------------------------------------------

def _dct_matrix(n_out, n_in):
    """Orthonormal DCT-II basis (n_out, n_in) — log-mel → cepstra."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2. / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


@register_metric('mcd')
def mel_cepstral_distortion(mel_true, mel_pred, *, n_mfcc = 13,
                            exclude_c0 = True, align = 'cut', ** kwargs):
    """Mel-cepstral distortion in dB between two (log-)mel spectrograms
    (T, n_mels) — the standard objective TTS quality measure:
    ``(10 / ln 10) * sqrt(2 * Σ_d (c_true - c_pred)²)`` averaged over
    frames, on DCT-II cepstra of the log-mel (c0 excluded by default: it
    is overall energy, not timbre).

    align: 'cut' truncates to the common length; 'dtw' aligns frames with
    dynamic time warping first (O(T²), use for AR models whose timing
    drifts).  Lower is better; <5 dB is commonly "good" for copy-synthesis.
    """
    a = np.asarray(mel_true, np.float32)
    b = np.asarray(mel_pred, np.float32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError('expected (T, n_mels) inputs, got {} vs {}'.format(
            a.shape, b.shape))
    dct = _dct_matrix(n_mfcc, a.shape[1])
    ca, cb = a @ dct.T, b @ dct.T
    if exclude_c0:
        ca, cb = ca[:, 1:], cb[:, 1:]

    const = 10. / np.log(10.) * np.sqrt(2.)
    if align == 'dtw':
        # O(T_a * T_b) DTW over per-frame cepstral distances.  Direct
        # differences (blocked over rows to bound memory) rather than the
        # gram-matrix identity: exact zeros on identical frames.
        dist = np.empty((len(ca), len(cb)), np.float32)
        for i0 in range(0, len(ca), 256):
            blk = ca[i0:i0 + 256, :, None] - cb.T[None]
            dist[i0:i0 + 256] = np.sqrt(np.sum(blk * blk, axis = 1))
        Ta, Tb = dist.shape
        acc = np.full((Ta + 1, Tb + 1), np.inf, np.float64)
        acc[0, 0] = 0.
        # track the optimal path LENGTH alongside the cost: the standard
        # MCD normalizer is the number of aligned pairs, which exceeds
        # max(Ta, Tb) exactly when the alignment is non-diagonal — the
        # case DTW mode exists for (dividing by max(Ta, Tb) overstates
        # MCD by up to ~2x under heavy warping)
        cnt = np.zeros((Ta + 1, Tb + 1), np.int64)
        for i in range(1, Ta + 1):
            j0, row = acc[i - 1], acc[i]
            c0, crow = cnt[i - 1], cnt[i]
            for j in range(1, Tb + 1):
                prev = (j0[j - 1], j0[j], row[j - 1])
                k = prev.index(min(prev))
                row[j] = dist[i - 1, j - 1] + prev[k]
                crow[j] = (c0[j - 1], c0[j], crow[j - 1])[k] + 1
        return const * float(acc[Ta, Tb]) / max(int(cnt[Ta, Tb]), 1)

    n = min(len(ca), len(cb))
    frame = np.sqrt(np.sum((ca[:n] - cb[:n]) ** 2, axis = -1))
    return const * float(np.mean(frame)) if n else 0.


@register_metric('mel_snr')
def mel_snr(mel_true, mel_pred, ** kwargs):
    """Signal-to-noise ratio (dB) of a predicted mel vs the reference,
    frame-truncated to the common length."""
    a = np.asarray(mel_true, np.float32)
    b = np.asarray(mel_pred, np.float32)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    noise = float(np.mean((a - b) ** 2))
    return 10. * float(np.log10(float(np.mean(a ** 2)) / max(noise, 1e-20)))


def choose_reduction_factor(metrics_by_r, *, max_mcd_penalty_db = 0.5,
                            metric = 'mcd_db'):
    """Quality-gated reduction-factor policy (``n_frames_per_step``).

    ``metrics_by_r``: {r: {'mcd_db': ..., ...}} — objective copy-synthesis
    metrics per candidate r (one model trained per r, its DTW-aligned MCD
    against the ground-truth mel).

    Policy: r=1 is the DEFAULT (exact frame-rate decoding).  A larger r
    (r frames per sequential decode step ⇒ decode latency ÷ r) is an
    opt-in trade accepted only when its measured MCD penalty vs r=1 stays
    under ``max_mcd_penalty_db`` — returns the largest such r.
    """
    if 1 not in metrics_by_r:
        raise ValueError('metrics for the r=1 baseline are required')
    base = float(metrics_by_r[1][metric])
    best = 1
    for r in sorted(metrics_by_r):
        if r == 1 or r <= best:
            continue
        penalty = float(metrics_by_r[r][metric]) - base
        if penalty < max_mcd_penalty_db:
            best = r
    return best
