"""Frame-level F0 (pitch) and energy extraction for variance-conditioned TTS.

A copy of ``text_to_speech_tpu/ops/pitch.py`` (numpy only, so the port
keeps its own copy and imports nothing of the JAX package):
`estimate_pitch` (normalized autocorrelation), `frame_energy` (L2 frame
energy), `log_normalize`, `phoneme_average` and `durations_from_attention`,
which turns a Tacotron-2 attention map into per-token durations for
FastSpeech-2's targets.  Host-side data preparation: the card only ever
sees the resulting per-token or per-frame arrays.
"""

import numpy as np


def frame_signal(audio, win_length, hop_length, *, center = True):
    """(T,) → (n_frames, win_length) strided frames (copy; reflect-padded
    when `center` so frame i is centered on sample i*hop)."""
    audio = np.asarray(audio, np.float32)
    if center:
        pad = win_length // 2
        audio = np.pad(audio, (pad, pad), mode = 'reflect')
    n = 1 + max(0, (len(audio) - win_length)) // hop_length
    idx = (np.arange(win_length)[None, :]
           + hop_length * np.arange(n)[:, None])
    return audio[idx]


def estimate_pitch(audio,
                   rate,
                   *,
                   hop_length = 256,
                   win_length = 1024,
                   fmin = 60.,
                   fmax = 500.,
                   voicing_threshold = 0.3,
                   interpolate = True):
    """Per-frame F0 in Hz via normalized autocorrelation.

    For each (centered, mean-removed) frame the autocorrelation is computed
    with one rFFT (power spectrum → irFFT), normalized by lag-0 energy, and
    the best peak searched over lags [rate/fmax, rate/fmin] with parabolic
    interpolation.  Frames whose peak clarity falls below
    `voicing_threshold` (or whose energy is ~0) are unvoiced; with
    `interpolate` their F0 is filled by linear interpolation between voiced
    neighbours (the standard continuous-pitch construction used by
    FastSpeech-2 data pipelines).

    Returns (f0 (n_frames,), voiced (n_frames,) bool).
    """
    frames = frame_signal(audio, win_length, hop_length)
    frames = frames - frames.mean(axis = 1, keepdims = True)

    # autocorrelation via rFFT, zero-padded to avoid circular wrap
    n_fft = 1
    while n_fft < 2 * win_length:
        n_fft *= 2
    spec = np.fft.rfft(frames, n_fft, axis = 1)
    ac = np.fft.irfft(spec * np.conj(spec), n_fft, axis = 1)[:, :win_length]

    energy0 = ac[:, 0]
    lag_min = max(2, int(rate / fmax))
    lag_max = min(win_length - 2, int(np.ceil(rate / fmin)))
    if lag_max <= lag_min:
        raise ValueError('win_length too short for fmin={}'.format(fmin))

    norm = np.where(energy0 > 1e-10, energy0, 1.)[:, None]
    r = ac[:, lag_min: lag_max + 1] / norm                    # (N, L)
    best = np.argmax(r, axis = 1)
    clarity = r[np.arange(len(r)), best]
    lag = best + lag_min

    # parabolic refinement around the peak
    l0 = np.clip(lag, lag_min + 1, lag_max - 1)
    ym1 = ac[np.arange(len(ac)), l0 - 1] / norm[:, 0]
    y0 = ac[np.arange(len(ac)), l0] / norm[:, 0]
    yp1 = ac[np.arange(len(ac)), l0 + 1] / norm[:, 0]
    denom = ym1 - 2. * y0 + yp1
    delta = np.where(np.abs(denom) > 1e-10,
                     0.5 * (ym1 - yp1) / np.where(np.abs(denom) > 1e-10,
                                                  denom, 1.), 0.)
    refined = l0 + np.clip(delta, -1., 1.)

    voiced = (clarity > voicing_threshold) & (energy0 > 1e-8)
    f0 = np.where(voiced, rate / refined, 0.).astype(np.float32)

    if interpolate and voiced.any() and not voiced.all():
        t = np.arange(len(f0))
        f0 = np.interp(t, t[voiced], f0[voiced]).astype(np.float32)
    return f0, voiced


def frame_energy(audio, *, hop_length = 256, win_length = 1024,
                 window = None):
    """Per-frame energy: L2 norm of the windowed frame (equivalently of its
    DFT magnitudes, by Parseval) — the FastSpeech-2 energy feature."""
    frames = frame_signal(audio, win_length, hop_length)
    if window is None:
        window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    return np.sqrt(np.sum((frames * window) ** 2, axis = 1)).astype(np.float32)


def log_normalize(values, *, mean = None, std = None, log_scale = True,
                  eps = 1e-5):
    """Optionally log-compress (voiced-only safe: zeros stay zero) then
    standardize.  Returns (normalized, mean, std) so corpus-level statistics
    can be computed once and reused."""
    values = np.asarray(values, np.float32)
    if log_scale:
        values = np.where(values > 0, np.log(np.maximum(values, eps)), 0.)
    nz = values[values != 0] if (values != 0).any() else values
    if mean is None: mean = float(nz.mean()) if nz.size else 0.
    if std is None: std = float(nz.std()) or 1.
    out = np.where(values != 0, (values - mean) / std, 0.).astype(np.float32)
    return out, mean, std


def phoneme_average(values, durations):
    """Average frame-level values over each token's duration span —
    frame-level (T,) → phoneme-level (L,).  Zero-duration tokens get 0."""
    values = np.asarray(values, np.float32)
    durations = np.asarray(durations, np.int64)
    ends = np.cumsum(durations)
    starts = ends - durations
    out = np.zeros((len(durations),), np.float32)
    csum = np.concatenate([[0.], np.cumsum(values)])
    for i, (s, e) in enumerate(zip(starts, ends)):
        e = min(e, len(values))
        s = min(s, e)
        if e > s:
            out[i] = (csum[e] - csum[s]) / (e - s)
    return out


def durations_from_attention(attention, *, n_tokens = None):
    """Per-token durations from a (T_mel, T_text) alignment map: each frame
    is assigned to its argmax token, counts are accumulated.  The standard
    way to distil duration targets from a trained autoregressive teacher
    (e.g. this repo's Tacotron-2 attention output)."""
    attention = np.asarray(attention)
    if n_tokens is None:
        n_tokens = attention.shape[1]
    assign = np.argmax(attention[:, :n_tokens], axis = 1)
    return np.bincount(assign, minlength = n_tokens).astype(np.int32)
