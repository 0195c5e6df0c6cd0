"""Mel-spectrogram front end on `torch.fft`.

Counterpart of ``text_to_speech_tpu/ops/stft.py`` (its forward path):
`mel_filterbank` (Slaney mel scale and norm, librosa's defaults), `STFT`
(reflect-padded frames, a periodic Hann window centred in the frame, rFFT,
magnitude and phase: ``torch.stft(center=True, pad_mode='reflect')``'s
magnitudes), `MelSTFT` with its config round trip (``mel_fn.json``) and
registry, `TacotronSTFT` (log of the mel magnitudes clamped at 1e-5) and
`WhisperSTFT` (log10 mel, dynamic range 8, scaled to about [-1, 1]).
A call computes on the device of the audio tensor it is given (the CPU for
numpy input).

The inverse half follows the JAX formula, not `torch.istft`:
`STFT._raw_inverse` maps (magnitude, phase) to frames through the
pseudo-inverse of the windowed Fourier basis (made once, at first use) and
overlap-adds them, as ``flen / hop`` shifted adds when the hop divides the
frame and frame by frame otherwise, then crops the centre padding;
`inverse_transform` divides by the envelope of the inverse of
``transform(ones)``, floored at 1e-4, which holds the overlap factor and
the taper at the edges.  `griffin_lim`,
`mel_to_linear` and `TacotronSTFT.inverse` build the weights-free
vocoder on it; the initial phase comes from a `torch.Generator` (or is
given), not from ``jax.random``.  The mel scale is Slaney's by default,
HTK's with ``htk=True``.
"""

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(frequencies, htk = False):
    """The Slaney mel scale (linear below 1 kHz, logarithmic above), or the
    HTK one."""
    frequencies = np.asanyarray(frequencies, dtype = np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if mels.ndim:
        log_t = frequencies >= min_log_hz
        mels[log_t] = min_log_mel + np.log(frequencies[log_t] / min_log_hz) / logstep
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk = False):
    mels = np.asanyarray(mels, dtype = np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(sr, n_fft, n_mels = 80, fmin = 0.0, fmax = None, htk = False,
                   norm = 'slaney'):
    """Triangular mel filterbank, ``(n_mels, 1 + n_fft // 2)``, Slaney-normalized
    unless `norm` is None."""
    if fmax is None: fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 'slaney':
        weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_length, periodic = True):
    n = np.arange(win_length, dtype = np.float64)
    denom = win_length if periodic else win_length - 1
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)


class STFT:
    """Short-time Fourier transform: reflect-padded windowed frames + rFFT,
    and its inverse."""

    def __init__(self, filter_length = 800, hop_length = 200, win_length = 800,
                 window = 'hann', periodic = True):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.cutoff = filter_length // 2 + 1
        if window is not None:
            assert filter_length >= win_length
            if window == 'hann':
                win = hann_window(win_length, periodic)
            else:
                from scipy.signal import get_window
                win = get_window(window, win_length, fftbins = periodic)
            pad = filter_length - win_length
            win = np.pad(win, (pad // 2, pad - pad // 2))
        else:
            win = np.ones((filter_length,), dtype = np.float64)
        self._window = win
        self.fft_window = win.astype(np.float32)
        self._inverse_basis = None

    @property
    def inverse_basis(self):
        """(filter_length, 2 cutoff) float32: the pseudo-inverse of the
        scaled [real; imaginary] Fourier basis, windowed, as the JAX
        package makes it (float64 numpy, once)."""
        if self._inverse_basis is None:
            fourier = np.fft.fft(np.eye(self.filter_length))
            scale = self.filter_length / self.hop_length
            inv = np.linalg.pinv(scale * np.vstack([np.real(fourier[:self.cutoff]),
                                                    np.imag(fourier[:self.cutoff])]))
            inv = inv * self._window[:, None]
            self._inverse_basis = np.ascontiguousarray(inv.astype(np.float32))
        return self._inverse_basis

    def frame(self, audio):
        """(B, T) float32 → windowed frames (B, n_frames, filter_length)."""
        pad = self.filter_length // 2
        padded = F.pad(audio[:, None], (pad, pad), mode = 'reflect')[:, 0]
        frames = padded.unfold(-1, self.filter_length, self.hop_length)
        return frames * torch.from_numpy(self.fft_window).to(audio.device)

    def transform(self, audio):
        """`audio` (B, T) → (magnitude, phase), each (B, frames, cutoff)."""
        spec = torch.fft.rfft(self.frame(audio), dim = -1)
        real, imag = spec.real, spec.imag
        return torch.sqrt(real ** 2 + imag ** 2), torch.atan2(imag, real)

    def _raw_inverse(self, magnitude, phase):
        """(magnitude, phase) (B, frames, cutoff) → (B, (frames - 1) * hop):
        frames through the inverse basis, overlap-added, the centre padding
        cropped."""
        spec = torch.cat([magnitude * torch.cos(phase), magnitude * torch.sin(phase)], dim = -1)
        basis = torch.from_numpy(self.inverse_basis).to(spec.device)
        frames = spec @ basis.T                                  # (B, frames, flen)
        batch, n_frames, flen = frames.shape
        hop = self.hop_length
        out_len = (n_frames - 1) * hop + flen
        if flen % hop == 0:
            # k = flen / hop shifted adds: piece j of frame f lands in slot f + j
            k = flen // hop
            pieces = frames.reshape(batch, n_frames, k, hop)
            slots = frames.new_zeros((batch, n_frames + k - 1, hop))
            for j in range(k):
                slots[:, j: j + n_frames] += pieces[:, :, j]
            audio = slots.reshape(batch, out_len)
        else:
            audio = frames.new_zeros((batch, out_len))
            for i in range(n_frames):
                audio[:, i * hop: i * hop + flen] += frames[:, i]
        pad = self.filter_length // 2
        return audio[:, pad: -pad]

    def inverse_transform(self, magnitude, phase):
        """Overlap-add reconstruction from magnitude and phase, divided by
        the window envelope (the inverse of the transform of ones) floored
        at 1e-4."""
        audio = self._raw_inverse(magnitude, phase)
        env = self._raw_inverse(* self.transform(torch.ones((1, audio.shape[1]),
                                                            device = audio.device)))
        return audio / torch.clamp(torch.abs(env), min = 1e-4)


def griffin_lim(magnitudes, stft, *, n_iters = 32, generator = None, phase = None):
    """Phase reconstruction from STFT `magnitudes` (B, frames, cutoff) →
    waveform (B, T): from `phase` when given, else a uniform draw in
    [-pi, pi) from `generator`, then `n_iters` rounds of inverse and forward
    transform."""
    if phase is None:
        phase = (torch.rand(magnitudes.shape, generator = generator,
                            device = magnitudes.device) * 2. - 1.) * math.pi
    audio = stft.inverse_transform(magnitudes, phase)
    for _ in range(n_iters):
        _, phase = stft.transform(audio)
        audio = stft.inverse_transform(magnitudes, phase)
    return audio


def mel_to_linear(mel, mel_basis, *, log_compressed = True, clip_val = 1e-5):
    """Linear magnitudes from a (log-)mel (B, T, n_mels) through the
    pseudo-inverse of `mel_basis` (cutoff, n_mels), clipped at 0."""
    if log_compressed:
        mel = torch.exp(mel)
    pinv = np.linalg.pinv(np.asarray(mel_basis, np.float64)).astype(np.float32)
    return torch.clamp(mel @ torch.from_numpy(pinv).to(mel.device), min = 0.)


class MelSTFT:
    """Base mel-spectrogram extractor with config persistence and a
    registry (`MelSTFT.create`)."""

    def __init__(self, sampling_rate, n_mel_channels = 80, *, win_length = 1024,
                 hop_length = 256, filter_length = 1024, mel_fmin = 0.0, mel_fmax = 8000.0,
                 normalize_mode = None, pre_emph = 0.0, ** kwargs):
        assert normalize_mode in (None, 'per_feature', 'all_feature')
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        as_samples = lambda v: v if v > 1 else int(v * sampling_rate)
        self.win_length = as_samples(win_length)
        self.hop_length = as_samples(hop_length)
        self.filter_length = as_samples(filter_length)
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax
        self.pre_emph = pre_emph
        self.normalize_mode = normalize_mode
        # (cutoff, n_mels): magnitudes @ mel_basis
        self.mel_basis = mel_filterbank(
            sr = self.sampling_rate, n_fft = self.filter_length, n_mels = n_mel_channels,
            fmin = mel_fmin, fmax = mel_fmax).T.copy()

    @property
    def rate(self):
        return self.sampling_rate

    def __call__(self, audio):
        """audio (T,) or (B, T), numpy or tensor → mel (B, frames, n_mels),
        float32, on the tensor's device (the CPU for numpy input)."""
        audio = torch.as_tensor(audio, dtype = torch.float32)
        if audio.ndim == 1: audio = audio[None]
        if audio.shape[1] < self.win_length:
            audio = F.pad(audio, (0, self.win_length - audio.shape[1]))
        if self.pre_emph > 0.:
            audio = torch.cat([audio[:, :1], audio[:, 1:] - self.pre_emph * audio[:, :-1]],
                              dim = 1)
        return self.mel_spectrogram(audio)

    def mel_spectrogram(self, audio):
        raise NotImplementedError()

    def normalize(self, mel):
        if self.normalize_mode is None: return mel
        dims = (1,) if self.normalize_mode == 'per_feature' else (1, 2)
        mean = mel.mean(dim = dims, keepdim = True)
        std = mel.std(dim = dims, keepdim = True, unbiased = False)
        return torch.where(std > 0, (mel - mean) / torch.clamp(std, min = 1e-12),
                           torch.zeros_like(mel))

    def get_mel_length(self, audio_length):
        return int(math.ceil(max(self.filter_length, audio_length) / self.hop_length))

    def get_audio_length(self, mel_length):
        return mel_length * self.hop_length

    def get_config(self):
        return {'class_name': self.__class__.__name__,
                'n_mel_channels': self.n_mel_channels, 'sampling_rate': self.sampling_rate,
                'win_length': self.win_length, 'hop_length': self.hop_length,
                'filter_length': self.filter_length, 'mel_fmin': self.mel_fmin,
                'mel_fmax': self.mel_fmax, 'pre_emph': self.pre_emph,
                'normalize_mode': self.normalize_mode}

    def save(self, filename):
        if not filename.endswith('.json'): filename += '.json'
        directory = os.path.dirname(filename)
        if directory: os.makedirs(directory, exist_ok = True)
        with open(filename, 'w', encoding = 'utf-8') as file:
            json.dump(self.get_config(), file, indent = 4)
        return filename

    @classmethod
    def load_from_file(cls, filename):
        return MelSTFT.create(filename)

    @staticmethod
    def create(class_name, * args, ** kwargs):
        """By instance, class name (+ kwargs), config dict or ``.json`` file."""
        if isinstance(class_name, MelSTFT): return class_name
        if isinstance(class_name, dict):
            kwargs = {** class_name, ** kwargs}
            class_name = kwargs.pop('class_name')
        if class_name in _mel_classes:
            return _mel_classes[class_name](* args, ** kwargs)
        if os.path.isfile(str(class_name)):
            with open(class_name, encoding = 'utf-8') as file:
                return MelSTFT.create(json.load(file))
        raise ValueError('Unknown MelSTFT class {!r} (known: {})'.format(
            class_name, tuple(_mel_classes)))


class TacotronSTFT(MelSTFT):
    """Log-mel with clamp: the Tacotron-2 / WaveGlow features (22050 Hz,
    80 mels, 1024/256/1024)."""

    def __init__(self, sampling_rate = 22050, n_mel_channels = 80, *, window = 'hann',
                 periodic = True, ** kwargs):
        super().__init__(sampling_rate = sampling_rate, n_mel_channels = n_mel_channels,
                         ** kwargs)
        self.window = window
        self.periodic = periodic
        self.stft_fn = STFT(filter_length = self.filter_length, hop_length = self.hop_length,
                            win_length = self.win_length, window = window,
                            periodic = periodic)

    def spectral_normalize(self, magnitudes, clip_val = 1e-5):
        return torch.log(torch.clamp(magnitudes, min = clip_val))

    def mel_spectrogram(self, audio):
        magnitudes, _ = self.stft_fn.transform(audio)
        mel = magnitudes @ torch.from_numpy(self.mel_basis).to(magnitudes.device)
        return self.normalize(self.spectral_normalize(mel))

    def inverse(self, mel, *, n_iters = 32, generator = None, phase = None):
        """An approximate waveform from a log-mel (filterbank pseudo-inverse,
        then Griffin-Lim): the weights-free vocoder."""
        mel = torch.as_tensor(mel, dtype = torch.float32)
        if mel.ndim == 2: mel = mel[None]
        linear = mel_to_linear(mel, self.mel_basis)
        return griffin_lim(linear, self.stft_fn, n_iters = n_iters, generator = generator,
                           phase = phase)

    def get_config(self):
        return {** super().get_config(), 'window': self.window, 'periodic': self.periodic}


class WhisperSTFT(TacotronSTFT):
    """Whisper's log10-mel (16 kHz, 400/160/400), dynamic-range compressed
    to about [-1, 1]."""

    def __init__(self, sampling_rate = 16000, n_mel_channels = 80, *, win_length = 400,
                 hop_length = 160, filter_length = 400, mel_fmin = 0.0, mel_fmax = 8000.0,
                 ** kwargs):
        super().__init__(sampling_rate = sampling_rate, n_mel_channels = n_mel_channels,
                         win_length = win_length, hop_length = hop_length,
                         filter_length = filter_length, mel_fmin = mel_fmin,
                         mel_fmax = mel_fmax, ** kwargs)

    def mel_spectrogram(self, audio):
        magnitudes, _ = self.stft_fn.transform(audio)
        magnitudes = torch.abs(magnitudes[:, :-1])
        mel = magnitudes @ torch.from_numpy(self.mel_basis).to(magnitudes.device)
        mel = torch.log10(torch.clamp(mel, min = 1e-10))
        mel = torch.maximum(mel, mel.amax(dim = (1, 2), keepdim = True) - 8.0)
        return (mel + 4.0) / 4.0


_mel_classes = {'MelSTFT': MelSTFT, 'TacotronSTFT': TacotronSTFT, 'WhisperSTFT': WhisperSTFT}
