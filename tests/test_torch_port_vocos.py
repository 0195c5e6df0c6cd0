"""Vocos and the inverse STFT: the port against the JAX package, on the CPU.

  - `STFT.inverse_transform(* transform(x))` and `STFT._raw_inverse`, when
    the hop divides the frame (the shifted-add overlap-add) and when it
    does not (frame by frame): within 1e-5 of scale;
  - Griffin-Lim's loop from a given initial phase against the JAX
    package's own `transform` / `inverse_transform` run from that phase
    (the JAX function draws its phase from ``jax.random``, the port's from
    a `torch.Generator`: the loop is compared, not the draw);
    `mel_to_linear` and `TacotronSTFT.inverse` the same way;
  - the HTK mel scale and the unnormalized filterbank, and `WhisperSTFT`
    (also made by name through `MelSTFT.create`);
  - the Vocos generator (`spectral_head`, `apply`) within 1e-5 of scale,
    with and without `cond`.  The task model goes through `tts()` behind
    Tacotron-2 in ``test_torch_port_hifigan.py``, beside HiFi-GAN (one JAX
    decode program serves both vocoders there).
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models.vocos_arch import Vocos as JaxVocosArch
from text_to_speech_tpu.ops import stft as jax_stft
from text_to_speech_tpu_torch.init import init_vocos
from text_to_speech_tpu_torch.models.vocos_arch import Vocos as VocosArch
from text_to_speech_tpu_torch.ops import stft
from text_to_speech_tpu_torch.weights import hifigan_from_jax

#: the JAX package's tiny Vocos (``tests/test_vocos.py``)
TINY = dict(n_mel_channels = 9, dim = 16, intermediate_dim = 32, n_layers = 2, kernel_size = 3,
            n_fft = 16, hop_length = 4, win_length = 16)
SCALE = 1e-5


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _scale_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max())


# -- the inverse STFT ------------------------------------------------------------------

@pytest.mark.parametrize('geometry', [(16, 4, 16), (20, 6, 16)], ids = ['hop_divides',
                                                                    'hop_does_not_divide'])
def test_inverse_transform_matches_jax(geometry):
    audio = np.random.default_rng(0).standard_normal((2, 100)).astype(np.float32)
    ours, ref = stft.STFT(* geometry), jax_stft.STFT(* geometry)
    np.testing.assert_array_equal(ours.inverse_basis, ref.inverse_basis)
    magnitude, phase = ours.transform(torch.from_numpy(audio))
    ref_raw, ref_back = jax.jit(lambda a: (ref._raw_inverse(* ref.transform(a)),
                                           ref.inverse_transform(* ref.transform(a))))(
        jnp.asarray(audio))
    raw = ours._raw_inverse(magnitude, phase)
    assert raw.shape == ref_raw.shape
    assert _scale_err(raw, ref_raw) <= SCALE
    back = ours.inverse_transform(magnitude, phase)
    assert back.shape == ref_back.shape
    assert _scale_err(back, ref_back) <= SCALE
    # the envelope restores the signal, edges included
    assert _scale_err(back, audio[:, :back.shape[1]]) <= 1e-5


def _jax_griffin_lim_loop(magnitudes, phase, stft_fn, n_iters):
    """The loop of ``text_to_speech_tpu.ops.stft.griffin_lim`` from a given phase."""
    def loop(magnitudes, phase):
        audio = stft_fn.inverse_transform(magnitudes, phase)
        for _ in range(n_iters):
            _, phase = stft_fn.transform(audio)
            audio = stft_fn.inverse_transform(magnitudes, phase)
        return audio
    return jax.jit(loop)(magnitudes, phase)


def test_griffin_lim_loop_matches_jax():
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((1, 160)).astype(np.float32)
    ours, ref = stft.STFT(16, 4, 16), jax_stft.STFT(16, 4, 16)
    magnitude = ours.transform(torch.from_numpy(audio))[0]
    phase = rng.uniform(-np.pi, np.pi, magnitude.shape).astype(np.float32)
    out = stft.griffin_lim(magnitude, ours, n_iters = 3, phase = torch.from_numpy(phase))
    want = _jax_griffin_lim_loop(jnp.asarray(magnitude.numpy()), jnp.asarray(phase), ref, 3)
    assert _scale_err(out, want) <= 1e-4
    # the draw: uniform in [-pi, pi) from the generator, the same for the same seed
    draw = lambda: stft.griffin_lim(magnitude, ours, n_iters = 1,
                                    generator = torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(draw().numpy(), draw().numpy())


def test_mel_to_linear_and_inverse_match_jax():
    geometry = dict(sampling_rate = 8000, n_mel_channels = 20, filter_length = 64,
                    hop_length = 16, win_length = 64)
    mel_fn, ref_fn = stft.TacotronSTFT(** geometry), jax_stft.TacotronSTFT(** geometry)
    mel = np.random.default_rng(2).uniform(-8., 1., (1, 6, 20)).astype(np.float32)
    linear = stft.mel_to_linear(torch.from_numpy(mel), mel_fn.mel_basis)
    ref = jax_stft.mel_to_linear(jnp.asarray(mel), ref_fn.mel_basis)
    assert _scale_err(linear, ref) <= SCALE
    phase = np.random.default_rng(3).uniform(-np.pi, np.pi, linear.shape).astype(np.float32)
    out = mel_fn.inverse(mel[0], n_iters = 2, phase = torch.from_numpy(phase))
    want = _jax_griffin_lim_loop(ref, jnp.asarray(phase), ref_fn.stft_fn, 2)
    assert out.shape == want.shape == (1, 5 * 16)
    assert _scale_err(out, want) <= 1e-4


def test_htk_scale_and_whisper_match_jax():
    freqs = np.array([0., 440., 1000., 4000., 7999.])
    for htk in (False, True):
        np.testing.assert_allclose(stft.hz_to_mel(freqs, htk), jax_stft.hz_to_mel(freqs, htk),
                                   rtol = 1e-12)
        mels = jax_stft.hz_to_mel(freqs, htk)
        np.testing.assert_allclose(stft.mel_to_hz(mels, htk), jax_stft.mel_to_hz(mels, htk),
                                   rtol = 1e-12)
        for norm in ('slaney', None):
            np.testing.assert_array_equal(
                stft.mel_filterbank(16000, 400, 40, htk = htk, norm = norm),
                jax_stft.mel_filterbank(16000, 400, 40, htk = htk, norm = norm))
    audio = 0.1 * np.random.default_rng(4).standard_normal((1, 4000)).astype(np.float32)
    whisper = stft.MelSTFT.create('WhisperSTFT')
    ref = jax_stft.WhisperSTFT()
    assert type(whisper) is stft.WhisperSTFT and whisper.get_config() == ref.get_config()
    out, want = whisper(audio), np.asarray(ref(audio))
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol = 1e-5, rtol = 0)


# -- the generator ----------------------------------------------------------------------

@pytest.mark.parametrize('with_cond', [False, True], ids = ['plain', 'cond'])
def test_generator_matches_jax(with_cond):
    arch, ref = VocosArch(** TINY), JaxVocosArch(** TINY)
    params = init_vocos(arch.hp, seed = 3)
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 12, 9)).astype(np.float32)
    cond = rng.standard_normal((2, 16)).astype(np.float32) if with_cond else None
    with torch.no_grad():
        mag, phase = arch.spectral_head(hifigan_from_jax(params), torch.from_numpy(mel),
                                        cond = None if cond is None else torch.from_numpy(cond))
        audio = arch.apply(hifigan_from_jax(params), torch.from_numpy(mel),
                           cond = None if cond is None else torch.from_numpy(cond))
    jcond = None if cond is None else jnp.asarray(cond)
    (ref_mag, ref_phase), want = jax.jit(lambda p, m, c: (ref.spectral_head(p, m, cond = c),
                                                         ref.apply(p, m, cond = c)))(
        _jax(params), jnp.asarray(mel), jcond)
    assert mag.shape == ref_mag.shape == (2, 13, 9)
    assert _scale_err(mag, ref_mag) <= SCALE and _scale_err(phase, ref_phase) <= SCALE
    assert audio.shape == want.shape == (2, 12 * 4) and audio.dtype == torch.float32
    assert _scale_err(audio, want) <= SCALE
