"""The mel front end and the WAV reader: the port's against the JAX
package's.

`TacotronSTFT` (22050 Hz, 80 mels, 1024/256/1024) on a seeded signal: mel
within 1e-4 absolute (measured 9.5e-7).  On the four in-repo WAVs (float32,
22050 Hz, 3.0-3.5 s, cut to the shortest): within 1e-4 wherever the log-mel is above -8 (a mel
magnitude of 3.4e-4), and within 5e-4 everywhere.  Below it, near-silent
bins, both packages' float32 FFTs are themselves up to 1.8e-4 (JAX) and
2.1e-4 (the port) from a float64 STFT, and the log turns that into the
largest differences, up to 3.1e-4 on these files; the JAX package's own gate
against its goldens is 7e-4.  `load_audio` reads the IEEE-float WAVs the
standard library's ``wave`` cannot, and matches the JAX reader exactly.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.ops.audio_io import load_audio, read_audio
from text_to_speech_tpu_torch.ops.stft import MelSTFT, TacotronSTFT, mel_filterbank

MODELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      'pretrained_models')
WAVS = sorted(glob.glob(os.path.join(MODELS, 'overfit_demo*', 'predictions', 'overfit',
                                     '*.wav')))
MEL_FN = os.path.join(MODELS, 'overfit_demo', 'saving', 'mel_fn.json')


def test_mel_matches_jax_on_a_seeded_signal():
    from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
    audio = (0.3 * np.random.default_rng(0).standard_normal(22050)).astype(np.float32)
    ref = np.asarray(JaxTacotronSTFT()(audio))
    out = TacotronSTFT()(audio).numpy()
    assert out.shape == ref.shape == (1, 87, 80)
    assert float(np.abs(out - ref).max()) <= 1e-4


@pytest.fixture(scope = 'module')
def wav_mels():
    """The four WAVs cut to the shortest one's length, as one batch through
    both packages: one JAX compile for all of them."""
    from text_to_speech_tpu.ops.audio_io import load_audio as jax_load_audio
    from text_to_speech_tpu.ops.stft import TacotronSTFT as JaxTacotronSTFT
    audios = [load_audio(path, 22050) for path in WAVS]
    for path, audio in zip(WAVS, audios):
        np.testing.assert_array_equal(audio, jax_load_audio(path, 22050))
        assert audio.dtype == np.float32 and 66000 < len(audio) < 77000
    batch = np.stack([audio[:min(map(len, audios))] for audio in audios])
    return (np.asarray(JaxTacotronSTFT()(batch)),
            TacotronSTFT()(torch.from_numpy(batch)).numpy())


@pytest.mark.parametrize('index', range(4), ids = [os.path.relpath(p, MODELS) for p in WAVS])
def test_mel_matches_jax_on_the_in_repo_wavs(wav_mels, index):
    ref, out = (mel[index] for mel in wav_mels)
    err = np.abs(out - ref)
    assert float(err[ref > -8.].max()) <= 1e-4
    assert float(err.max()) <= 5e-4


def test_resample_and_mono_match_jax():
    """A stereo int16 array resampled 16 kHz → 22050 Hz: the channels are
    averaged (the JAX reader keeps them; it is handed the mono mix here),
    then resampled and normalized as the JAX package does."""
    from text_to_speech_tpu.ops.audio_io import read_audio as jax_read_audio
    stereo = np.random.default_rng(1).integers(-20000, 20000, (8000, 2)).astype(np.int16)
    rate, out = read_audio(stereo, rate = 16000, target_rate = 22050)
    _, ref = jax_read_audio(stereo.mean(axis = 1), rate = 16000, target_rate = 22050)
    assert rate == 22050 and out.shape == (11025,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol = 0, atol = 1e-6)
    with pytest.raises(ValueError):
        read_audio(stereo)


def test_filterbank_and_config_round_trip(tmp_path):
    from text_to_speech_tpu.ops.stft import mel_filterbank as jax_mel_filterbank
    np.testing.assert_array_equal(mel_filterbank(22050, 1024, 80, 0., 8000.),
                                  jax_mel_filterbank(22050, 1024, 80, 0., 8000.))
    # the JAX package's saved mel_fn.json makes the same extractor
    saved = MelSTFT.load_from_file(MEL_FN)
    assert isinstance(saved, TacotronSTFT) and saved.get_config() == TacotronSTFT().get_config()
    path = saved.save(str(tmp_path / 'mel_fn.json'))
    with open(path) as file, open(MEL_FN) as ref:
        assert json.load(file) == json.load(ref)
    custom = MelSTFT.create('TacotronSTFT', n_mel_channels = 8, normalize_mode = 'per_feature')
    mel = custom(np.random.default_rng(2).standard_normal(4000).astype(np.float32))
    assert mel.shape == (1, 16, 8)
    assert float(mel.mean(dim = 1).abs().max()) < 1e-5
