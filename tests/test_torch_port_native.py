"""The port's native audio library and loader pool against the JAX
package's.

Both libraries are compiled here by ``g++`` with the same flags (``-O3
-march=native``) from the same arithmetic, so every comparison is to the
bit:

  - the DSP functions (PCM conversion, normalization, Kaiser-sinc
    resampling up and down, frame RMS, trim bounds, overlap stitching) and
    ``resample_audio(method = 'sinc')``;
  - `load_audio_batch` on a mono 16-bit 16 kHz WAV, a mono float 22.05 kHz
    WAV and a stereo 16 kHz WAV, at the model's 22.05 kHz: the mono rows
    decode on the pool in both packages (the 16 kHz one resampled by the
    sinc); the stereo row goes through each package's Python reader, where
    the port averages the channels (its `read_audio`) and the JAX package
    keeps both: the port's row equals the JAX reader on the channel mean
    (FFT resampling), as ``test_torch_port_stft.py`` holds it;
  - the pool returns every ticket; without a compiler the library warns and
    every row goes through Python, with ``native_rows`` 0.
"""

import logging

import numpy as np
import pytest
from scipy.io import wavfile

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu import native as jnative
from text_to_speech_tpu.native import data_loader as jloader
from text_to_speech_tpu.ops.audio_io import read_audio as jax_read_audio
from text_to_speech_tpu.ops.audio_processing import resample_audio as jax_resample_audio

from text_to_speech_tpu_torch import native
from text_to_speech_tpu_torch.native import data_loader
from text_to_speech_tpu_torch.ops.audio_io import read_audio
from text_to_speech_tpu_torch.ops.audio_processing import resample_audio


@pytest.fixture(scope = 'module')
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp('wavs')
    rng = np.random.default_rng(0)
    t16, t22 = np.arange(8000) / 16000., np.arange(11025) / 22050.
    files = {
        'mono16.wav': (16000, (0.4 * np.sin(2 * np.pi * 220 * t16) * 32767
                               + 300 * rng.standard_normal(8000)).astype(np.int16)),
        'mono22.wav': (22050, (0.3 * np.sin(2 * np.pi * 330 * t22) + 0.01).astype(np.float32)),
        'stereo16.wav': (16000, (0.2 * rng.standard_normal((8000, 2)) * 32767).astype(np.int16)),
    }
    paths = {}
    for name, (rate, audio) in files.items():
        paths[name] = str(root / name)
        wavfile.write(paths[name], rate, audio)
    return paths


def test_libraries_build_and_agree_to_the_bit():
    assert native.available() and jnative.available()
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal(12345)).astype(np.float32)
    pcm = (x * 20000).astype(np.int16)
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm), jnative.pcm16_to_f32(pcm))
    np.testing.assert_array_equal(native.f32_to_pcm16(x), jnative.f32_to_pcm16(x))
    np.testing.assert_array_equal(native.normalize(x + 0.1, 0.8), jnative.normalize(x + 0.1, 0.8))
    for rates in ((16000, 22050), (22050, 16000), (44100, 22050), (8000, 24000)):
        out = native.resample(x, * rates)
        np.testing.assert_array_equal(out, jnative.resample(x, * rates))
        np.testing.assert_array_equal(resample_audio(x, * rates, method = 'sinc')[0],
                                      jax_resample_audio(x, * rates, method = 'sinc')[0])
        assert len(out) == int(len(x) * rates[1] / rates[0])
    np.testing.assert_array_equal(resample_audio(x, 16000, 22050)[0],
                                  jax_resample_audio(x, 16000, 22050)[0])
    np.testing.assert_array_equal(native.frame_rms(x, 400, 160), jnative.frame_rms(x, 400, 160))
    quiet = np.concatenate([np.zeros(3000, np.float32), x, np.zeros(2000, np.float32)])
    assert native.trim_bounds(quiet, 400, 160) == jnative.trim_bounds(quiet, 400, 160)
    parts = rng.standard_normal((4, 1000)).astype(np.float32)
    overlaps = np.asarray([100, 201, 64])
    np.testing.assert_array_equal(native.overlap_stitch(parts, overlaps),
                                  jnative.overlap_stitch(parts, overlaps))
    with pytest.raises(ValueError, match = 'method'):
        resample_audio(x, 16000, 22050, method = 'linear')


def test_load_audio_batch_matches_jax(wavs):
    paths = [wavs['mono16.wav'], wavs['stereo16.wav'], wavs['mono22.wav']]
    out = data_loader.load_audio_batch(paths, target_rate = 22050, n_workers = 2)
    ref = jloader.load_audio_batch(paths, target_rate = 22050, n_workers = 2)
    assert out.native_rows == 2
    for i in (0, 2):
        assert out[i][1] == ref[i][1] == 22050
        assert out[i][0].dtype == ref[i][0].dtype == np.float32
        np.testing.assert_array_equal(out[i][0], ref[i][0])
    # the sinc resampling of the native pool is not the Python reader's FFT
    python_row = read_audio(wavs['mono16.wav'], target_rate = 22050)[1]
    assert out[0][0].shape == python_row.shape and not np.array_equal(out[0][0], python_row)
    rate, stereo = wavfile.read(wavs['stereo16.wav'])
    assert ref[1][0].shape == (11025, 2) and out[1][0].shape == (11025,)
    _, mean_ref = jax_read_audio(stereo.mean(axis = 1), rate = rate, target_rate = 22050)
    np.testing.assert_array_equal(out[1][0], mean_ref)
    unnormalized = data_loader.load_audio_batch([wavs['mono22.wav']], normalize = False)
    np.testing.assert_array_equal(unnormalized[0][0], wavfile.read(wavs['mono22.wav'])[1])


def test_pool_returns_every_ticket(wavs):
    paths = [wavs['mono16.wav'], wavs['mono22.wav'], wavs['stereo16.wav'], '/nonexistent.wav'] * 3
    with data_loader.AudioLoaderPool(n_workers = 3, capacity = 2) as pool:
        for i, path in enumerate(paths):
            pool.submit(i, path, target_rate = 16000)
        results = {}
        for _ in paths:
            ticket, audio, rate, status = pool.next()
            results[ticket] = (audio, rate, status)
    assert sorted(results) == list(range(len(paths)))
    for i, path in enumerate(paths):
        audio, rate, status = results[i]
        expected = {'stereo16.wav': data_loader.ERR_FORMAT,
                    'nonexistent.wav': data_loader.ERR_OPEN}.get(path.split('/')[-1],
                                                                  data_loader.LOAD_OK)
        assert status == expected, path
        assert (audio is not None) == (status == data_loader.LOAD_OK)
        if audio is not None:
            assert rate == 16000 and len(audio) == 8000


def test_without_a_compiler_every_row_goes_through_python(wavs, monkeypatch, caplog):
    monkeypatch.setattr(data_loader, '_lib', None)
    monkeypatch.setattr(data_loader, '_build_failed', False)
    monkeypatch.setattr(data_loader, 'build_native_library', lambda * a, ** k: None)
    with caplog.at_level(logging.WARNING):
        out = data_loader.load_audio_batch([wavs['mono16.wav'], wavs['mono22.wav']],
                                           target_rate = 22050)
    assert 'unavailable' in caplog.text and out.native_rows == 0
    for (audio, rate), path in zip(out, [wavs['mono16.wav'], wavs['mono22.wav']]):
        np.testing.assert_array_equal(audio, read_audio(path, target_rate = 22050)[1])
    with pytest.raises(RuntimeError, match = 'unavailable'):
        data_loader.AudioLoaderPool()
