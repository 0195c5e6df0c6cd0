"""The `tts()` surface around synthesis: the inference callbacks and the
``map.json`` cache against the JAX package, the language map and
`add_model_name`, audio playback through an injected player, the
`TTSHandler`, the `Stream` pipeline and `stream()`.

Tacotron-2 ``overfit_demo`` is read from a copy in ``tmp_path`` and a tiny
random WaveGlow (4 flows, 2 layers, 64 channels) is given to both packages;
each package writes into its own ``tmp_path`` directory, so
``pretrained_models/`` is never written.  One sentence per text, so both
packages take the one-launch path and write 16-bit audio: the WAVs agree
within 1e-4; the ``map.json`` keys and fields are equal (file paths by
their base name)."""

import logging
import os
import queue
import shutil
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow, tts as jax_tts
from text_to_speech_tpu_torch import stream, tts
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.loggers.handlers import TTSHandler
from text_to_speech_tpu_torch.models import tts as tts_module
from text_to_speech_tpu_torch.models.tts import (
    Tacotron2, WaveGlow, get_model_lang, get_pretrained_model, set_pretrained_model)
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.ops import audio_io
from text_to_speech_tpu_torch.ops.audio_stream import AudioPlayer, AudioStream, stream_audio
from text_to_speech_tpu_torch.utils.file_utils import load_json
from text_to_speech_tpu_torch.utils.stream import KEEP_ALIVE, STOP, Stream

VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
TEXTS = ['Hello world!', 'They sleep all day.']
KW = dict(deterministic = True, max_length = 64, min_fpt_ratio = -1.,
          max_fpt_ratio = float('inf'), vocoder_config = {'deterministic': True})


@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    """(JAX vocoder, port Tacotron-2, port vocoder, models root)."""
    root = str(tmp_path_factory.mktemp('models'))
    shutil.copytree('pretrained_models/overfit_demo', root + '/overfit_demo')
    arch = WaveGlowArch(** VOCODER)
    params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    to_jax = lambda t: {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                        for k, v in t.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        jax_vocoder = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        jax_vocoder.set_weights(to_jax(params))
        yield (jax_vocoder, Tacotron2.from_pretrained('overfit_demo', root = root, device = 'cpu'),
               WaveGlow.from_jax(params, device = 'cpu', ** VOCODER), root)
        reset_instances()


def _short_bucket(monkeypatch, vocoder):
    """The vocoder's one-launch bucket at 64 frames (the decode buffer's),
    not 256, on the port-only tests: a quarter of the vocoder's CPU time.
    The 256-frame bucket is held against the JAX package in
    `test_callbacks_and_cache_match_jax`."""
    monkeypatch.setattr(vocoder, 'serving_pad_multiple', 64)


def _spy(monkeypatch, obj, name):
    calls = []
    original = getattr(obj, name)
    monkeypatch.setattr(obj, name, lambda * a, ** kw: calls.append(name) or original(* a, ** kw))
    return calls


# -- callbacks and the map.json cache --------------------------------------------------

def test_callbacks_and_cache_match_jax(models, tmp_path, monkeypatch):
    jax_vocoder, model, vocoder, root = models
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    monkeypatch.setattr(saving, '_PRETRAINED_ROOT', root)
    ref = jax_tts(TEXTS, model = 'overfit_demo', vocoder = jax_vocoder, directory = jax_dir,
                  display = False, ** KW)
    out = tts(TEXTS, model = model, vocoder = vocoder, directory = port_dir, display = False,
              ** KW)
    assert [o['text'] for o in out] == [r['text'] for r in ref] == TEXTS

    port_map = load_json(os.path.join(port_dir, 'map.json'))
    jax_map = load_json(os.path.join(jax_dir, 'map.json'))
    assert list(port_map) == list(jax_map) == TEXTS
    for text, o in zip(TEXTS, out):
        entry, ref_entry = port_map[text], jax_map[text]
        assert set(entry) == set(ref_entry) == {'text', 'cleaned', 'splitted', 'audio',
                                                'rate', 'time'}
        for key in ('text', 'cleaned', 'splitted', 'rate'):
            assert entry[key] == ref_entry[key]
        assert entry['time'] == pytest.approx(ref_entry['time'])
        assert os.path.basename(entry['audio']) == os.path.basename(ref_entry['audio'])
        assert entry['audio'].startswith(os.path.join(port_dir, 'audios', 'audio-'))
        rate, audio = wavfile.read(entry['audio'])
        ref_rate, ref_audio = wavfile.read(ref_entry['audio'])
        assert rate == ref_rate == 22050 and audio.dtype == np.float32
        np.testing.assert_array_equal(audio, o['audio'])
        np.testing.assert_allclose(audio, ref_audio, atol = 1e-4, rtol = 0)

    # the same texts again: answered from map.json, nothing decodes
    calls = _spy(monkeypatch, model, 'compiled_infer') + _spy(monkeypatch, model, 'compiled_tts')
    again = tts(TEXTS, model = model, vocoder = vocoder, directory = port_dir, display = False,
                ** KW)
    assert not calls and again == [port_map[t] for t in TEXTS]
    # overwrite decodes again and records the new file; return_output=False
    # returns the text's new map entry
    tts_calls = _spy(monkeypatch, model, 'compiled_tts')
    infos = tts(TEXTS[1], model = model, vocoder = vocoder, directory = port_dir,
                display = False, overwrite = True, return_output = False, ** KW)[0]
    assert len(tts_calls) == 1
    assert sorted(os.listdir(os.path.join(port_dir, 'audios'))) \
        == ['audio-{}.wav'.format(i) for i in range(3)]
    assert infos == load_json(os.path.join(port_dir, 'map.json'))[TEXTS[1]]
    assert set(infos) == set(port_map[TEXTS[1]]) and infos['audio'].endswith('audio-2.wav')


def test_tts_surface(models, monkeypatch, tmp_path):
    """The language map, `add_model_name` and `embeddings` (unused by a
    model without speaker conditioning, as in the JAX architecture)."""
    _, model, vocoder, root = models
    _short_bucket(monkeypatch, vocoder)
    monkeypatch.setitem(tts_module._pretrained, 'en', tts_module._pretrained['en'])
    assert get_pretrained_model('fr') == 'sv2tts_siwis_v3'
    set_pretrained_model('overfit_demo', 'en')
    assert get_pretrained_model('en') == get_model_lang('en') == 'overfit_demo'
    directory = str(tmp_path / 'preds')
    out = tts('Hello world!', lang = 'en', vocoder = vocoder, device = 'cpu', root = root,
              directory = directory, add_model_name = True, display = False, ** KW)
    assert len(out) == 1 and np.isfinite(out[0]['audio']).all()
    assert os.path.exists(os.path.join(directory, 'overfit_demo', 'map.json'))
    with pytest.raises(ValueError):
        get_model_lang('xx')
    with pytest.raises(ValueError):
        tts('hi', lang = 'xx')
    kw = dict(deterministic = True, max_length = 64, min_fpt_ratio = -1.,
              max_fpt_ratio = float('inf'))
    np.testing.assert_array_equal(
        model.infer('Hi.', embeddings = np.zeros(4, np.float32), ** kw)['mel'][0],
        model.infer('Hi.', ** kw)['mel'][0])


# -- playback ---------------------------------------------------------------------------

def _stub_player(path):
    """A player command that copies its standard input into `path`."""
    return [sys.executable, '-c', 'import shutil, sys; '
            'shutil.copyfileobj(sys.stdin.buffer, open(sys.argv[1], "wb"))', str(path)]


def test_audio_stream_feeds_the_player_int16(tmp_path):
    clip = (0.5 * np.sin(np.arange(3000) / 10.)).astype(np.float32)
    pcm = np.clip(clip * 32767., -32768, 32767).astype(np.int16)
    assert AudioPlayer(22050, player = _stub_player(tmp_path / 'one')).play(clip)
    assert (tmp_path / 'one').read_bytes() == pcm.tobytes()
    assert stream_audio([clip[:1000], pcm[1000:]], player = _stub_player(tmp_path / 'two'))
    assert (tmp_path / 'two').read_bytes() == pcm.tobytes()


def test_playback_without_a_player(monkeypatch, caplog):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with caplog.at_level(logging.WARNING):
        assert audio_io.play_audio(np.zeros(100, np.float32), 22050) is False
        assert AudioStream(22050).start() is False
        assert AudioPlayer(22050).play(np.zeros(100, np.float32)) is False
    assert 'No audio player available' in caplog.text


def test_tts_handler_speaks_without_recursing(models, monkeypatch):
    """`TTSHandler` reaches `tts(..., play=True)`; with no player the
    playback logs a warning through the same logger, which the handler
    does not re-enter."""
    _, model, vocoder, _ = models
    _short_bucket(monkeypatch, vocoder)
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    monkeypatch.setattr(tts_module, '_default_vocoder', vocoder)
    speaks, speak = [], tts_module.tts
    # the handler's call, at this file's short length and open gates
    monkeypatch.setattr(tts_module, 'tts', lambda * a, ** kw: speaks.append(kw)
                        or speak(* a, ** {** kw, ** KW}))
    handler = TTSHandler(model = model, level = logging.WARNING)
    emits = _spy(monkeypatch, handler, 'emit')
    errors = []
    monkeypatch.setattr(handler, 'handleError', errors.append)
    log = logging.getLogger('text_to_speech_tpu_torch')
    log.addHandler(handler)
    try:
        log.warning('Hello world!')
    finally:
        log.removeHandler(handler)
    assert not errors and not handler._busy
    assert len(emits) == 2                 # the record, then the player's warning
    assert len(speaks) == 1 and speaks[0]['play'] and speaks[0]['lang'] == 'en'


# -- Stream and stream() ---------------------------------------------------------------

@pytest.mark.parametrize('workers', [0, 1, 3])
def test_stream_keeps_order_and_drops_a_raising_callback(workers):
    def fn(x):
        time.sleep(0.002 * ((7 * x) % 5))          # later items may finish first
        return x * x

    def bad(result):
        raise RuntimeError('callback fault')

    seen = []
    items = [0, 1, KEEP_ALIVE, 2, 3, 4, 5, 6, 7, STOP, 8]
    s = Stream(fn, items, workers = workers, item_callback = [bad, seen.append])
    assert list(s) == seen == [x * x for x in range(8)]
    assert s._callbacks['item'] == [seen.append]
    with pytest.raises(ZeroDivisionError):
        list(Stream(lambda x: 1 / x, [1, 0, 2], workers = workers))


def test_stream_over_a_queue(models, monkeypatch):
    _, model, vocoder, _ = models
    _short_bucket(monkeypatch, vocoder)
    texts = TEXTS
    inputs, outputs = queue.Queue(), queue.Queue()
    for text in texts + [None]:
        inputs.put(text)
    results = stream(inputs, model = model, vocoder = vocoder, play = False, save = False,
                     display = False, post_processing = outputs, ** KW)
    assert [r['text'] for r in results] == texts
    delivered = [outputs.get_nowait() for _ in range(outputs.qsize())]
    assert [d['text'] for d in delivered] == texts
    assert all(np.isfinite(d['audio']).all() for d in delivered)
