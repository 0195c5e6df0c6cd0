"""TTS user API.

Counterpart of ``text_to_speech_tpu/models/tts/__init__.py``: the
language → pretrained-model map (`set_pretrained_model`,
`get_pretrained_model`, `get_model_lang`), `get_models`, `tts` and
`stream`.  Models are instances or the names of saved models under the
pretrained-models root (or the caller's `root`), loaded on `device` with
the class their ``config.json`` names (`models.get_pretrained`): the `fr`
default is an `SV2TTSTacotron2`, which takes `embeddings=` or `audio=`; a
saved `FastSpeech2` (``fs2_train``) is named with `model=`.  The map's
defaults are not in the repo: the `en` one, ``pretrained_tacotron2``, is
made from NVIDIA's checkpoints by `Tacotron2.from_nvidia_pretrained` (with
`WaveGlow.from_nvidia_pretrained` for the ``waveglow`` vocoder) into a
`root`; otherwise loading them raises, and nothing is downloaded.
The vocoder is a `WaveGlow`, a `HiFiGAN` or a `Vocos` (instances or saved
names); an end-to-end model (`VITS`, `SV2TTSVITS`: ``is_end_to_end``) is
its own vocoder unless one is forced.  `serve()` puts a model behind HTTP
with continuous batching (`runtimes.serving`, `runtimes.http_server`).
"""

import logging
import os

from .fastspeech2 import FastSpeech2
from .hifigan import HiFiGAN
from .sv2tts_tacotron2 import SV2TTSTacotron2
from .sv2tts_vits import SV2TTSVITS
from .tacotron2 import Tacotron2
from .vits import VITS
from .vocos import Vocos
from .waveglow import WaveGlow

logger = logging.getLogger(__name__)

_pretrained = {
    'en': 'pretrained_tacotron2',
    'fr': 'sv2tts_siwis_v3',
}

_default_vocoder = 'waveglow'


def set_pretrained_model(model, lang):
    """Map `lang` onto `model` for future `tts(..., lang = lang)` calls."""
    _pretrained[lang] = model


def get_pretrained_model(lang):
    return _pretrained.get(lang)


def get_model_lang(lang):
    if lang not in _pretrained:
        raise ValueError('No pretrained model for lang {!r} (known: {})'.format(
            lang, sorted(_pretrained)
        ))
    return _pretrained[lang]


def get_models(model = None, lang = None, vocoder = None, *, device = None, root = None):
    """Resolve (synthesizer, vocoder) from a model name/instance or a lang;
    names load on `device` (``cuda`` unless the caller passes ``'cpu'``).
    An end-to-end model is its own vocoder unless another is forced."""
    if model is None:
        if lang is None:
            raise ValueError('Provide either `model` or `lang`')
        model = get_model_lang(lang)
    from .. import get_pretrained
    if isinstance(model, str):
        model = get_pretrained(model, root = root, device = device)
    if getattr(model, 'is_end_to_end', False):
        # the model synthesizes waveforms: its own vocoder unless one is forced
        return model, (vocoder if vocoder not in (None, _default_vocoder) else model)
    if vocoder is None:
        vocoder = _default_vocoder
    if isinstance(vocoder, str):
        vocoder = get_pretrained(vocoder, root = root, device = device)
    return model, vocoder


def tts(text, *, model = None, lang = None, vocoder = None, add_model_name = False,
        device = None, root = None, ** kwargs):
    """Main entry point: text (str or list) → one output dict per text (see
    `Tacotron2.predict`), always a list.

    `add_model_name` redirects an explicit `directory=` into a per-model
    subdirectory, so several models can predict into one artifact root."""
    model, vocoder = get_models(model = model, lang = lang, vocoder = vocoder,
                                device = device, root = root)
    if add_model_name and kwargs.get('directory'):
        kwargs['directory'] = os.path.join(kwargs['directory'], model.name)
    return model.predict(text, vocoder = vocoder, ** kwargs)


def stream(stream_input, *, model = None, lang = None, vocoder = None, play = True,
           device = None, root = None, ** kwargs):
    """Synthesis over a queue (ended by `None`) or an iterator of texts
    (`Tacotron2.stream`)."""
    model, vocoder = get_models(model = model, lang = lang, vocoder = vocoder,
                                device = device, root = root)
    return model.stream(stream_input, vocoder = vocoder, play = play, ** kwargs)


def serve(*, model = None, lang = None, vocoder = None, host = '127.0.0.1', port = 8700,
          max_batch_size = 16, block = True, window = 96, chunk = 64, warmup = None,
          device = None, root = None, mesh = None, ** stepper_kwargs):
    """Serve a model over HTTP with continuous (in-flight) batching.

    Resolves (synthesizer, vocoder) like `tts()` (names load on `device`,
    ``cuda`` unless the caller passes ``'cpu'``), builds the matching
    stepper (`make_vits_stepper` for end-to-end models, with int16 chunk
    transfer by default and the window shrunk to fit a small model's frame
    buffer; `make_tacotron_stepper(stream_audio=True)` otherwise: K3 decode
    chunks on a card, streamed audio through the vocoder), runs the
    engine's `warmup` on ``warmup`` (a text or a list of texts covering the
    expected token buckets) at every batch bucket before the server accepts
    traffic, and starts `runtimes.http_server.TTSServer` (``port=0``: an
    ephemeral port, read from ``server.address``).  ``block=False`` returns
    the started server (daemon threads) for programmatic use; `stop()` it.

    ``mesh=`` (a `parallel.Mesh`; every rank calls `serve` with the same
    arguments) serves across its data shards (`runtimes.serving.
    mesh_stepper`): names load on each rank's device, the first rank runs
    the engine, its warmup and the server, and every other rank follows the
    stepper until that server stops, then returns None."""
    from ...runtimes.http_server import TTSServer
    from ...runtimes.serving import (
        ContinuousServingEngine, make_tacotron_stepper, make_vits_stepper)

    if mesh is not None:
        device = device if device is not None else mesh.device
        stepper_kwargs['mesh'] = mesh
    model, vocoder = get_models(model = model, lang = lang, vocoder = vocoder,
                                device = device, root = root)
    if getattr(model, 'is_end_to_end', False):
        # int16 chunk transfer by default: the HTTP layer re-encodes to
        # 16-bit PCM anyway
        stepper_kwargs.setdefault('transfer_dtype', 'int16')
        # a small model's latent buffer may not fit the default window +
        # context span: shrink the window, never crash
        context = stepper_kwargs.get('context', 16)
        max_frames = getattr(model.arch.hp, 'max_frames', None)
        if max_frames and window + 2 * context > max_frames:
            window = max(1, max_frames - 2 * context)
        stepper = make_vits_stepper(model, window = window, ** stepper_kwargs)
    else:
        stepper = make_tacotron_stepper(model, chunk = chunk, vocoder = vocoder,
                                        stream_audio = True, ** stepper_kwargs)
    if mesh is not None and not stepper[1].controller:
        stepper[1].follow()
        return None
    engine = ContinuousServingEngine(* stepper, max_batch_size = max_batch_size)
    if warmup is not None:
        try:
            elapsed = engine.warmup(warmup)
        except Exception:
            engine.stop()               # a mesh's followers leave with it
            raise
        logger.info('engine warmup took %.1fs', elapsed)
    server = TTSServer(engine, rate = model.rate, host = host, port = port, name = model.name)
    if not block:
        return server.start()
    logger.info('serving %s on %s', model.name, server.address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


__all__ = ['FastSpeech2', 'HiFiGAN', 'SV2TTSTacotron2', 'SV2TTSVITS', 'Tacotron2', 'VITS', 'Vocos',
           'WaveGlow', 'get_models', 'get_model_lang', 'get_pretrained_model',
           'serve', 'set_pretrained_model', 'stream', 'tts']
