"""TTS user API.

Counterpart of ``text_to_speech_tpu/models/tts/__init__.py`` (`tts`,
`get_models`).  Models are instances or the names of saved models under
the pretrained-models root; the language map and streaming are not ported.
"""

from .tacotron2 import Tacotron2
from .waveglow import WaveGlow

_default_vocoder = 'waveglow'


def get_models(model, vocoder = None, *, device = None, root = None):
    """Resolve (synthesizer, vocoder) from instances or saved-model names;
    names load on `device` (``cuda`` unless the caller passes ``'cpu'``)."""
    if isinstance(model, str):
        model = Tacotron2.from_pretrained(model, root = root, device = device)
    if vocoder is None:
        vocoder = _default_vocoder
    if isinstance(vocoder, str):
        vocoder = WaveGlow.from_pretrained(vocoder, root = root, device = device)
    return model, vocoder


def tts(text, *, model, vocoder = None, device = None, root = None, ** kwargs):
    """Main entry point: text (str or list) → one output dict per text (see
    `Tacotron2.predict_batched`), always a list.  Audio playback is not
    ported: ``play`` raises `TypeError`."""
    if 'play' in kwargs:
        raise TypeError('tts() does not take `play` yet: audio playback is not ported '
                        '(see ROADMAP.md)')
    model, vocoder = get_models(model, vocoder, device = device, root = root)
    return model.predict(text, vocoder = vocoder, ** kwargs)


__all__ = ['Tacotron2', 'WaveGlow', 'get_models', 'tts']
