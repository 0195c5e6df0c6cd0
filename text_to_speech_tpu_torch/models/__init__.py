"""Architectures (`tacotron2_arch`, `waveglow_arch`, `encoder_arch`,
`fastspeech2_arch`, `hifigan_arch`, `vocos_arch`, `vits_arch`, by name
through `registry`), task models (`tts`, `encoder`), the checkpoint
importers (`tts_checkpoints`) and `get_pretrained`.

Counterpart of ``text_to_speech_tpu/models/__init__.py``: `get_pretrained`
loads a saved model by name with the class its ``config.json`` names.
"""

import os

from ..utils.file_utils import load_json
from .saving import model_dir


def _model_classes():
    from .encoder import SpeakerEncoder
    from .tts import (
        VITS, FastSpeech2, HiFiGAN, SV2TTSTacotron2, SV2TTSVITS, Tacotron2, Vocos, WaveGlow)
    return {cls.__name__: cls for cls in (Tacotron2, SV2TTSTacotron2, FastSpeech2, WaveGlow,
                                          HiFiGAN, Vocos, VITS, SV2TTSVITS, SpeakerEncoder)}


def get_pretrained(name, *, root = None, device = None):
    """The saved model `name` under `root` (the pretrained-models root by
    default), loaded on `device` as its ``config.json`` `class_name`."""
    config_file = model_dir(name, 'config.json', root = root)
    if not os.path.exists(config_file):
        raise ValueError('Unknown pretrained model {!r} (no {})'.format(name, config_file))
    class_name = load_json(config_file).get('class_name')
    classes = _model_classes()
    if class_name not in classes:
        raise ValueError('Unknown model class {!r} for {!r} (known: {})'.format(
            class_name, name, sorted(classes)))
    return classes[class_name].from_pretrained(name, root = root, device = device)
