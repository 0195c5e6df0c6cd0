"""The architectures by name.

Counterpart of ``text_to_speech_tpu/models/registry.py``: `get_architecture`
makes an architecture from its case-insensitive name (the ``architecture``
of a saved model's ``saving/config_models.json``) and its hparams, with the
JAX package's names.
"""


def _architectures():
    from .encoder_arch import AudioEncoder
    from .fastspeech2_arch import FastSpeech2
    from .hifigan_arch import HiFiGAN
    from .tacotron2_arch import Tacotron2
    from .vits_arch import VITS
    from .vocos_arch import Vocos
    from .waveglow_arch import WaveGlow
    from .transformers.transformer_arch import Transformer
    return {'tacotron2': Tacotron2, 'sv2tts_tacotron2': Tacotron2, 'waveglow': WaveGlow,
            'hifigan': HiFiGAN, 'vocos': Vocos, 'fastspeech2': FastSpeech2, 'vits': VITS,
            'audio_encoder': AudioEncoder, 'audioencoder': AudioEncoder,
            'transformer': Transformer}


def get_architecture(architecture, ** kwargs):
    """The architecture `architecture` (a name, or a config dict holding
    ``architecture``) made with hparams `kwargs`."""
    if isinstance(architecture, dict):
        kwargs = {** architecture, ** kwargs}
        architecture = kwargs.pop('architecture')
    classes = _architectures()
    if architecture.lower() not in classes:
        raise ValueError('Unknown architecture {!r} (known: {})'.format(
            architecture, sorted(classes)))
    return classes[architecture.lower()](** kwargs)
