"""The speaker encoder (`SpeakerEncoder`), SV2TTS's `encoder_name` delegate."""

from .speaker_encoder import SpeakerEncoder

__all__ = ['SpeakerEncoder']
