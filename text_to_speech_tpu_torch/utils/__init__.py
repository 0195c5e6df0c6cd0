"""Host-side helpers: JSON files, iterables, the `Stream` pipeline and the
inference callbacks (counterparts of ``text_to_speech_tpu/utils/``)."""
