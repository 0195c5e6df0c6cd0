"""Architectures (`tacotron2_arch`, `waveglow_arch`) and task models (`tts`)."""
