"""Training: the trainer, its losses, optimizers, precision policy,
datasets, history and checkpoints (counterpart of ``text_to_speech_tpu/train``)."""
