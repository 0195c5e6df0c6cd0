"""Training: the trainer, its losses, optimizers, precision policy,
datasets, corpora and their loader, metrics, history and checkpoints
(counterpart of ``text_to_speech_tpu/train``)."""
