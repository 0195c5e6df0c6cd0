"""Losses with named components, and their registry.

Counterpart of ``text_to_speech_tpu/train/losses.py`` for the WaveGlow flow
NLL; the other losses (Tacotron-2, FastSpeech-2, GE2E, GAN) are not ported
yet.  A loss returns ``{'loss': (B,) or (1,), <component>: ...}``: the
trainer logs every component and averages ``'loss'`` for the gradient.
"""

import torch

_LOSSES = {}


def register_loss(name):
    def deco(cls):
        _LOSSES[name.lower()] = cls
        return cls
    return deco


def get_loss(loss, ** kwargs):
    """Resolve a loss by name, config dict or instance."""
    if isinstance(loss, dict):
        kwargs = {** loss, ** kwargs}
        loss = kwargs.pop('name', kwargs.pop('class_name', None))
    if callable(loss) and not isinstance(loss, str):
        return loss
    key = str(loss).lower()
    if key not in _LOSSES:
        raise ValueError('Unknown loss {!r} (known: {})'.format(loss, sorted(_LOSSES)))
    return _LOSSES[key](** kwargs)


@register_loss('WaveGlowLoss')
class WaveGlowLoss:
    """Flow NLL: ||z||²/2σ² − Σ log s − Σ log|det W|, per element."""

    def __init__(self, sigma = 1.0, name = 'waveglow_loss', ** kwargs):
        self.sigma = sigma
        self.name = name

    def __call__(self, y_true, y_pred):
        z, log_s_total, log_det_total = y_pred
        loss = (torch.sum(z * z) / (2 * self.sigma * self.sigma)
                - log_s_total - log_det_total) / z.numel()
        return {'loss': loss.reshape(1) if loss.ndim == 0 else loss}
