"""Losses with named components, and their registry.

Counterpart of ``text_to_speech_tpu/train/losses.py``: the WaveGlow flow
NLL, `TacotronLoss` (masked mel losses and the weighted gate BCE),
`FastSpeech2Loss`, `GE2ELoss` and the plain ``mse`` / ``mae``, registered
under the JAX package's names.  The text losses (`TextLoss`, `CTCLoss`)
and the GAN ones are not ported.  A loss returns ``{'loss': (B,) or (1,),
<component>: ...}``: the trainer logs every component and averages
``'loss'`` for the gradient.
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


def list_losses():
    return sorted(_LOSSES)


def binary_crossentropy(y_true, y_pred, from_logits = False, epsilon = 1e-7):
    if from_logits:
        return torch.clamp(y_pred, min = 0.) - y_pred * y_true \
            + torch.log1p(torch.exp(-torch.abs(y_pred)))
    y_pred = torch.clamp(y_pred, epsilon, 1. - epsilon)
    return -(y_true * torch.log(y_pred) + (1. - y_true) * torch.log(1. - y_pred))


@register_loss('TacotronLoss')
class TacotronLoss:
    """loss = mel_loss(decoder) + mel_loss(postnet) + weighted BCE(gate),
    per item.  The mel losses average over the valid frames × channels: the
    mask is ``1 - gate_target``, so the final (gated) frame is left out too;
    a 'weighted' mel loss weighs each error by the target's level,
    normalised per item."""

    def __init__(self, mel_loss = 'mse', mask_mel_padding = True, from_logits = False,
                 label_smoothing = 0., finish_weight = 1., not_finish_weight = 1.,
                 name = 'tacotron_loss', ** kwargs):
        self.mel_loss = mel_loss if isinstance(mel_loss, (list, tuple)) else [mel_loss]
        self.mask_mel_padding = mask_mel_padding
        self.from_logits = from_logits
        self.label_smoothing = label_smoothing
        self.finish_weight = finish_weight
        self.not_finish_weight = not_finish_weight
        self.name = name

    @property
    def output_names(self):
        return (['loss'] + ['{}_mel_loss'.format(l) for l in self.mel_loss]
                + ['{}_mel_postnet_loss'.format(l) for l in self.mel_loss] + ['gate_loss'])

    def compute_mel_loss(self, y_true, y_pred, loss, mask = None):
        if 'mse' in loss:
            err = (y_true - y_pred) ** 2
        elif 'mae' in loss:
            err = torch.abs(y_true - y_pred)
        else:
            raise ValueError('Unknown mel loss: {}'.format(loss))
        if 'weighted' in loss:
            w = y_true - torch.amin(y_true, dim = (1, 2), keepdim = True) + 1.
            w = w / torch.amax(w, dim = (1, 2), keepdim = True)
            err = err * w
        err = err.sum(dim = 2)                                  # (B, T)
        n_ch = y_pred.shape[2]
        if mask is None:
            return err.sum(dim = 1) / (y_pred.shape[1] * n_ch)
        denom = torch.clamp(mask.sum(dim = 1) * n_ch, min = 1.)
        return (err * mask).sum(dim = 1) / denom

    def __call__(self, y_true, y_pred):
        mel_target, gate_target = y_true
        mel_pred, mel_postnet_pred, gate_pred = y_pred[:3]
        gate_weight = (gate_target * self.finish_weight
                       + (1. - gate_target) * self.not_finish_weight)
        target = gate_target
        if self.label_smoothing:
            target = target * (1. - self.label_smoothing) + 0.5 * self.label_smoothing
        gate_loss = binary_crossentropy(target, gate_pred, self.from_logits)
        gate_loss = (gate_loss * gate_weight).mean(dim = 1)
        mask = (1. - gate_target) if self.mask_mel_padding else None
        components, total = {}, gate_loss
        for l in self.mel_loss:
            ml = self.compute_mel_loss(mel_target, mel_pred, l, mask)
            pl = self.compute_mel_loss(mel_target, mel_postnet_pred, l, mask)
            components['{}_mel_loss'.format(l)] = ml
            components['{}_mel_postnet_loss'.format(l)] = pl
            total = total + ml + pl
        return {'loss': total, ** components, 'gate_loss': gate_loss}

    def get_config(self):
        return {'class_name': 'TacotronLoss', 'mel_loss': list(self.mel_loss),
                'mask_mel_padding': self.mask_mel_padding, 'from_logits': self.from_logits,
                'label_smoothing': self.label_smoothing,
                'finish_weight': self.finish_weight,
                'not_finish_weight': self.not_finish_weight}


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


@register_loss('FastSpeech2Loss')
class FastSpeech2Loss:
    """loss = mel(decoder) + mel(postnet) + MSE(log(1 + duration)) +
    MSE(pitch) + MSE(energy), each averaged over the valid frames or tokens
    (the masks the forward returns); phoneme-level variances mask by token,
    frame-level ones by frame."""

    def __init__(self, mel_loss = 'mae', duration_weight = 1., pitch_weight = 1.,
                 energy_weight = 1., name = 'fastspeech2_loss', ** kwargs):
        self.mel_loss = mel_loss
        self.duration_weight = duration_weight
        self.pitch_weight = pitch_weight
        self.energy_weight = energy_weight
        self.name = name

    @property
    def output_names(self):
        return ['loss', 'mel_loss', 'mel_postnet_loss', 'duration_loss', 'pitch_loss',
                'energy_loss']

    def _mel_err(self, y_true, y_pred, frame_mask):
        err = torch.abs(y_true - y_pred) if self.mel_loss == 'mae' else (y_true - y_pred) ** 2
        err = err.sum(dim = 2) * frame_mask
        denom = torch.clamp(frame_mask.sum(dim = 1), min = 1.) * y_pred.shape[2]
        return err.sum(dim = 1) / denom

    @staticmethod
    def _masked_mse(target, pred, mask):
        err = (target - pred) ** 2 * mask
        return err.sum(dim = 1) / torch.clamp(mask.sum(dim = 1), min = 1.)

    def __call__(self, y_true, y_pred):
        mel_target, durations, pitch_target, energy_target = (list(y_true) + [None, None])[:4]
        mel, mel_post, log_d_pred, pitch_pred, energy_pred, frame_mask, token_mask = y_pred[:7]
        frame_mask = frame_mask.to(mel.dtype)
        token_mask = token_mask.to(mel.dtype)
        T = min(mel.shape[1], mel_target.shape[1])
        mel_l = self._mel_err(mel_target[:, :T], mel[:, :T], frame_mask[:, :T])
        post_l = self._mel_err(mel_target[:, :T], mel_post[:, :T], frame_mask[:, :T])
        dur_l = self._masked_mse(torch.log1p(durations.float()), log_d_pred, token_mask)
        zero = torch.zeros_like(dur_l)

        def variance_loss(target, pred):
            if target is None or pred is None:
                return zero
            mask = token_mask if pred.shape[1] == token_mask.shape[1] else frame_mask
            return self._masked_mse(target, pred, mask)

        pitch_l = variance_loss(pitch_target, pitch_pred)
        energy_l = variance_loss(energy_target, energy_pred)
        total = (mel_l + post_l + self.duration_weight * dur_l + self.pitch_weight * pitch_l
                 + self.energy_weight * energy_l)
        return {'loss': total, 'mel_loss': mel_l, 'mel_postnet_loss': post_l,
                'duration_loss': dur_l, 'pitch_loss': pitch_l, 'energy_loss': energy_l}

    def get_config(self):
        return {'class_name': 'FastSpeech2Loss', 'mel_loss': self.mel_loss,
                'duration_weight': self.duration_weight, 'pitch_weight': self.pitch_weight,
                'energy_weight': self.energy_weight}


@register_loss('mse')
class MSELoss:
    def __init__(self, name = 'mse', ** kwargs):
        self.name = name

    def __call__(self, y_true, y_pred):
        return {'loss': ((y_true - y_pred) ** 2).mean(dim = tuple(range(1, y_pred.dim())))}

    def get_config(self):
        return {'class_name': 'mse'}


@register_loss('mae')
class MAELoss:
    def __init__(self, name = 'mae', ** kwargs):
        self.name = name

    def __call__(self, y_true, y_pred):
        return {'loss': torch.abs(y_true - y_pred).mean(dim = tuple(range(1, y_pred.dim())))}

    def get_config(self):
        return {'class_name': 'mae'}


@register_loss('GE2ELoss')
class GE2ELoss:
    """Generalized end-to-end speaker-verification loss (softmax): the
    embeddings (N speakers, M utterances, D) against the speakers'
    centroids, each utterance left out of its own speaker's centroid,
    scaled by the learned (w, b) with w clamped at 1e-3; the NLL of the own
    speaker through a one-hot contraction, per speaker."""

    def __init__(self, mode = 'softmax', init_w = 10., init_b = -5., name = 'ge2e_loss',
                 ** kwargs):
        self.mode = mode
        self.init_w = init_w
        self.init_b = init_b
        self.name = name

    def similarity_matrix(self, embeddings):
        n, m, d = embeddings.shape
        centroids = embeddings.mean(dim = 1)                             # (N, D)
        excl = (embeddings.sum(dim = 1, keepdim = True) - embeddings) / (m - 1)

        def cos(a, b):
            num = (a * b).sum(dim = -1)
            return num / (torch.linalg.vector_norm(a, dim = -1)
                          * torch.linalg.vector_norm(b, dim = -1) + 1e-9)

        sim = cos(embeddings[:, :, None, :], centroids[None, None, :, :])  # (N, M, N)
        own = cos(embeddings, excl)                                          # (N, M)
        eye = torch.eye(n, dtype = torch.bool, device = embeddings.device)[:, None, :]
        return torch.where(eye, own[:, :, None], sim)

    def __call__(self, y_true, y_pred, w = None, b = None):
        if isinstance(y_pred, tuple):
            y_pred, w, b = y_pred
        if w is None: w = self.init_w
        if b is None: b = self.init_b
        w = torch.clamp(torch.as_tensor(w, dtype = y_pred.dtype, device = y_pred.device),
                        min = 1e-3)
        sim = w * self.similarity_matrix(y_pred) + b
        n = sim.shape[0]
        logp = torch.log_softmax(sim, dim = -1)
        one_hot = torch.eye(n, dtype = logp.dtype, device = logp.device)[:, None, :]
        nll = -(logp * one_hot).sum(dim = -1)                                # (N, M)
        return {'loss': nll.mean(dim = 1)}

    def get_config(self):
        return {'class_name': 'GE2ELoss', 'mode': self.mode}
