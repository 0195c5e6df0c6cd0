"""Vocos task model: the frame-rate inverse-STFT vocoder.

Counterpart of ``text_to_speech_tpu/models/tts/vocos.py``: `HiFiGAN`'s
vocoder surface (`compiled_infer` on the 64-frame bucket,
`device_vocoder_fn` behind the fused decoder, `infer` cropped to ``T *
hop``, saving by name) over the ConvNeXt + inverse-STFT generator
(`models.vocos_arch`).  `create` seeds `init.init_vocos`;
`from_torch_pretrained` imports an official Vocos checkpoint
(``backbone.convnext`` layout, `models.tts_checkpoints.convert_vocos`).
It trains as `HiFiGAN` does (`prepare_data`, `collate`, `fit` through
`train.gan.fit_gan`), against the HiFi-GAN discriminators.
"""

from ...init import init_vocos
from ..tts_checkpoints import (
    _load_state_dict, convert_vocos, remove_torch_weight_norm, vocos_config_from_state_dict)
from .hifigan import HiFiGAN


class Vocos(HiFiGAN):
    architecture = 'vocos'

    def __init__(self, params, *, name = 'vocos', ** kwargs):
        super().__init__(params, name = name, ** kwargs)

    @staticmethod
    def _random_params(arch, seed):
        return init_vocos(arch.hp, seed = seed)

    @classmethod
    def from_torch_pretrained(cls, checkpoint, *, name = 'vocos', config = None, root = None,
                              device = None, ** kwargs):
        """Import an official Vocos checkpoint (a state dict, or a ``.pt`` /
        ``.pth`` / ``.safetensors`` file) as `name` under `root`: the sizes
        come from its shapes, `config` overrides what they cannot say
        (`hop_length`, `win_length`); the model is saved."""
        sd = remove_torch_weight_norm(_load_state_dict(checkpoint))
        inferred = vocos_config_from_state_dict(sd)
        inferred.update(config or {})
        model = cls.from_jax(convert_vocos(sd), name = name, root = root, device = device,
                             ** {** inferred, ** kwargs})
        model.save()
        return model
