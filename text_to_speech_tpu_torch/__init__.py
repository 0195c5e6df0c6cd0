"""PyTorch/CUDA port of ``text_to_speech_tpu``.

The port runs the text → Tacotron-2 (or FastSpeech-2) → WaveGlow (or
HiFi-GAN, or Vocos) path and the end-to-end VITS on one NVIDIA H100
(sm_90a), with the WaveGlow WN coupling block and the Tacotron-2 decoder
steps as hand-written CUDA kernels (`ops.wn_block`, `ops.decoder_kernel`),
imports NVIDIA's Tacotron-2 and WaveGlow checkpoints and the official
HiFi-GAN, Vocos and VITS ones (`models.tts_checkpoints`), trains WaveGlow and the
synthesizers (`train.trainer.fit`), and clones a voice from a trained
checkpoint (`from_pretrained(name, pretrained_name)`) on corpora read by
the native loader pool (`native`, `train.loader`).  Its
measurement layer is `loggers` (span tree, `torch.profiler` trace),
`devices` (memory stats) and the rate probe `ops.matmul_rate`.  It imports ``torch`` and never ``jax`` or the JAX
package, whose modules it mirrors by name: ``models/waveglow_arch.py`` here
is the counterpart of ``text_to_speech_tpu/models/waveglow_arch.py``, and
so on.  Public functions keep the JAX package's layouts: ``(B, T, C)``
channels-last activations and mel ``(B, frames, n_mel)``.
"""

from .devices import default_device
from .models.tts import tts, get_models, stream

__all__ = ['default_device', 'tts', 'get_models', 'stream']
