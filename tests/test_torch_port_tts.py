"""The whole slice: the same texts through `text_to_speech_tpu.tts` and the
port's `tts`, text → Tacotron-2 (``overfit_demo``) → a tiny random WaveGlow.

Both packages read the models from a copy of the pretrained-models root in
``tmp_path`` (the JAX side saves the tiny vocoder there first; the port only
reads), so ``pretrained_models/`` is never written.  Two texts, split into
sentences, decode as one batch of chunks, deterministically (no prenet dropout, zero vocoder noise), on the
JAX package's plain decoder and float32 vocoder chain.  Cleaned text,
splitting and tokens must match exactly; mel and waveform agree within
1e-4 absolute (float32 on both sides; mel differences from the
autoregressive decoder feed the vocoder)."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest

from text_to_speech_tpu.models import get_pretrained
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import WaveGlow as JaxWaveGlow, tts as jax_tts
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models.tts import Tacotron2
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch

VOCODER = dict(n_mel_channels = 80, n_flows = 4, n_group = 8, n_early_every = 2,
               n_early_size = 2, wn_layers = 2, wn_channels = 64,
               upsample_width = 1024, upsample_stride = 256)
TEXTS = ['Dr. Smith has 2 cats. They sleep all day.', 'Hello world!']
ATOL = 1e-4


@pytest.fixture
def outputs(tmp_model_dir):
    shutil.copytree('pretrained_models/overfit_demo', '{}/overfit_demo'.format(tmp_model_dir))
    reset_instances()
    try:
        arch = WaveGlowArch(** VOCODER)
        params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
        jwg = JaxWaveGlow(name = 'tiny_wg', ** VOCODER)
        jwg.set_weights({k: _jax(v) if isinstance(v, dict) else v
                         for k, v in params.items()})
        jwg.save()
        # max_text_length=-2 splits into sentences: 4 chunks decode as one batch
        kwargs = dict(batch_size = 2, deterministic = True, max_length = 3.,
                      max_text_length = -2)
        ref = jax_tts(TEXTS, model = 'overfit_demo', vocoder = jwg, save = False,
                      display = False, max_trial = 1, min_fpt_ratio = -1.,
                      max_fpt_ratio = float('inf'), fetch_attention = False, ** kwargs)
        model = Tacotron2.from_pretrained('overfit_demo', root = tmp_model_dir,
                                          device = 'cpu')
        out = tts(TEXTS, model = model, vocoder = 'tiny_wg', device = 'cpu',
                  root = tmp_model_dir, ** kwargs)
        yield ref, out, model, get_pretrained('overfit_demo')
    finally:
        reset_instances()


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_tts_matches_jax(outputs):
    ref, out, model, jax_model = outputs
    assert len(out) == len(ref) == len(TEXTS)
    for r, o in zip(ref, out):
        assert o['text'] == r['text']
        assert o['cleaned'] == r['cleaned']
        assert o['splitted'] == r['splitted']
        assert model.clean_text(o['text']) == jax_model.clean_text(r['text'])
        for s in o['splitted']:
            np.testing.assert_array_equal(model.encode_text(s, cleaned = True),
                                          jax_model.encode_text(s, cleaned = True))
        assert [m.shape for m in o['mel']] == [np.asarray(m).shape for m in r['mel']]
        for m_o, m_r in zip(o['mel'], r['mel']):
            np.testing.assert_allclose(m_o, np.asarray(m_r), atol = ATOL, rtol = 0)
        assert o['rate'] == r['rate']
        assert o['audio'].shape == r['audio'].shape
        assert o['audio'].shape[0] == sum(m.shape[0] for m in o['mel']) * 256
        assert np.isfinite(o['audio']).all()
        np.testing.assert_allclose(o['audio'], np.asarray(r['audio']), atol = ATOL, rtol = 0)
