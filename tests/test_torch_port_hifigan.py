"""HiFi-GAN: the port against the JAX package, on the CPU.

  - the generator (`hifigan_arch.HiFiGAN.apply`) in float32 within 1e-5 of
    the waveform's scale, for resblock versions 1 and 2 (the V1 and V3
    layouts), with and without the global `cond`; in bfloat16 within 5e-2
    of scale (both packages cast every leaf; they round at other places);
  - the task model's `infer` (the mel padded to the 64-frame bucket with
    `pad_mel_value`, cropped to ``T * upsample_rate``, a 2-D mel squeezed)
    and `compiled_infer`;
  - `tts(text, model = tacotron2, vocoder = hifigan)` behind the trained
    in-repo Tacotron-2 ``overfit_demo`` (deterministic, gates off): one
    sentence on the one-launch path (16-bit audio from the device, within
    one step of the int16 grid), two texts through `predict_batched`
    (``batch_size=2``, the vocoder queued on the decoded mels) and
    ``win_len=128`` with one and with two chunks, where HiFi-GAN, which
    cannot cut windows on the device, takes the sequential path and vocodes
    each whole mel; the tiny Vocos task model through `predict_batched`;
  - the three repairs of the Tacotron-2 flows that those routes need (they
    raised, or returned one sample, with any vocoder but WaveGlow):
    `_synthesize_and_vocode` leaves a `win_len` without
    `vocode_windowed_from_device`, and a vocoder without `compiled_infer`,
    to the sequential path; `_vocode_chunks` calls `vocode_windowed_batch`
    only where the vocoder has it; and keeps a 1-D waveform whole.

The Tacotron-2 and the vocoder are the same weights in both packages (the
JAX trees through `weights.hifigan_from_jax`); mel within 1e-4 absolute,
audio within 1e-4 absolute (float32 on both sides).  The `cuda` case holds
the forward on the card against the port on the CPU.
"""

import shutil

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

try:
    import jax
    import jax.numpy as jnp
    from text_to_speech_tpu.models import get_pretrained as jax_get_pretrained, saving
    from text_to_speech_tpu.models.hifigan_arch import HiFiGAN as JaxHiFiGANArch
    from text_to_speech_tpu.models.interfaces import reset_instances
    from text_to_speech_tpu.models.tts import (
        HiFiGAN as JaxHiFiGAN, Vocos as JaxVocos, tts as jax_tts)
except ModuleNotFoundError:
    # a machine with a card and without JAX runs the `cuda` case alone
    jnp = None
from text_to_speech_tpu_torch import tts
from text_to_speech_tpu_torch.init import init_hifigan, init_vocos
from text_to_speech_tpu_torch.models.hifigan_arch import HIFIGAN_V3, HiFiGAN as HiFiGANArch
from text_to_speech_tpu_torch.models.tts import HiFiGAN, Tacotron2, Vocos
from text_to_speech_tpu_torch.models.vocos_arch import Vocos as VocosArch
from text_to_speech_tpu_torch.weights import hifigan_from_jax, tree_to

#: the JAX package's tiny generator (``tests/test_hifigan.py``), version 1
TINY = dict(n_mel_channels = 8, upsample_rates = (4, 2, 2), upsample_kernel_sizes = (8, 4, 4),
            upsample_initial_channel = 32, resblock_kernel_sizes = (3, 7),
            resblock_dilation_sizes = ((1, 3), (1, 3)))
#: version 2 resblocks in the V3 layout, at the tiny widths
TINY_V3 = {** HIFIGAN_V3, 'n_mel_channels': 8, 'upsample_rates': (4, 2, 2),
           'upsample_kernel_sizes': (8, 4, 4), 'upsample_initial_channel': 16}
#: the vocoder behind ``overfit_demo`` (80 mels)
VOCODER = dict(TINY, n_mel_channels = 80, upsample_initial_channel = 16,
               resblock_kernel_sizes = (3,), resblock_dilation_sizes = ((1, 3),))
#: the tiny Vocos of ``tests/test_vocos.py`` at 80 mels
VOCOS = dict(n_mel_channels = 80, dim = 16, intermediate_dim = 32, n_layers = 2, kernel_size = 3,
             n_fft = 16, hop_length = 4, win_length = 16)
ATOL = 1e-4
TEXTS = ['Hello world!', 'Dr. Smith has 2 cats. They sleep all day.']
TWO_SENTENCES = 'The birch canoe slid. They sleep all day.'
GATES = dict(deterministic = True, max_length = 64, min_fpt_ratio = -1.,
             max_fpt_ratio = float('inf'), max_trial = 1, save = False, display = False)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _scale_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max())


# -- the generator ----------------------------------------------------------------------

@pytest.mark.parametrize('config', [TINY, TINY_V3], ids = ['v1', 'v3_resblock2'])
@pytest.mark.parametrize('with_cond', [False, True], ids = ['plain', 'cond'])
def test_apply_matches_jax(config, with_cond):
    arch, jax_arch = HiFiGANArch(** config), JaxHiFiGANArch(** config)
    params = init_hifigan(arch.hp, seed = 3)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 13, 8)).astype(np.float32)
    cond = rng.standard_normal((2, config['upsample_initial_channel'])).astype(np.float32) \
        if with_cond else None
    apply = jax.jit(lambda p, m, c: jax_arch.apply(p, m, cond = c))
    ref = np.asarray(apply(_jax(params), jnp.asarray(mel),
                           None if cond is None else jnp.asarray(cond)))
    with torch.no_grad():
        out = arch.apply(hifigan_from_jax(params), torch.from_numpy(mel),
                         cond = None if cond is None else torch.from_numpy(cond))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 13 * 16)
    assert arch.total_upsampling == jax_arch.total_upsampling == 16
    assert _scale_err(out, ref) <= 1e-5


def test_bfloat16_matches_jax():
    arch, jax_arch = HiFiGANArch(** TINY), JaxHiFiGANArch(** TINY)
    params = init_hifigan(arch.hp, seed = 3)
    mel = np.random.default_rng(1).standard_normal((1, 12, 8)).astype(np.float32)
    apply = jax.jit(lambda p, m: jax_arch.apply(p, m, dtype = jnp.bfloat16))
    ref = np.asarray(apply(_jax(params), jnp.asarray(mel)))
    with torch.no_grad():
        out = arch.apply(hifigan_from_jax(params), torch.from_numpy(mel), dtype = torch.bfloat16)
        f32 = arch.apply(hifigan_from_jax(params), torch.from_numpy(mel))
    assert out.dtype == torch.float32
    assert _scale_err(out, ref) <= 5e-2
    assert _scale_err(out, f32) <= 5e-2


# -- the task model and tts() ------------------------------------------------------------

@pytest.fixture(scope = 'module')
def models(tmp_path_factory):
    """(root, JAX Tacotron-2, port Tacotron-2, JAX HiFi-GAN, port HiFi-GAN,
    JAX Vocos, port Vocos): ``overfit_demo`` read from a copy in a temporary
    root, and the random vocoders given to both packages."""
    root = str(tmp_path_factory.mktemp('models'))
    shutil.copytree('pretrained_models/overfit_demo', root + '/overfit_demo')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        params = init_hifigan(HiFiGANArch(** VOCODER).hp, seed = 5)
        jax_vocoder = JaxHiFiGAN(name = 'tiny_hifigan', ** VOCODER)
        jax_vocoder.set_weights(_jax(params))
        vocoder = HiFiGAN.from_jax(params, name = 'tiny_hifigan', root = root, device = 'cpu',
                                   ** VOCODER)
        params = init_vocos(VocosArch(** VOCOS).hp, seed = 7)
        jax_vocos = JaxVocos(name = 'tiny_vocos', ** VOCOS)
        jax_vocos.set_weights(_jax(params))
        vocos = Vocos.from_jax(params, name = 'tiny_vocos', root = root, device = 'cpu', ** VOCOS)
        yield (root, jax_get_pretrained('overfit_demo'),
               Tacotron2.from_pretrained('overfit_demo', root = root, device = 'cpu'),
               jax_vocoder, vocoder, jax_vocos, vocos)
        reset_instances()


def test_task_infer_matches_jax(models):
    """`infer` pads to the 64-frame bucket with -11, crops to T * rate and
    squeezes a 2-D mel; `compiled_infer` returns the whole bucket."""
    jax_vocoder, vocoder = models[3:5]
    assert vocoder.serving_pad_multiple == 64 and vocoder.pad_mel_value == -11.
    assert vocoder.upsample_rate == jax_vocoder.upsample_rate == 16
    mel = np.random.default_rng(2).standard_normal((50, 80)).astype(np.float32)
    one, ref_one = vocoder(mel), np.asarray(jax_vocoder(mel))
    assert one.shape == ref_one.shape == (50 * 16,)
    np.testing.assert_allclose(one, ref_one, atol = ATOL, rtol = 0)
    batch, ref_batch = vocoder.infer(mel[None]), np.asarray(jax_vocoder.infer(mel[None]))
    assert batch.shape == ref_batch.shape == (1, 50 * 16)
    np.testing.assert_array_equal(batch[0], one)
    full = vocoder.compiled_infer(mel).numpy()
    assert full.shape == (1, 64 * 16)
    np.testing.assert_allclose(full, np.asarray(jax_vocoder.compiled_infer(mel)),
                               atol = ATOL, rtol = 0)
    # the padding frames are the silence value: they reach the waveform's end
    padded = np.concatenate([mel, np.full((14, 80), -11., np.float32)])
    np.testing.assert_array_equal(vocoder.compiled_infer(padded).numpy(), full)


def _check_outputs(out, ref, one_launch = False, rate = 16):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o['cleaned'] == r['cleaned'] and o['splitted'] == r['splitted']
        assert len(o['mel']) == len(r['mel'])
        for m_o, m_r in zip(o['mel'], r['mel']):
            np.testing.assert_allclose(m_o, np.asarray(m_r), atol = ATOL, rtol = 0)
        audio, ref_audio = o['audio'], np.asarray(r['audio'])
        assert audio.ndim == 1 and audio.shape == ref_audio.shape
        assert audio.shape[0] == sum(m.shape[0] for m in o['mel']) * rate
        if one_launch:
            # both on the int16 grid: a float32 difference may move a sample by one step
            np.testing.assert_allclose(audio * 32767., np.round(audio * 32767.), atol = 1e-3)
            assert np.abs(audio - ref_audio).max() <= 1. / 32767. + 1e-7
        else:
            np.testing.assert_allclose(audio, ref_audio, atol = ATOL, rtol = 0)


def test_tts_one_launch_matches_jax(models, monkeypatch):
    """One sentence: decode → HiFi-GAN → int16 in one call (`compiled_tts`,
    the vocoder's `device_vocoder_fn` behind the decoder)."""
    root, jax_model, model, jax_vocoder, vocoder = models[:5]

    def sequential(* args, ** kwargs):
        raise AssertionError('the sequential path ran')
    monkeypatch.setattr(Tacotron2, '_synthesize_chunks', sequential)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        ref = jax_tts(TEXTS[0], model = jax_model, vocoder = jax_vocoder, ** GATES)
    out = tts(TEXTS[0], model = model, vocoder = vocoder, ** GATES)
    _check_outputs(out, ref, one_launch = True)


def test_tts_batched_matches_jax(models):
    """Two texts through `predict_batched`: one decode batch, HiFi-GAN
    queued on the decoded mels (`compiled_infer`)."""
    root, jax_model, model, jax_vocoder, vocoder = models[:5]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        ref = jax_tts(TEXTS, model = jax_model, vocoder = jax_vocoder, batch_size = 2, ** GATES)
    out = tts(TEXTS, model = model, vocoder = vocoder, batch_size = 2, ** GATES)
    _check_outputs(out, ref)


def test_tts_with_vocos_matches_jax(models):
    """Two texts through `predict_batched` with the Vocos task model: the
    JAX decode program of `test_tts_batched_matches_jax` serves it."""
    root, jax_model, model = models[:3]
    jax_vocos, vocos = models[5:]
    assert vocos.upsample_rate == jax_vocos.upsample_rate == 4
    assert vocos.serving_pad_multiple == 64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        ref = jax_tts(TEXTS, model = jax_model, vocoder = jax_vocos, batch_size = 2, ** GATES)
    out = tts(TEXTS, model = model, vocoder = vocos, batch_size = 2, ** GATES)
    _check_outputs(out, ref, rate = 4)


@pytest.mark.parametrize('max_text_length', [-1, -2], ids = ['one_chunk', 'two_chunks'])
def test_tts_win_len_matches_jax(models, max_text_length):
    """``win_len=128`` with HiFi-GAN (repairs 1-3): the JAX package leaves
    it to the sequential path, which vocodes each whole mel; the port raised
    `AttributeError` there (no `vocode_windowed_from_device` /
    `vocode_windowed_batch`) or kept one sample of a 1-D waveform."""
    root, jax_model, model, jax_vocoder, vocoder = models[:5]
    kw = dict(GATES, win_len = 128, max_text_length = max_text_length)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        ref = jax_tts(TWO_SENTENCES, model = jax_model, vocoder = jax_vocoder, ** kw)
    out = tts(TWO_SENTENCES, model = model, vocoder = vocoder, ** kw)
    assert len(out[0]['mel']) == (1 if max_text_length == -1 else 2)
    _check_outputs(out, ref)


def test_repairs_route_like_jax(models):
    """The three repairs, on the flows themselves, beside the JAX ones."""
    root, jax_model, model, jax_vocoder, vocoder = models[:5]
    encoded = [model.encode_text(t) for t in TEXTS]
    kw = dict(max_length = 64, min_fpt_ratio = -1., max_fpt_ratio = float('inf'))
    # 1. a win_len without `vocode_windowed_from_device`, or a vocoder
    #    without `compiled_infer`: None, the sequential path's turn
    for route in (model, jax_model):
        assert route._synthesize_and_vocode(encoded, vocoder, win_len = 128, ** kw) is None
        assert route._synthesize_and_vocode(encoded, object(), ** kw) is None
    # 2. and 3. `_vocode_chunks` with a win_len and a vocoder without
    #    `vocode_windowed_batch`: each whole mel, a 1-D waveform kept whole
    mels = [np.random.default_rng(i).standard_normal((20 + 7 * i, 80)).astype(np.float32)
            for i in range(2)]
    out = model._vocode_chunks(vocoder, mels, win_len = 128, hop_len = -64)
    ref = jax_model._vocode_chunks(jax_vocoder, mels, win_len = 128, hop_len = -64)
    assert [a.shape for a in out] == [np.asarray(r).shape for r in ref] == [(320,), (432,)]
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a, np.asarray(r), atol = ATOL, rtol = 0)
    # a vocoder that returns (1, N) for a 2-D mel still gives its row
    wrapped = type('Wrapped', (), {'__call__': lambda self, mel, ** k: vocoder(mel)[None],
                                   'upsample_rate': 16})()
    np.testing.assert_array_equal(model._vocode_chunks(wrapped, mels[:1])[0], out[0])


@pytest.mark.cuda
def test_forward_on_the_card_matches_the_cpu():
    """HiFi-GAN V1 at its published widths: the card's float32 forward
    against the port on the CPU, within 1e-4 of scale (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    arch = HiFiGANArch()
    params = hifigan_from_jax(init_hifigan(arch.hp, seed = 0))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 80))
                           .astype(np.float32))
    with torch.no_grad():
        cpu = arch.apply(params, mel)
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            card = arch.apply(tree_to(params, 'cuda'), mel.cuda())
        finally:
            torch.backends.cudnn.allow_tf32 = allow
    assert _scale_err(card.cpu(), cpu) <= 1e-4
