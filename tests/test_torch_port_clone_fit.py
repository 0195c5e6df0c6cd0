"""The thirteenth slice as a whole: a voice clone made from a single-speaker
Tacotron-2 and fine-tuned on a multi-speaker corpus, the port against the
JAX package.

A VoxForge-layout corpus of two speakers (sessions ``anna-...`` and
``bob-...``), four synthetic WAVs each, one of them at 16 kHz so that the
native pool's sinc resampler runs; every row carries its speaker's
``embedding``.  A tiny Tacotron-2 made by the JAX package (drop rates 0)
is cloned into an 8-wide SV2TTS model by both packages
(``from_pretrained(name, source)``); the corpus is loaded with
`get_dataset('voxforge')` and split by speaker; each package runs two
epochs of ``fit(native_audio = True)`` with the held-out speaker as
validation data (batch 2, one shape bucket), from the same weights:

  - every WAV row of both datasets decoded by the port's native pool;
  - the epoch losses and validation losses within 1e-4 relative of the JAX
    `fit`'s (each package computes its own mels, within 5e-4 absolute of
    each other, ``test_torch_port_stft.py``);
  - the same best epoch, in the checkpoint manager and in `get_best`, and
    ``load(best = True)`` gives that epoch's weights.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.tts import SV2TTSTacotron2 as JaxSV2TTS, Tacotron2 as JaxTacotron2
from text_to_speech_tpu.train import trainer as jtrainer

from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2
from text_to_speech_tpu_torch.native import data_loader
from text_to_speech_tpu_torch.train.datasets import train_test_split
from text_to_speech_tpu_torch.train.loader import get_dataset

TINY = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
            prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
            lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
            postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
            max_decoder_steps = 16, encoder_drop_rate = 0., prenet_drop_rate = 0.,
            postnet_drop_rate = 0.)
SPK = 8
PROMPTS = ['hello there', 'this is a test', 'synthetic data', 'a clone speaks']


def _corpus(root):
    rng = np.random.default_rng(0)
    for s, session in enumerate(('anna-20100101-abc', 'bob-20110202-xyz')):
        os.makedirs(os.path.join(root, session, 'etc'))
        os.makedirs(os.path.join(root, session, 'wav'))
        with open(os.path.join(root, session, 'etc', 'PROMPTS'), 'w') as f:
            for u, text in enumerate(PROMPTS):
                f.write('mfc/u{} {}\n'.format(u, text.upper()))
                rate = 16000 if (s, u) == (0, 1) else 22050
                t = np.arange(int(rate * (0.2 + 0.04 * u))) / rate
                audio = 0.4 * np.sin(2 * np.pi * (140. + 60. * s) * t * (1. + 0.1 * u)) \
                    + 0.02 * rng.standard_normal(len(t))
                wavfile.write(os.path.join(root, session, 'wav', 'u{}.wav'.format(u)), rate,
                              (audio * 32767).astype(np.int16))
    return root


@pytest.fixture(scope = 'module')
def fitted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('clone_fit'))
    corpus = _corpus(os.path.join(root, 'voxforge'))
    rows = get_dataset('voxforge', directory = corpus)
    speakers = {spk: np.random.default_rng(i + 1).standard_normal(SPK).astype(np.float32)
                for i, spk in enumerate(sorted({r['speaker'] for r in rows}))}
    rows = [dict(r, embedding = speakers[r['speaker']]) for r in rows]
    train, valid = train_test_split(rows, split_column = 'speaker', valid_size = 0.5)
    kw = dict(valid_data = valid, epochs = 2, batch_size = 2, lr = 1e-3, native_audio = True,
              token_multiple = 32, frame_multiple = 64, async_checkpointing = False)

    decoded = []
    original = data_loader.load_audio_batch

    def spy(* args, ** kwargs):
        out = original(* args, ** kwargs)
        decoded.append((len(out), out.native_rows))
        return out

    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        JaxTacotron2(lang = 'en', name = 'single', ** TINY)
        jclone = JaxSV2TTS(lang = 'en', name = 'clone_jax', pretrained_name = 'single',
                           embedding_dim = SPK, ** TINY)
        jhistory = jtrainer.fit(jclone, train, ** kw)
        clone = SV2TTSTacotron2.from_pretrained('clone', 'single', lang = 'en', root = root,
                                                device = 'cpu', embedding_dim = SPK, ** TINY)
        data_loader.load_audio_batch = spy
        try:
            history = clone.fit(train, device = 'cpu', ** kw)
        finally:
            data_loader.load_audio_batch = original
        yield (train, valid, decoded), (clone, history), (jclone, jhistory)
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def test_every_wav_row_decoded_natively(fitted):
    (train, valid, decoded), _, _ = fitted
    assert sorted(decoded) == sorted([(len(train), len(train)), (len(valid), len(valid))])
    assert {r['speaker'] for r in train}.isdisjoint(r['speaker'] for r in valid)


def test_epoch_losses_match_jax(fitted):
    _, (_, history), (_, jhistory) = fitted
    assert len(history.epoch_logs) == len(jhistory.epoch_logs) == 2
    for log, ref in zip(history.epoch_logs, jhistory.epoch_logs):
        for key in ('loss', 'val_loss'):
            out, expected = log['metrics'][key], ref['metrics'][key]
            assert abs(out - expected) <= 1e-4 * abs(expected), (key, out, expected)


def test_the_same_best_epoch(fitted):
    _, (clone, history), (jclone, jhistory) = fitted
    assert clone.ckpt_manager.best_epoch == jclone.ckpt_manager.best_epoch
    assert history.get_best('val_loss')[1] == jhistory.get_best('val_loss')[1]
    assert history.get_best('val_loss')[1] + 1 == clone.ckpt_manager.best_epoch
    best = clone.ckpt_manager.load(best = True, trees = ('params',))['params']
    stored = clone.ckpt_manager.load(clone.ckpt_manager.best_epoch, trees = ('params',))
    for a, b in zip(best['decoder']['attention_rnn'].values(),
                    stored['params']['decoder']['attention_rnn'].values()):
        np.testing.assert_array_equal(a, b)
