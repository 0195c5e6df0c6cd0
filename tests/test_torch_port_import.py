"""The PyTorch port imports without JAX, and its entry points refuse to run
without a device when no GPU is present.

Both checks run in a subprocess: this suite's conftest imports jax into the
test process itself."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES = '')
    proc = subprocess.run([sys.executable, '-c', textwrap.dedent(code)], cwd = REPO,
                          env = env, capture_output = True, text = True, timeout = 120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_port_imports_without_jax():
    out = _run('''
        import importlib, pkgutil, sys
        import text_to_speech_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
        for name in names:
            importlib.import_module(name)
        assert 'jax' not in sys.modules, 'jax imported'
        leaked = [m for m in sys.modules if m == 'text_to_speech_tpu'
                  or m.startswith('text_to_speech_tpu.')]
        assert not leaked, leaked
        print(len(names))
        print(' '.join(names))
    ''')
    # every module of the slices was imported, the training slices' too
    count, names = out.split('\n')[-3:-1]
    assert int(count) >= 30
    for name in ('ops.wn_layer', 'ops.stft', 'ops.audio_io', 'train.trainer',
                 'train.optimizers', 'train.losses', 'train.precision', 'train.datasets',
                 'train.history', 'train.checkpoint', 'ops.matmul_rate', 'loggers',
                 'loggers.time_logging', 'loggers.handlers', 'utils.stream', 'utils.callbacks',
                 'utils.file_utils', 'utils.generic_utils', 'ops.audio_stream',
                 'ops.audio_processing', 'models.base_model', 'models.encoder_arch',
                 'models.encoder.speaker_encoder', 'models.base_audio_model',
                 'models.tts.sv2tts_tacotron2', 'models.tts.speaker_embedding_mixin',
                 'utils.embeddings', 'utils.distances', 'models.tts_checkpoints',
                 'models.fastspeech2_arch', 'models.tts.fastspeech2', 'models.transformers',
                 'models.transformers.attention', 'models.transformers.transformer_arch',
                 'native', 'native.data_loader', 'models.weights_converter', 'train.metrics',
                 'train.loader', 'train.audio_datasets', 'nn.flows', 'models.registry',
                 'models.hifigan_arch', 'models.vocos_arch', 'models.vits_arch',
                 'models.tts.hifigan', 'models.tts.vocos', 'models.tts.vits',
                 'models.tts.sv2tts_vits', 'native.scheduler', 'runtimes',
                 'runtimes.serving', 'runtimes.http_server', 'train.gan'):
        assert 'text_to_speech_tpu_torch.' + name in names.split(), name


def test_native_build_imports_no_jax():
    """Building and loading the native libraries, a decode on the pool and the
    serving scheduler load no JAX module."""
    _run('''
        import sys
        import numpy as np
        from text_to_speech_tpu_torch import native
        from text_to_speech_tpu_torch.native import data_loader, scheduler
        assert native.available() and data_loader.available() and scheduler.available()
        assert len(native.resample(np.zeros(160, np.float32), 16000, 22050)) == 220
        sched = scheduler.RequestScheduler()
        assert sched.native and sched.collect(2, 0.1, 0.) == []
        assert [sched.submit(p) for p in (0, 3)] == [0, 1] and sched.collect_nowait(4) == [1, 0]
        assert 'jax' not in sys.modules
        assert not [m for m in sys.modules if m.startswith('text_to_speech_tpu.')]
    ''')


def test_entry_points_raise_without_device():
    _run('''
        import numpy as np
        import torch
        assert not torch.cuda.is_available()
        from text_to_speech_tpu_torch import default_device, tts
        from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
        from text_to_speech_tpu_torch.text import default_english_tokenizer

        def raises(fn):
            try:
                fn()
            except RuntimeError as e:
                assert 'device' in str(e), e
            else:
                raise AssertionError('no error')

        raises(default_device)
        raises(lambda: tts('hello', model = 'overfit_demo'))
        raises(lambda: Tacotron2({}, {}, tokenizer = default_english_tokenizer()))
        raises(lambda: WaveGlow({}))
        from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
        from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2
        raises(lambda: SpeakerEncoder({}, {}))
        raises(lambda: SV2TTSTacotron2({}, {}, tokenizer = default_english_tokenizer()))
        from text_to_speech_tpu_torch.models.tts import FastSpeech2
        from text_to_speech_tpu_torch.init import (
            nvidia_tacotron2_state_dict, nvidia_waveglow_state_dict)
        raises(lambda: FastSpeech2({}, {}, tokenizer = default_english_tokenizer()))
        raises(lambda: Tacotron2.from_nvidia_pretrained(nvidia_tacotron2_state_dict(
            embedding_dim = 8, prenet_dim = 8, attention_rnn_dim = 8, decoder_rnn_dim = 8,
            attention_dim = 8, location_filters = 2, postnet_filters = 8), root = '/nonexistent'))
        raises(lambda: WaveGlow.from_nvidia_pretrained(nvidia_waveglow_state_dict(
            n_flows = 2, wn_layers = 2, wn_channels = 8), root = '/nonexistent'))
        from text_to_speech_tpu_torch.models.tts import HiFiGAN, SV2TTSVITS, VITS, Vocos
        from text_to_speech_tpu_torch.init import (
            hifigan_state_dict, vits_state_dict, vocos_state_dict)
        raises(lambda: HiFiGAN({}))
        raises(lambda: Vocos({}))
        raises(lambda: VITS({}, tokenizer = default_english_tokenizer()))
        raises(lambda: SV2TTSVITS({}, tokenizer = default_english_tokenizer()))
        raises(lambda: HiFiGAN.from_torch_pretrained(hifigan_state_dict(
            upsample_initial_channel = 8, resblock_kernel_sizes = (3,),
            resblock_dilation_sizes = ((1,),)), root = '/nonexistent'))
        raises(lambda: Vocos.from_torch_pretrained(vocos_state_dict(
            dim = 8, intermediate_dim = 8, n_layers = 1), root = '/nonexistent'))
        raises(lambda: VITS.from_torch_pretrained(vits_state_dict(
            inter_channels = 4, hidden_channels = 8, filter_channels = 8, n_layers = 1,
            posterior_layers = 1, flow_layers = 1, flow_wn_layers = 1, sdp_n_flows = 1,
            sdp_dds_layers = 1, upsample_initial_channel = 8, resblock_kernel_sizes = (3,),
            resblock_dilation_sizes = ((1,),)), root = '/nonexistent'))
        from text_to_speech_tpu_torch.train.trainer import fit
        vocoder = WaveGlow({}, device = 'cpu')
        raises(lambda: fit(vocoder, []))
        raises(lambda: vocoder.fit([]))
        from text_to_speech_tpu_torch.devices import get_memory_stats
        from text_to_speech_tpu_torch.ops.matmul_rate import main
        raises(get_memory_stats)
        raises(main)
        assert default_device('cpu') == torch.device('cpu')
    ''')
