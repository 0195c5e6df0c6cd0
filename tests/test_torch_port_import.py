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
                 'runtimes.serving', 'runtimes.http_server', 'train.gan', 'nn.activations',
                 'models.transformers.generation_utils', 'models.transformers.families',
                 'models.transformers.heads', 'runtimes.llm_serving', 'text.tokens',
                 'parallel', 'parallel.collectives', 'parallel.pipeline', 'xp', 'compile',
                 'models.tts_export', 'models.describe'):
        assert 'text_to_speech_tpu_torch.' + name in names.split(), name


def test_spawned_ranks_load_no_jax():
    """A rank that `parallel.spawn` starts runs its function in a fresh
    interpreter: one torch thread, its rank of the gloo group, no JAX
    module."""
    out = _run('''
        import sys
        sys.path.insert(0, 'tests')
        from text_to_speech_tpu_torch import parallel
        import torch_port_mesh_workers as workers
        ranks = parallel.spawn(workers.spawned_child_modules, 2, backend = 'gloo',
                               device = 'cpu')
        assert [r['rank'] for r in ranks] == [0, 1], ranks
        assert all(r['world'] == 2 and r['threads'] == 1 for r in ranks), ranks
        assert all(r['modules'] == [] for r in ranks), ranks
        print('ok')
    ''')
    assert out.strip().endswith('ok')


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
        from text_to_speech_tpu_torch.models.transformers import (
            Transformer, from_hf_pretrained, generate)
        from text_to_speech_tpu_torch.models.transformers.families import EncoderDecoder
        from text_to_speech_tpu_torch.runtimes.llm_serving import (
            make_llm_engine, make_transformer_stepper)
        lm = Transformer(vocab_size = 8, dim = 8, n_layers = 1, n_heads = 2, ffn_dim = 8)
        raises(lambda: lm.init(0))
        raises(lambda: EncoderDecoder(lm, lm).init(0))
        raises(lambda: lm.init_caches(1, 4))
        params = lm.init(0, device = 'cpu')
        raises(lambda: generate(lm, params, np.ones((1, 2), np.int64), max_new_tokens = 2))
        raises(lambda: generate(lm, params, np.ones((1, 2), np.int64), method = 'beam'))
        raises(lambda: make_transformer_stepper(lm, params))
        raises(lambda: make_llm_engine(lm, params))
        raises(lambda: from_hf_pretrained(object(), family = 'gpt2'))
        assert generate(lm, params, np.ones((1, 2), np.int64), max_new_tokens = 2,
                        device = 'cpu').tokens.shape == (1, 4)
        assert default_device('cpu') == torch.device('cpu')
    ''')


def test_export_and_compile_modules_load_no_jax():
    """The export and compile slice (`xp`, `compile`, the `runtimes`
    registry, the published-layout exporters, `describe`) loads no JAX
    module, and its entry points run on the card unless given the CPU."""
    _run('''
        import sys, tempfile
        import numpy as np
        import torch
        from text_to_speech_tpu_torch import compile, runtimes, xp
        from text_to_speech_tpu_torch.models import describe, tts_export
        assert {'torch', 'export', 'aot', 'hf'} <= set(runtimes.list_runtimes())
        assert hasattr(torch.ops.tts_torch, 'wn_block')
        path = tempfile.mkdtemp() + '/f.pt2'
        runtimes.ExportRuntime.export_function(lambda x: x * 2., (torch.ones(2),), path)
        assert torch.equal(runtimes.build_runtime('export', path, device = 'cpu')(
            torch.ones(2)), torch.full((2,), 2.))
        for fn in (lambda: xp.convert_to_tensor(np.ones(2)),
                   lambda: runtimes.build_runtime('export', path),
                   lambda: compile.TensorSpec().cast(np.ones(2))):
            try:
                fn()
            except RuntimeError as e:
                assert 'device' in str(e), e
            else:
                raise AssertionError('no error')
        assert describe.count_params({'a': torch.ones(2, 3)}) == 6
        assert tts_export.export_vocos.__module__.endswith('tts_export')
        assert 'jax' not in sys.modules, 'jax imported'
        assert not [m for m in sys.modules if m == 'text_to_speech_tpu'
                    or m.startswith('text_to_speech_tpu.')]
        print('ok')
    ''')
