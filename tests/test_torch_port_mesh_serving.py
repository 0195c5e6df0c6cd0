"""Mesh serving: the Tacotron-2, VITS and LLM steppers and `serve` across
the ranks of a `parallel.Mesh` (`runtimes.serving.mesh_stepper`), against
the JAX package and the port's one-process steppers on the CPU.

One job of two gloo ranks on ``{'dp': 2}`` (`parallel.spawn`, one module
fixture; `torch_port_mesh_workers.serving_cases`): the first rank runs
`ContinuousServingEngine` (max batch 4) and every other follows, while the
test process computes the references.  The models are
``tests/test_torch_port_serving.py``'s tiny ones: the JAX Tacotron-2 task
model saved and loaded by name, its gate biased off (every request runs to
``max_steps`` 8) and its prenet deterministic; a WaveGlow with ``sigma=0``
streams the audio.

  - the Tacotron-2 stepper, three requests with streamed audio: both ranks
    own rows; each request's mel within 1e-4 of the JAX package's one-shot
    `infer` (``tests/test_serving.py:1281-1282``) and of the one-process
    stepper, its streamed parts concatenating to its ``audio``, the audio
    within 1e-5 of the one-process stream;
  - a single request: the other rank holds no rows and runs no chunk;
  - the VITS stepper at noise 0: each stream within 1e-6 of the
    one-process stepper's;
  - the LLM stepper, greedy, 2 slots a rank (``max_batch`` 4 over 2
    shards): tokens equal to the JAX stepper's (``tests/
    test_llm_serving.py:253``) and to the one-process stepper's;
  - `serve(mesh=)`: a POST /tts answered by the first rank's server, the
    follower returning when it stops;
  - a follower that raises: every request fails, the controller's engine
    stops, and the follower leaves its loop with `MeshStepperError`;
  - no rank loads JAX; ``_bucket`` pads a batch to a multiple of the data
    shards that is not a power of two (``tests/test_vits.py:1112``).
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
import torch_port_mesh_workers as workers

import jax
import jax.numpy as jnp
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.models.transformers import Transformer as JaxTransformer
from text_to_speech_tpu.models.tts import Tacotron2 as JaxTacotron2
from text_to_speech_tpu.runtimes.llm_serving import make_transformer_stepper as jax_llm_stepper
from text_to_speech_tpu.runtimes.serving import ContinuousServingEngine as JaxEngine
from text_to_speech_tpu_torch import parallel
from text_to_speech_tpu_torch.init import init_waveglow
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.transformers import Transformer
from text_to_speech_tpu_torch.models.tts import VITS, WaveGlow
from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
from text_to_speech_tpu_torch.ops.stft import TacotronSTFT
from text_to_speech_tpu_torch.runtimes.llm_serving import make_transformer_stepper
from text_to_speech_tpu_torch.runtimes.serving import (
    ContinuousServingEngine, _bucket, make_tacotron_stepper, make_vits_stepper)
from text_to_speech_tpu_torch.weights import transformer_from_jax

TACOTRON = dict(encoder_embedding_dim = 8, encoder_n_conv = 1, encoder_kernel_size = 3,
                prenet_sizes = (4, 4), lsa_attention_dim = 4, lsa_attention_filters = 2,
                lsa_attention_kernel_size = 5, attention_rnn_dim = 8, decoder_rnn_dim = 8,
                postnet_n_conv = 2, postnet_filters = 4, postnet_kernel_size = 3,
                max_decoder_steps = 16)
WAVEGLOW = dict(n_flows = 2, wn_layers = 2, wn_channels = 16, upsample_width = 64,
                upsample_stride = 16, sigma = 0.)
VITS_HP = dict(inter_channels = 8, hidden_channels = 16, filter_channels = 32, n_heads = 2,
               n_text_layers = 1, posterior_layers = 2, flow_layers = 2, flow_wn_layers = 2,
               duration_filters = 16, upsample_rates = (4, 2), upsample_kernel_sizes = (8, 4),
               upsample_initial_channel = 16, resblock_kernel_sizes = (3,),
               resblock_dilation_sizes = ((1, 2),), max_frames = 64, max_position = 512)
LLM = dict(vocab_size = 64, dim = 32, n_layers = 2, n_heads = 2, ffn_dim = 64, max_position = 128,
           norm_first = True, positional = 'learned')
TEXTS = ['hello world this is a long one', 'test', 'third one']
TACO_KW = dict(chunk = 4, token_multiple = 8, max_steps = 8, deterministic = True)


@pytest.fixture(scope = 'module')
def job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('mesh_models'))
    old_root = saving._PRETRAINED_ROOT
    saving._PRETRAINED_ROOT = root
    reset_instances()
    try:
        yield _job(root)
    finally:
        saving._PRETRAINED_ROOT = old_root
        reset_instances()


def _job(root):
    jtaco = JaxTacotron2(lang = 'en', name = 'mesh_taco', ** TACOTRON)
    jtaco.save()
    arch = WaveGlowArch(** WAVEGLOW)
    wg_params = init_waveglow(arch.hp, arch.flow_channels, seed = 0)
    mel_fn = TacotronSTFT(sampling_rate = 8000, hop_length = 8, filter_length = 16,
                          win_length = 16)
    VITS.create('en', name = 'mesh_vits', mel_fn = mel_fn, root = root, device = 'cpu',
                ** VITS_HP)
    jlm = JaxTransformer(** LLM)
    jlm_params = jlm.init(jax.random.PRNGKey(0))
    lm_params = transformer_from_jax(jax.tree_util.tree_map(np.asarray, jlm_params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n) for n in (4, 9, 1)]
    case = {'root': root, 'tacotron': 'mesh_taco', 'vits': 'mesh_vits', 'texts': TEXTS,
            'waveglow': {'config': WAVEGLOW, 'params': wg_params},
            'llm': {'config': LLM, 'params': lm_params, 'prompts': prompts}}
    box = {}

    def run():
        try:
            box['ranks'] = parallel.spawn(workers.serving_cases, 2, backend = 'gloo',
                                          device = 'cpu', args = (case,))
        except BaseException as e:
            box['error'] = e

    thread = threading.Thread(target = run)
    thread.start()
    refs = {}
    try:
        refs['infer'] = []
        for text in TEXTS:
            tokens = np.asarray(jtaco.encode_text(text))[None, :]
            s = -(-tokens.shape[1] // 8) * 8
            tokens = np.pad(tokens, ((0, 0), (0, s - tokens.shape[1])),
                            constant_values = jtaco.blank_token_idx)
            out = jtaco.arch.infer(jtaco.params, jtaco.state, jnp.asarray(tokens),
                                   deterministic = True, early_stopping = False, max_length = 8)
            refs['infer'].append(np.asarray(out.mel)[0])
        taco = get_pretrained('mesh_taco', root = root, device = 'cpu')
        taco.arch.hp.gate_threshold = 1.1
        vocoder = WaveGlow.from_jax(wg_params, name = 'mesh_wg_ref', device = 'cpu', root = root,
                                    ** WAVEGLOW)
        with ContinuousServingEngine(* make_tacotron_stepper(
                taco, vocoder = vocoder, stream_audio = True, stream_context = 2,
                stream_lookahead = 1, ** TACO_KW), max_batch_size = 4) as engine:
            refs['tacotron'] = workers._drive(engine, TEXTS)
        vits = get_pretrained('mesh_vits', root = root, device = 'cpu')
        with ContinuousServingEngine(* make_vits_stepper(
                vits, window = 16, context = 8, token_multiple = 8, noise_scale = 0.,
                noise_scale_w = 0., min_duration = 2), max_batch_size = 4) as engine:
            refs['vits'] = workers._drive(engine, TEXTS)
        kw = dict(max_batch = 4, max_length = 32, chunk = 4, prompt_multiple = 8,
                  max_new_tokens = 6)
        with ContinuousServingEngine(* make_transformer_stepper(
                Transformer(** LLM), lm_params, device = 'cpu', ** kw),
                max_batch_size = 4) as engine:
            refs['llm'] = [r.result.get(timeout = 120)['tokens']
                           for r in [engine.submit(p) for p in prompts]]
        with JaxEngine(* jax_llm_stepper(jlm, jlm_params, ** kw), max_batch_size = 4) as engine:
            refs['jax_llm'] = [r.result.get(timeout = 120)['tokens']
                               for r in [engine.submit(p) for p in prompts]]
    finally:
        thread.join()
    if 'error' in box:
        raise box['error']
    return box['ranks'], refs


def test_bucket_pads_to_a_multiple_of_the_data_shards():
    assert [_bucket(n, 3) for n in (1, 3, 4, 6, 7)] == [3, 3, 6, 6, 12]
    assert [_bucket(n, 1) for n in (1, 3, 5)] == [1, 4, 8]


def test_no_rank_loads_jax(job):
    ranks, _ = job
    assert [r['rank'] for r in ranks] == [0, 1]
    assert all(r['modules'] == [] for r in ranks)


def test_tacotron_mesh_stepper_matches_infer_and_one_process(job):
    ranks, refs = job
    (results, parts), ref_parts = ranks[0]['tacotron'], refs['tacotron'][1]
    assert ranks[1]['tacotron'] is None                      # the follower's
    assert all(r['tacotron_rows']['rows_stepped'] > 0 for r in ranks)
    assert sum(r['tacotron_rows']['admitted'] for r in ranks) == len(TEXTS)
    for out, ref_out, streamed, ref_streamed, mel in zip(results, refs['tacotron'][0], parts,
                                                          ref_parts, refs['infer']):
        assert out['steps'] == 8
        np.testing.assert_allclose(out['mel'], mel, atol = 1e-4, rtol = 0)
        np.testing.assert_allclose(out['mel'], ref_out['mel'], atol = 1e-4, rtol = 0)
        assert len(streamed) == len(ref_streamed) and out['audio'].shape[0] > 0
        np.testing.assert_array_equal(np.concatenate(streamed), out['audio'])
        np.testing.assert_allclose(out['audio'], ref_out['audio'], atol = 1e-5, rtol = 0)


def test_a_rank_without_rows_skips_the_chunk(job):
    ranks, refs = job
    (results, _) = ranks[0]['single']
    counts = [r['single_rows'] for r in ranks]
    assert [c['admitted'] for c in counts] == [1, 0]
    assert counts[1]['chunks'] == 0 and counts[0]['chunks'] > 0
    np.testing.assert_allclose(results[0]['mel'], refs['infer'][0], atol = 1e-4, rtol = 0)


def test_vits_mesh_stepper_matches_one_process(job):
    ranks, refs = job
    results, parts = ranks[0]['vits']
    assert all(r['vits_rows']['rows_stepped'] > 0 for r in ranks)
    for out, ref_out, streamed in zip(results, refs['vits'][0], parts):
        assert out['frames'] == ref_out['frames']
        np.testing.assert_allclose(out['audio'], ref_out['audio'], atol = 1e-6, rtol = 0)
        np.testing.assert_array_equal(np.concatenate(streamed), out['audio'])


def test_llm_mesh_stepper_tokens_equal(job):
    ranks, refs = job
    assert ranks[0]['llm'] == refs['llm'] == refs['jax_llm']
    assert all(len(tokens) == 6 for tokens in refs['llm'])
    assert [r['llm_slots'] for r in ranks] == [2, 2]           # max_batch / n_data
    assert all(r['llm_rows']['admitted'] > 0 for r in ranks)


def test_serve_on_a_mesh_answers_over_http(job):
    ranks, _ = job
    status, content_type, size = ranks[0]['http']
    assert status == 200 and 'audio' in content_type and size > 44
    assert ranks[1]['http'] == 'followed'


def test_a_follower_failure_stops_the_engine(job):
    ranks, _ = job
    failure = ranks[0]['failure']
    assert failure['errors'] == ['MeshStepperError'] * 3
    assert not failure['running']
    assert ranks[1]['failure'].startswith('follower raised: mesh stepper operation')
