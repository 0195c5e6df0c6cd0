"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version, and run `tts()` end to end at the
full NVIDIA width of Tacotron-2 and WaveGlow with random weights.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   the card (nvidia-smi) and the kernels' build time;
  kernels  every ported kernel at the main path's shapes (one utterance and
           the batch of four): error against its plain version in float32
           and bfloat16 (a length that is no multiple of any tile covers
           ragged edges), median time of the kernel and of the plain version
           (CUDA events), and the bound;
  e2e      `tts()` on one sentence and on a batch of four: decode and
           vocode seconds, real-time factor, the kernels' launch counts, and
           the vocoder's kernel path against its float32 chain on a short
           mel.
Then the kernel summary, the card's name and power limit, and the result.
Any failure raises: the script then exits non-zero without a result line.
It needs a CUDA device and imports neither JAX nor the JAX package.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def emit(record):
    print(json.dumps(record), flush = True)


def check(condition, message):
    if not condition:
        raise AssertionError(message)


def time_ms(fn, *, reps = 7, warmup = 2):
    """Median of `reps` timed calls (CUDA events), each after evicting the
    L2 cache, as the main path meets every flow's weights cold."""
    flush = torch.empty(256 * 2 ** 20, dtype = torch.uint8, device = 'cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing = True)
        end = torch.cuda.Event(enable_timing = True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wn_block_work(B, T, C, S, L, itemsize):
    """(operations, bytes) of one WN block call: every product, each input
    read once and the output written once."""
    flops = 2 * B * T * ((3 * C + S) * 2 * C * L + C * 2 * C * (L - 1) + C * C)
    weights = (L * (3 * C + S) * 2 * C + (L - 1) * C * 2 * C + C * C) * itemsize
    biases = (L * 2 * C + (L - 1) * 2 * C + C) * 4
    activations = B * T * (C + S + C) * itemsize
    return flops, weights + biases + activations


def kernels_phase():
    from text_to_speech_tpu_torch.ops.wn_block import (
        fused_wn_block, pack_wn_weights, wn_block_plain)

    C, L, S = 512, 8, 640
    rng = np.random.default_rng(0)

    def inputs(B, T, dtype):
        f = lambda * shape, scale = 1.: torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
        packed = pack_wn_weights(
            f(L, S, 2 * C, scale = S ** -0.5), f(L, 2 * C, scale = 0.1),
            f(L, 3, C, 2 * C, scale = (3 * C) ** -0.5), f(L, 2 * C, scale = 0.1),
            f(L - 1, C, 2 * C, scale = C ** -0.5), f(L - 1, 2 * C, scale = 0.1),
            f(C, C, scale = C ** -0.5), f(C, scale = 0.1), dtype = dtype)
        args = (f(B, T, C).to(dtype), f(B, T, S).to(dtype), packed['w_in_cond'],
                packed['b_in_cond'], packed['w_rs'], packed['b_rs'],
                packed['w_rs_last'], packed['b_rs_last'])
        return args

    # (dtype, error bound relative to the output's largest magnitude): f32
    # FMA tiles against f32 cuBLAS differ in summation order only; bf16
    # rounds gated activations and the residual stream every layer, where
    # another f32 summation order can flip a bf16 rounding.  Shapes: one
    # 256-frame utterance (B=1, T=8192), a ragged length, and the batch of
    # four (B=4: rows of one utterance must not tap the next).
    cases = {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).split('.')[-1]
        for B, T in ((1, 8192), (1, 8000), (4, 8192)):
            args = inputs(B, T, dtype)
            out = fused_wn_block(* args)
            torch.cuda.synchronize()
            ref = wn_block_plain(* args)
            check(out.shape == (B, T, C) and out.dtype == dtype, 'wn_block output shape')
            check(bool(torch.isfinite(out.float()).all()), 'wn_block output not finite')
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            case = {'dtype': name, 'B': B, 'T': T, 'max_abs_err': err, 'max_rel_err': err / scale,
                    'tolerance_rel': rel_tol}
            if T == 8192:
                flops, nbytes = wn_block_work(B, T, C, S, L, args[0].element_size())
                peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                case.update(
                    kernel_ms = time_ms(lambda: fused_wn_block(* args)),
                    plain_ms = time_ms(lambda: wn_block_plain(* args)),
                    flops = flops, bytes = nbytes,
                    bound_ms = 1e3 * max(flops / peak, nbytes / PEAK_BYTES),
                    bound_by = 'operations' if flops / peak > nbytes / PEAK_BYTES
                    else 'bytes')
            cases['{}_B{}_T{}'.format(name, B, T)] = case
            check(err <= rel_tol * scale,
                  'wn_block {} B={} T={}: max abs err {} > {} x {}'.format(
                      name, B, T, err, rel_tol, scale))
            del args, out, ref
    emit({'phase': 'kernels', 'fused_wn_block': cases,
          'shape': {'C': C, 'S': S, 'L': L},
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the WN block'})
    return cases


def e2e_phase():
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import random_tts_models
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block

    start = time.perf_counter()
    # random weights at NVIDIA sizes (the `HParamsTacotron2` and
    # `HParamsWaveGlow` defaults); the stop gate is biased off, so every run
    # decodes max_frames frames
    model, vocoder = random_tts_models('cuda', seed = 1)
    wg_arch = vocoder.arch
    setup_s = time.perf_counter() - start
    generator = torch.Generator(device = 'cuda').manual_seed(0)

    max_frames, vocoder_batch = 256, 8
    runs = {}
    for name, texts in (
            ('one_sentence', ['The quick brown fox jumps over the lazy dog.']),
            ('batch_of_4', ['Printing, in the only sense with which we are concerned,',
                            'differs from most if not from all the arts and crafts.',
                            'It was invented in the fifteenth century.',
                            'The earliest books were printed in Germany.'])):
        tts(texts[:1], model = model, vocoder = vocoder, max_length = 64,
            batch_size = len(texts), vocoder_batch = vocoder_batch,
            generator = generator)                                    # warm-up
        torch.cuda.synchronize()
        fused_wn_block.launches = 0
        start = time.perf_counter()
        outputs = tts(texts, model = model, vocoder = vocoder, max_length = max_frames,
                      batch_size = len(texts), vocoder_batch = vocoder_batch,
                      generator = generator)
        total_s = time.perf_counter() - start
        launches = fused_wn_block.launches
        # the decode batch (every sentence of every text) is vocoded in
        # chunks of vocoder_batch rows
        rows = sum(len(out['mel']) for out in outputs)
        vocoder_calls = -(-rows // vocoder_batch)
        check(launches == wg_arch.hp.n_flows * vocoder_calls,
              '{}: {} wn_block launches for {} vocoder calls'.format(
                  name, launches, vocoder_calls))
        audio_s = 0.
        for out in outputs:
            frames = out['mel'][0].shape[0]
            check(frames == max_frames, 'decoded {} frames'.format(frames))
            check(out['audio'].shape == (frames * vocoder.upsample_rate,), 'audio length')
            check(bool(np.isfinite(out['audio']).all()), 'audio not finite')
            audio_s += out['time']
        timings = model.last_timings
        runs[name] = {
            'texts': len(texts), 'frames': max_frames, 'audio_s': audio_s,
            'decode_ms': 1e3 * timings['decode_s'], 'vocode_ms': 1e3 * timings['vocode_s'],
            'total_ms': 1e3 * total_s, 'rtf': audio_s / total_s,
            'wn_block_launches': launches, 'vocoder_calls': vocoder_calls,
        }

    # the vocoder's kernel path against its float32 chain on a short mel.
    # Tolerance 1e-2 of the waveform's largest magnitude: bf16 buffers
    # (8-bit mantissa) through 12 flows measured 1.3e-3 with these seeds
    # on an H100; 1e-2 leaves room for another summation order, and a
    # wrong tap or row would miss it by orders of magnitude.
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, wg_arch.hp.n_mel_channels)).astype(np.float32) - 5.).to('cuda')
    lg = 16 * wg_arch.hp.upsample_stride // wg_arch.hp.n_group
    with torch.no_grad():
        z = torch.randn((1, lg, wg_arch.hp.n_group), generator = generator, device = 'cuda')
        fast = wg_arch.infer(vocoder._serving_params(True), mel, z = z, use_kernel = True)
        plain = wg_arch.infer(vocoder.params, mel, z = z, use_kernel = False)
    err = float((fast - plain).abs().max()) / float(plain.abs().max())
    snr = 10 * float(torch.log10((plain ** 2).mean() / ((fast - plain) ** 2).mean()))
    check(err < 1e-2, 'vocoder kernel path vs f32 chain: rel err {}'.format(err))
    emit({'phase': 'e2e', 'setup_s': setup_s, 'runs': runs,
          'vocoder_kernel_vs_f32': {'max_rel_err': err, 'snr_db': snr, 'tolerance_rel': 1e-2}})
    return runs


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py needs a CUDA device', file = sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from text_to_speech_tpu_torch.ops import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip()
    start = time.perf_counter()
    _build.build_all(['wn_block'])
    build_s = time.perf_counter() - start
    ptxas = [line.strip() for log in _build.build_logs.values()
             for line in log.splitlines() if 'registers' in line or 'spill' in line]
    emit({'phase': 'device', 'nvidia_smi': smi, 'build_s': build_s,
          'torch': torch.__version__, 'cuda': torch.version.cuda, 'ptxas': ptxas})

    cases = kernels_phase()
    runs = e2e_phase()

    main_case = cases['bfloat16_B1_T8192']
    print(json.dumps({'kernels': [{
        'name': 'fused_wn_block',
        'route': 'cuda',
        'source': 'text_to_speech_tpu_torch/csrc/wn_block.cu',
        'replaces': 'text_to_speech_tpu/ops/pallas_kernels.py:277',
        'launches': sum(r['wn_block_launches'] for r in runs.values()),
        'max_abs_err': main_case['max_abs_err'],
        'ms': main_case['kernel_ms'],
        'plain_ms': main_case['plain_ms'],
        'bound_ms': main_case['bound_ms'],
        'bound_by': main_case['bound_by'],
        'library_ms': None,
    }]}), flush = True)
    print(smi, flush = True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush = True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
