"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version, and run `tts()` end to end at the
full NVIDIA width of Tacotron-2 and WaveGlow with random weights.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   the card (nvidia-smi) and the kernels' build time;
  kernels  every ported kernel at the main path's shapes (one utterance and
           the batch of four): error against its plain version in float32
           and bfloat16, median time of the kernel and of the plain version
           (CUDA events), and the bound.  The WN block also at a length that
           is no multiple of any tile; the decoder steps deterministic and
           with dropout, with the attention window at a memory length that is
           no multiple of 64, and as two launches of 32 steps against one of
           64;
  e2e      `tts()` on one sentence (the one-launch path: fused decoder →
           vocoder → int16, no retry) and on a batch of four on both decoder
           routes: decode and vocode seconds, real-time factor, the kernels'
           launch counts; the fused decode against the plain decode at full
           width; and the vocoder's kernel path against its float32 chain on
           a short mel.
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


def wn_block_phase():
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


def decoder_steps_work(weights, B, S, K, itemsize):
    """(operations, bytes, weight bytes) of one launch of K decoder steps:
    every product of every step; each input read once and each output
    written once (state in and out, frames and alignments out)."""
    n_mel, P0 = weights['w0'].shape
    P1 = weights['w1'].shape[1]
    U, A = weights['q_w'].shape
    D = weights['proj_w'].shape[0] - U
    macs = (n_mel * P0 + P0 * P1 + (P1 + D + U) * 4 * U + U * A + 62 * A * S + A * S
            + S * D + (2 * U + D) * 4 * U + (U + D) * (n_mel + 1))
    matrices = sum(weights[k].numel() for k in
                   ('w0', 'w1', 'att_w', 'q_w', 'loc_w', 'dec_w', 'proj_w')) * itemsize
    biases = sum(weights[k].numel() for k in
                 ('b0', 'b1', 'att_b', 'v_w', 'dec_b', 'proj_b')) * 4
    inputs = B * S * (D + A) * itemsize + B * S * 4 + B * 4 + B * P0 * 4 + 8
    state = B * (n_mel * 4 + 2 * U * (itemsize + 4) + D * itemsize + 2 * S * 4 + 4)
    outputs = K * B * (n_mel + 1 + S) * 4
    return 2 * macs * B * K, matrices + biases + inputs + 2 * state + outputs, matrices + biases


def decoder_steps_phase(model):
    from text_to_speech_tpu_torch.ops.decoder_kernel import (
        PHASES, decoder_steps, decoder_steps_plain, init_decoder_state, pack_decoder_weights,
        phase_times_us)
    from text_to_speech_tpu_torch.weights import cast_tree

    arch, hp, K = model.arch, model.arch.hp, 64
    n_mel, U = hp.n_mel_channels, hp.attention_rnn_dim
    # token batches of the main path: one sentence, and four of unequal
    # length; S = 72 is no multiple of 64 and takes the attention window
    rng = np.random.default_rng(2)
    sentence = lambda n: rng.integers(1, hp.vocab_size, n)

    # packed here with the logical matrices, which the plain version reads
    # (the model keeps the kernel's layouts only)
    packed = {dtype: pack_decoder_weights(
        cast_tree(model.params['decoder'], dtype), n_mel = n_mel, dtype = dtype)
        for dtype in (torch.float32, torch.bfloat16)}

    def inputs(B, S, dtype):
        lengths = [S] if B == 1 else [S, S - 9, S - 23, S - 40][:B]
        tokens = np.zeros((B, S), np.int64)
        for i, n in enumerate(lengths):
            tokens[i, :n] = sentence(n)
        tokens = torch.from_numpy(tokens).cuda()
        params = cast_tree(model.params, dtype) if dtype != torch.float32 else model.params
        state = cast_tree(model.state, dtype) if dtype != torch.float32 else model.state
        with torch.no_grad():
            enc, enc_mask = arch.encode(params, state, tokens)
            mem, pm = arch.process_memory(params['decoder'], enc, enc_mask)
        args = (packed[dtype], mem.contiguous(), pm.contiguous(), enc_mask.float(),
                enc_mask.sum(dim = 1).to(torch.int32),
                torch.zeros((B, hp.prenet_sizes[0]), device = 'cuda'))
        fresh = lambda: init_decoder_state(B, S, mem.shape[-1], U, n_mel, dtype, 'cuda')
        return args, fresh

    seed = torch.tensor([20261016], dtype = torch.int64, device = 'cuda')
    # Tolerances, relative to the largest magnitude of each compared tensor
    # (frames and gates, alignments, and every state tensor).  float32: the
    # kernel and the plain version sum the same products in another order
    # and take expf and tanhf from another library; over 64 autoregressive
    # steps that stays near 1e-6 (measured on an H100: 3e-7), 1e-4 leaves
    # room and a wrong index misses it by orders of magnitude.  bfloat16: h
    # and ctx round to 8 bits of mantissa every step, so another float32
    # sum flips single roundings that the next
    # steps carry on: one rounding is up to 2^-7 = 7.8e-3 of a value
    # (measured 5.7e-3 on the state, 2.9e-3 on the frames); 2e-2 is 2.5
    # roundings.
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

    def rel_err(out, ref):
        out, ref = out.float(), ref.float()
        return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        for B, S, window in ((1, 64, False), (4, 64, False), (2, 72, True)):
            args, fresh = inputs(B, S, dtype)
            for deterministic in (True, False):
                kw = dict(n_steps = K, deterministic = deterministic, use_window = window,
                          win_len = 16, win_offset = 8, drop_rate = float(hp.prenet_drop_rate))
                st = fresh()
                steps, attn, _ = decoder_steps(* args, st, seed, ** kw)
                torch.cuda.synchronize()
                ref_st = fresh()
                ref_steps, ref_attn, _ = decoder_steps_plain(* args, ref_st, seed, ** kw)
                check(steps.shape == (K, B, n_mel + 1) and attn.shape == (K, B, S),
                      'decoder_steps output shape')
                check(bool(torch.isfinite(steps).all() and torch.isfinite(attn).all()),
                      'decoder_steps output not finite')
                err = float((steps - ref_steps).abs().max())
                rel = {'steps': rel_err(steps, ref_steps), 'attn': rel_err(attn, ref_attn)}
                rel.update({k: rel_err(st[k], ref_st[k]) for k in
                            ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum')})
                check(torch.equal(st['main'], ref_st['main']), 'decoder_steps argmax differs')
                case = {'dtype': name, 'B': B, 'S': S, 'K': K, 'window': window,
                        'dropout': not deterministic, 'max_abs_err': err,
                        'frame_scale': float(ref_steps[..., :n_mel].abs().max()),
                        'rel_err': rel, 'max_rel_err': max(rel.values()),
                        'tolerance_rel': tolerance[dtype]}
                key = '{}_B{}_S{}_{}'.format(name, B, S, 'dropout' if not deterministic else 'det')
                cases[key] = case
                check(case['max_rel_err'] <= tolerance[dtype],
                      'decoder_steps {}: relative errors {} > {}'.format(
                          key, rel, tolerance[dtype]))
                if not window and not deterministic:
                    # the main path's mode: dropout on.  Two launches of 32
                    # steps must equal one of 64 to the bit (same products,
                    # same order, the dropout keyed by the absolute step)
                    st = fresh()
                    half = dict(kw, n_steps = K // 2)
                    a = decoder_steps(* args, st, seed, ** half)[0]
                    b = decoder_steps(* args, st, seed, step0 = K // 2, ** half)[0]
                    check(torch.equal(torch.cat([a, b]), steps),
                          'decoder_steps {}: 2 x 32 steps differ from 64'.format(key))
                    flops, nbytes, weight_bytes = decoder_steps_work(
                        args[0], B, S, K, args[1].element_size())
                    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                    st = fresh()
                    kernel_ms = time_ms(lambda: decoder_steps(* args, st, seed, ** kw))
                    plain_ms = time_ms(lambda: decoder_steps_plain(* args, st, seed, ** kw),
                                       reps = 3, warmup = 1)
                    # where a step's time goes: the kernel's own clock stamps
                    stamps = torch.zeros((8 * K + 4,), dtype = torch.int64, device = 'cuda')
                    decoder_steps(* args, st, seed, stamps = stamps, ** kw)
                    torch.cuda.synchronize()
                    times = phase_times_us(stamps)
                    case['phase_us'] = {
                        kind: dict(zip(PHASES, spans.median(dim = 0).values.tolist()))
                        for kind, spans in times.items()}
                    case.update(
                        chunked_equal = True, kernel_ms = kernel_ms,
                        us_per_step = 1e3 * kernel_ms / K, plain_ms = plain_ms,
                        flops = flops, bytes = nbytes,
                        bound_ms = 1e3 * max(flops / peak, nbytes / PEAK_BYTES),
                        bound_by = 'operations' if flops / peak > nbytes / PEAK_BYTES
                        else 'bytes',
                        # no design can keep f32 weights on the chip: the
                        # steps are serial, and each streams every weight
                        serial_floor_ms = 1e3 * K * weight_bytes / PEAK_BYTES)
            del args, fresh
    emit({'phase': 'kernels', 'decoder_steps': cases,
          'shape': {'P': list(hp.prenet_sizes), 'U': U, 'D': hp.encoder_embedding_dim,
                    'A': hp.lsa_attention_dim, 'n_mel': n_mel},
          'library_ms': None,
          'library_note': 'no single PyTorch call computes K decoder steps'})
    return cases


SENTENCES = ['The quick brown fox jumps over the lazy dog.',
             'Printing, in the only sense with which we are concerned,',
             'differs from most if not from all the arts and crafts.',
             'It was invented in the fifteenth century.']


def e2e_phase(model, vocoder, setup_s):
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.models.tts.tacotron2 import pad_batch
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block

    wg_arch = vocoder.arch
    generator = torch.Generator(device = 'cuda').manual_seed(0)
    max_frames, vocoder_batch, chunk = 256, 8, 64
    # the random stop gate is biased off, so every run decodes max_frames
    # frames; the gates are opened wide so that this fixed length passes
    gates = dict(min_fpt_ratio = 0., max_fpt_ratio = 1e9)
    retries = []
    synthesize_chunks = model._synthesize_chunks
    model._synthesize_chunks = lambda * a, ** kw: \
        retries.append(1) or synthesize_chunks(* a, ** kw)

    runs = {}
    for name, texts, route in (
            ('one_sentence', SENTENCES[0], {}),
            ('batch_of_4', SENTENCES, dict(batch_size = 4, use_fused_decoder = True)),
            ('batch_of_4_plain_decoder', SENTENCES,
             dict(batch_size = 4, use_fused_decoder = False))):
        kw = dict(model = model, vocoder = vocoder, vocoder_batch = vocoder_batch,
                  generator = generator, ** gates, ** route)
        tts(texts, max_length = 64, ** kw)                              # warm-up
        torch.cuda.synchronize()
        fused_wn_block.launches = decoder_steps.launches = 0
        start = time.perf_counter()
        outputs = tts(texts, max_length = max_frames, ** kw)
        total_s = time.perf_counter() - start
        wn_launches, dec_launches = fused_wn_block.launches, decoder_steps.launches
        rows = sum(len(out['mel']) for out in outputs)
        vocoder_calls = -(-rows // vocoder_batch)
        check(wn_launches == wg_arch.hp.n_flows * vocoder_calls,
              '{}: {} wn_block launches for {} vocoder calls'.format(
                  name, wn_launches, vocoder_calls))
        fused = route.get('use_fused_decoder', True)
        check(dec_launches == (-(-max_frames // chunk) if fused else 0),
              '{}: {} decoder_steps launches'.format(name, dec_launches))
        check(not retries, '{}: the retry path was taken'.format(name))
        audio_s = 0.
        for out in outputs:
            frames = out['mel'][0].shape[0]
            check(frames == max_frames, 'decoded {} frames'.format(frames))
            check(out['audio'].shape == (frames * vocoder.upsample_rate,), 'audio length')
            check(bool(np.isfinite(out['audio']).all()), 'audio not finite')
            check(bool(np.isfinite(out['mel'][0]).all()), 'mel not finite')
            audio_s += out['time']
        if name == 'one_sentence':
            # the one-launch path: 16-bit PCM from the device, / 32767 on the host
            grid = outputs[0]['audio'].astype(np.float64) * 32767.
            check(float(np.abs(grid - np.round(grid)).max()) < 1e-2
                  and float(np.abs(outputs[0]['audio']).max()) <= 1.,
                  'one_sentence audio is not on the int16 grid')
            check(outputs[0]['attention'] == [None], 'attention fetched on the one-launch path')
        timings = model.last_timings
        runs[name] = {
            'texts': len(outputs), 'frames': max_frames, 'audio_s': audio_s,
            'decode_ms': 1e3 * timings['decode_s'], 'vocode_ms': 1e3 * timings['vocode_s'],
            'total_ms': 1e3 * total_s, 'rtf': audio_s / total_s,
            'wn_block_launches': wn_launches, 'decoder_steps_launches': dec_launches,
            'vocoder_calls': vocoder_calls,
        }
    model._synthesize_chunks = synthesize_chunks

    # the fused decode against the plain decode on the card: float32, no
    # dropout, full width, two sentences, 256 steps.  Tolerance 1e-4 of each
    # tensor's largest magnitude: both routes are float32, the kernel sums
    # in another order, and 256 autoregressive steps carry every difference
    # on (measured on an H100: under 1e-6); an indexing fault misses it by
    # orders of magnitude.  The gates sit near 0 (their bias is far
    # negative), so their scale is floored.
    tokens = pad_batch([model.encode_text(t) for t in SENTENCES[:2]],
                       pad_value = model.blank_token_idx)
    kw = dict(max_length = max_frames, deterministic = True, early_stopping = False)
    fused = model.compiled_infer(tokens, use_fused_decoder = True, ** kw)
    plain = model.compiled_infer(tokens, use_fused_decoder = False, ** kw)
    compared = ('mel', 'decoder_output', 'stop_tokens', 'attention_weights')
    routes = {name: float((getattr(fused, name) - getattr(plain, name)).abs().max())
              / max(float(getattr(plain, name).abs().max()), 1e-3) for name in compared}
    worst = max(routes.values())
    routes.update(lengths_equal = bool(torch.equal(fused.lengths, plain.lengths)),
                  tolerance_rel = 1e-4)
    check(routes['lengths_equal'] and worst <= 1e-4,
          'fused decode vs plain decode: {}'.format(routes))

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
          'fused_vs_plain_decode': routes,
          'vocoder_kernel_vs_f32': {'max_rel_err': err, 'snr_db': snr, 'tolerance_rel': 1e-2}})
    return runs


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py needs a CUDA device', file = sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from text_to_speech_tpu_torch.init import random_tts_models
    from text_to_speech_tpu_torch.ops import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip()
    start = time.perf_counter()
    _build.build_all(['wn_block', 'decoder_steps'])
    build_s = time.perf_counter() - start
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if 'registers' in line or 'spill' in line]
             for name, log in _build.build_logs.items()}
    emit({'phase': 'device', 'nvidia_smi': smi, 'build_s': build_s,
          'torch': torch.__version__, 'cuda': torch.version.cuda, 'ptxas': ptxas})

    start = time.perf_counter()
    # random weights at NVIDIA sizes (the `HParamsTacotron2` and
    # `HParamsWaveGlow` defaults), the stop gate biased off
    model, vocoder = random_tts_models('cuda', seed = 1)
    setup_s = time.perf_counter() - start

    wn_cases = wn_block_phase()
    dec_cases = decoder_steps_phase(model)
    runs = e2e_phase(model, vocoder, setup_s)

    wn_case = wn_cases['bfloat16_B1_T8192']
    dec_case = dec_cases['float32_B1_S64_dropout']         # what `tts(text)` runs
    summary = lambda case, ** entry: dict(
        entry, max_abs_err = case['max_abs_err'], ms = case['kernel_ms'],
        plain_ms = case['plain_ms'], bound_ms = case['bound_ms'],
        bound_by = case['bound_by'], library_ms = None)
    print(json.dumps({'kernels': [
        summary(wn_case, name = 'fused_wn_block', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = sum(r['wn_block_launches'] for r in runs.values())),
        summary(dec_case, name = 'decoder_steps', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = sum(r['decoder_steps_launches'] for r in runs.values())),
    ]}), flush = True)
    print(smi, flush = True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush = True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
