"""K3 (`decoder_steps`) alone on the GPU, at NVIDIA width.

Random decoder weights from a numpy seed (U=1024, D=512, P=256, A=128,
n_mel=80, each matrix scaled by 1/sqrt(fan-in)), a random encoder memory with
unequal row lengths.  For every mode (float32, bfloat16, the int8 LSTM mode)
and shape it prints one JSON line: the kernel against `decoder_steps_plain`
over 8 deterministic steps (largest error relative to each compared tensor's
scale, argmax equal), the launch's shared-memory plan (`kernel_plan`: bytes
resident per block, bytes streamed per step), the time of a 64-step launch
with dropout (median of 7 CUDA-event timings after 2 warm-ups, the L2 cache
evicted before each), and the median microseconds per step of each phase
from the kernel's clock stamps (`phase_times_us`).  First the build's ptxas
registers and spills of every instantiation, last the card's name and power
limit.

    python3 benchmarks/torch_port_decoder_steps.py [--shapes 1x64,4x64,1x256]
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from text_to_speech_tpu_torch.ops import _build                       # noqa: E402
from text_to_speech_tpu_torch.ops import decoder_kernel as dk         # noqa: E402

N_MEL, P, U, D, A = 80, 256, 1024, 512, 128


def weights(dtype, device):
    rng = np.random.default_rng(7)
    mat = lambda * shape: torch.from_numpy(
        (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)).to(device, dtype)
    vec = lambda n, scale = 0.1: torch.from_numpy(
        (scale * rng.standard_normal(n)).astype(np.float32)).to(device)
    return {'w0': mat(N_MEL, P), 'b0': vec(P), 'w1': mat(P, P), 'b1': vec(P),
            'att_w': mat(P + D + U, 4 * U), 'att_b': vec(4 * U), 'q_w': mat(U, A),
            'loc_w': mat(2 * dk.LOC_KERNEL, A), 'v_w': vec(A, 1.),
            'dec_w': mat(2 * U + D, 4 * U), 'dec_b': vec(4 * U),
            'proj_w': mat(U + D, N_MEL + 1), 'proj_b': vec(N_MEL + 1)}


def inputs(dtype, device, B, S):
    rng = np.random.default_rng(11 + B + S)
    lengths = [S - 7 * b for b in range(B)]
    mask = np.zeros((B, S), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.
    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(device)
    mem = t(rng.standard_normal((B, S, D)) * mask[..., None]).to(dtype)
    pm = t(0.5 * rng.standard_normal((B, S, A))).to(dtype)
    return (mem, pm, t(mask), torch.tensor(lengths, dtype = torch.int32, device = device),
            torch.zeros((B, P), device = device))


def time_ms(fn, reps = 7, warmup = 2):
    flush = torch.empty(256 * 2 ** 20, dtype = torch.uint8, device = 'cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing = True), torch.cuda.Event(enable_timing = True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas():
    """{(dtype, rows, int8): {'registers', 'spill_bytes'}} of the build."""
    out, kernel = {}, None
    for line in _build.build_logs.get('decoder_steps', '').splitlines():
        found = re.search(r'decoder_steps_kernelI(\w+?)Li(\d)ELb(\d)', line)
        if found:
            kernel = '{}_B{}{}'.format('bf16' if 'bfloat16' in found.group(1) else 'f32',
                                       found.group(2), '_int8' if found.group(3) == '1' else '')
            out[kernel] = {}
        elif kernel is not None:
            spill = re.search(r'(\d+) bytes spill stores', line)
            used = re.search(r'Used (\d+) registers', line)
            if spill: out[kernel]['spill_bytes'] = int(spill.group(1))
            if used: out[kernel]['registers'] = int(used.group(1))
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--shapes', default = '1x64,4x64,1x256')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_port_decoder_steps.py needs a CUDA device', file = sys.stderr)
        return 1
    _build.build_all(['decoder_steps'])
    print(json.dumps({'ptxas': ptxas()}), flush = True)
    shapes = [tuple(int(v) for v in s.split('x')) for s in args.shapes.split(',')]
    seed = torch.tensor([5], dtype = torch.int64, device = 'cuda')
    K = 64
    for mode in ('float32', 'bfloat16', 'int8_lstm'):
        dtype = torch.bfloat16 if mode == 'bfloat16' else torch.float32
        w = weights(dtype, 'cuda')
        if mode == 'int8_lstm':
            w = dk.quantize_lstm_weights(w)
        for B, S in shapes:
            args_ = inputs(dtype, 'cuda', B, S)
            state = lambda: dk.init_decoder_state(B, S, D, U, N_MEL, dtype, 'cuda')
            det = dict(n_steps = 8, deterministic = True)
            out = dk.decoder_steps(w, * args_, state(), seed, ** det)
            ref = dk.decoder_steps_plain(w, * args_, state(), seed, ** det)
            keys = ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum')
            err = max([dk._rel_err(out[0], ref[0]), dk._rel_err(out[1], ref[1])]
                      + [dk._rel_err(out[2][k], ref[2][k]) for k in keys])
            st = state()
            run = dict(n_steps = K, deterministic = False)
            ms = time_ms(lambda: dk.decoder_steps(w, * args_, st, seed, ** run))
            stamps = torch.zeros((dk.stamps_size(K),), dtype = torch.int64, device = 'cuda')
            dk.decoder_steps(w, * args_, st, seed, stamps = stamps, ** run)
            torch.cuda.synchronize()
            phases = {kind: {name: round(v, 3) for name, v in
                             zip(dk.PHASES, spans.median(dim = 0).values.tolist())}
                      for kind, spans in dk.phase_times_us(stamps).items()}
            print(json.dumps({'mode': mode, 'B': B, 'S': S, 'max_rel_err_8_steps': err,
                              'argmax_equal': bool(torch.equal(out[2]['main'], ref[2]['main'])),
                              'ms_per_64_steps': ms, 'us_per_step': 1e3 * ms / K,
                              'plan': dk.decoder_steps.last_plan, 'phase_us': phases}),
                  flush = True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output = True, text = True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
