"""Host time of one call of the K1 and K3 wrappers on the card: what the
Python wrapper costs from its call to its return (the launch is
asynchronous), at the main path's shapes.

    python benchmarks/torch_port_op_dispatch.py [--root DIR] [--calls N]

`--root` is the checkout whose ``text_to_speech_tpu_torch`` is imported
(default: this one), so that two trees can be compared in one run on one
card, e.g. a parent commit unpacked beside it.  K1: `fused_wn_block` at
NVIDIA WaveGlow's block (C=512, S=640, L=8), bf16, B=1 x 8192; K3:
`decoder_steps` at NVIDIA Tacotron-2's decoder (U=1024, D=512, A=128,
prenet 256), float32, B=1, S=64, 64 steps, its LSTM weights in the kernel's
slabs as a model on a card keeps them.  Each call runs after a
synchronisation; prints one JSON line: the quartiles in µs, the card's
name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _host_us(fn, calls, torch):
    """Quartiles (25, 50, 75 %) of the µs from a call to its return."""
    times = []
    for i in range(calls + 3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        elapsed = time.perf_counter() - start
        if i >= 3:
            times.append(1e6 * elapsed)
    torch.cuda.synchronize()
    return statistics.quantiles(times, n = 4)


def main(argv = None):
    parser = argparse.ArgumentParser(description = __doc__.split('\n\n')[0])
    parser.add_argument('--root', default = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument('--calls', type = int, default = 1000)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('torch_port_op_dispatch.py needs a CUDA device', file = sys.stderr)
        return 1
    from text_to_speech_tpu_torch.ops import _build
    from text_to_speech_tpu_torch.ops import decoder_kernel as dk
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    _build.build_all(['wn_block', 'decoder_steps'])

    gen = torch.Generator(device = 'cuda').manual_seed(0)
    f = lambda * shape, scale = 0.05, dtype = torch.float32: (
        scale * torch.randn(shape, generator = gen, device = 'cuda')).to(dtype)
    B, T, C, S, L = 1, 8192, 512, 640, 8
    bf16 = torch.bfloat16
    k1_args = (f(B, T, C, dtype = bf16), f(B, T, S, dtype = bf16),
               f(L, 3 * C + S, 2 * C, dtype = bf16), f(L, 2 * C), f(L - 1, C, 2 * C, dtype = bf16),
               f(L - 1, 2 * C), f(C, C, dtype = bf16), f(C))
    k1_us = _host_us(lambda: fused_wn_block(* k1_args), args.calls, torch)

    n_mel, P, U, D, A, S_tok, K = 80, 256, 1024, 512, 128, 64, 64
    weights = dk.kernel_weights_only({
        'w0': f(n_mel, P), 'b0': f(P), 'w1': f(P, P), 'b1': f(P),
        'att_w': f(P + D + U, 4 * U), 'att_b': f(4 * U), 'q_w': f(U, A),
        'loc_w': f(2 * dk.LOC_KERNEL, A), 'v_w': f(A), 'dec_w': f(2 * U + D, 4 * U),
        'dec_b': f(4 * U), 'proj_w': f(U + D, n_mel + 1), 'proj_b': f(n_mel + 1)})
    inputs = (f(B, S_tok, D), f(B, S_tok, A), torch.ones((B, S_tok), device = 'cuda'),
              torch.full((B,), S_tok, dtype = torch.int32, device = 'cuda'), f(B, P) * 0.)
    state = dk.init_decoder_state(B, S_tok, D, U, n_mel, device = 'cuda')
    seed = torch.zeros((1,), dtype = torch.int64, device = 'cuda')
    k3_us = _host_us(lambda: dk.decoder_steps(weights, * inputs, state, seed, n_steps = K,
                                              deterministic = True), args.calls, torch)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output = True, text = True).stdout.strip()
    print(json.dumps({'root': args.root, 'calls': args.calls,
                      'torch_library_ops': hasattr(torch.ops.tts_torch, 'wn_block'),
                      'k1_host_us_quartiles': k1_us, 'k3_host_us_quartiles': k3_us,
                      'k1_launches': fused_wn_block.launches,
                      'k3_launches': dk.decoder_steps.launches, 'card': smi}), flush = True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
