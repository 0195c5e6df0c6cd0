"""Where the PyTorch port's `tts()` time goes on the GPU.

Builds the NVIDIA-size Tacotron-2 and WaveGlow of `chip_smoke.py` (random
weights, the stop gate biased off), warms up, then traces with
`torch.profiler` the decode (`Tacotron2.compiled_infer`, on the fused
decoder kernel or on the plain loop) and the vocode
(`WaveGlow.compiled_infer`, in its default serving mode or, with
``--vocoder int8``, after `quantize_for_serving` passed its gate on a
32-frame slice of the decoded mel) of one batch.  For each it prints the wall
time with and without the profiler, the device's busy time (the union of
its kernels' intervals) and busy share, the number of kernel launches, and
the kernels with the most device time.  The decode is also split into its
parts (``decode_parts_ms``): the host's time in the encoder, the processed
memory, the fused decoder's launches and the postnet, each with the device
drained before and after it, as medians over `--repeats` decodes; ``rest``
is what the decode takes beyond them (packing, bookkeeping between the
launches, or the whole plain loop), ``total`` is that split decode and
``unsplit_total`` the median of as many decodes left alone.  One JSON line,
followed by the card's name and power limit.

With ``--train default|fused`` it traces one WaveGlow train step instead, at
NVIDIA width (random weights from a seed), on the default chain or on
`wn_train_fused`, in ``--precision float32|mixed_bfloat16``: B=`--batch` x
`--frames` frames of seeded synthetic data (the `chip_smoke.py` train step),
per-flow remat, Adam at 1e-4.  After two warm-up steps it prints the step's
profile as above and its parts (``step_parts_ms``): forward (the loss), the
backward and the optimizer's update, each with the device drained before and
after it, as medians over `--repeats` steps.  With ``--trace-steps N`` it
times nothing and runs N steps on the one repeated batch from the seeded
start instead, printing per step the loss and its three terms per element
(||z||²/2σ², -Σ log s, -Σ log|det W|, from the step's own forward), the
gradients' global norm, each flow's mean and largest log s, the leaf with
the largest gradient and the leaves whose gradient grew most since the
step before.

    python3 benchmarks/torch_port_profile.py [--texts 1] [--frames 256]
                                             [--decoder fused|plain]
                                             [--vocoder default|int8]
                                             [--repeats 5]
    python3 benchmarks/torch_port_profile.py --train default|fused
                                             [--precision float32|mixed_bfloat16]
                                             [--batch 8] [--frames 256] [--repeats 3]
                                             [--trace-steps 8]

Needs a CUDA device; imports neither JAX nor the JAX package.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEXTS = ['The quick brown fox jumps over the lazy dog.',
         'Printing, in the only sense with which we are concerned,',
         'differs from most if not from all the arts and crafts.',
         'It was invented in the fifteenth century.']


STATS = ('wall_ms', 'unprofiled_wall_ms', 'device_busy_ms', 'launches', 'top')


def profile(fn):
    """(result, wall ms, wall ms without the profiler, device busy ms,
    kernel launches, top kernels)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = 1e3 * (time.perf_counter() - start)
    with torch.profiler.profile(activities = [torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0., float('-inf')
    per_name = collections.Counter()
    for e in sorted(kernels, key = lambda e: e.time_range.start):
        start_us, stop_us = e.time_range.start, e.time_range.end
        busy_us += max(0., stop_us - max(start_us, end))
        end = max(end, stop_us)
        per_name[e.name[:80]] += stop_us - start_us
    top = [{'kernel': name, 'ms': us / 1e3} for name, us in per_name.most_common(8)]
    return result, wall_ms, unprofiled_ms, busy_us / 1e3, len(kernels), top


PARTS = ('encode', 'process_memory', 'decoder_steps', 'postnet')


def decode_parts(arch, decode, repeats):
    """Median host milliseconds of each of `PARTS` inside `decode()`, the
    device drained around each, with the decode's total and the rest, and
    the median total of the same decode without the draining."""
    from text_to_speech_tpu_torch.models import tacotron2_arch
    owners = {name: arch for name in PARTS}
    owners['decoder_steps'] = tacotron2_arch
    spent = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(* args, ** kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = fn(* args, ** kwargs)
            torch.cuda.synchronize()
            spent[name] += 1e3 * (time.perf_counter() - start)
            return result
        return wrapper

    def wall_ms():
        torch.cuda.synchronize()
        start = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - start)

    median = lambda values: sorted(values)[len(values) // 2]
    unsplit = median([wall_ms() for _ in range(repeats)])
    originals = {name: getattr(owner, name) for name, owner in owners.items()}
    for name, owner in owners.items():
        setattr(owner, name, timed(name, originals[name]))
    runs = []
    try:
        for _ in range(repeats):
            spent.clear()
            total = wall_ms()
            runs.append({** {name: spent[name] for name in PARTS}, 'total': total,
                         'rest': total - sum(spent.values())})
    finally:
        for name, owner in owners.items():
            if owner is arch:
                delattr(owner, name)            # back to the class's method
            else:
                setattr(owner, name, originals[name])
    return {** {key: median([run[key] for run in runs]) for key in runs[0]},
            'unsplit_total': unsplit}


def train_step_profile(args):
    """The record of one traced WaveGlow train step and its parts."""
    import numpy as np
    from text_to_speech_tpu_torch.init import init_waveglow
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.train.precision import compute_dtype
    from text_to_speech_tpu_torch.train.trainer import _trainable
    from text_to_speech_tpu_torch.weights import tree_to, waveglow_from_jax

    arch = WaveGlow(wn_train_fused = args.train == 'fused')
    hp = arch.hp
    params = _trainable(tree_to(waveglow_from_jax(
        init_waveglow(hp, arch.flow_channels, seed = 3)), 'cuda'))
    opt = get_optimizer('adam', lr = 1e-4).init(params)
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((args.batch, args.frames, hp.n_mel_channels))
                           .astype(np.float32)).cuda()
    audio = torch.from_numpy((0.1 * rng.standard_normal(
        (args.batch, args.frames * hp.upsample_stride))).astype(np.float32)).cuda()
    dtype = compute_dtype(args.precision)

    def forward():
        opt.zero_grad()
        return arch.loss(params, mel, audio, remat = True, compute_dtype = dtype)

    def step():
        loss = forward()
        loss.backward()
        opt.step()
        return loss

    step(), step()                                          # warm-up, kernel build
    record = {'train': args.train, 'precision': args.precision, 'batch': args.batch,
              'frames': args.frames}
    _, *stats = profile(step)
    record['step'] = dict(zip(STATS, stats))
    record['step']['device_busy_share'] = \
        record['step']['device_busy_ms'] / record['step']['wall_ms']
    record['step']['device_busy_share_unprofiled'] = \
        record['step']['device_busy_ms'] / record['step']['unprofiled_wall_ms']

    def drained(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, 1e3 * (time.perf_counter() - start)

    runs = []
    for _ in range(args.repeats):
        loss, forward_ms = drained(forward)
        _, backward_ms = drained(loss.backward)
        _, update_ms = drained(opt.step)
        runs.append({'forward': forward_ms, 'backward': backward_ms, 'optimizer': update_ms,
                     'loss': float(loss.detach())})
    median = lambda values: sorted(values)[len(values) // 2]
    record['step_parts_ms'] = {key: median([run[key] for run in runs])
                               for key in ('forward', 'backward', 'optimizer')}
    record['losses'] = [run['loss'] for run in runs]
    record['peak_memory_gb'] = torch.cuda.max_memory_allocated() / 2 ** 30
    return record


def train_trace(args):
    """Per step of `args.trace_steps` train steps on one repeated batch: the
    loss, its terms, the gradient norm, each flow's log s and the leaves
    whose gradient grew most."""
    import numpy as np
    from text_to_speech_tpu_torch.init import init_waveglow
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer, global_norm
    from text_to_speech_tpu_torch.train.precision import compute_dtype
    from text_to_speech_tpu_torch.train.trainer import _trainable
    from text_to_speech_tpu_torch.weights import flatten_tree, tree_to, waveglow_from_jax

    arch = WaveGlow(wn_train_fused = args.train == 'fused')
    hp = arch.hp
    params = _trainable(tree_to(waveglow_from_jax(
        init_waveglow(hp, arch.flow_channels, seed = 3)), 'cuda'))
    leaves = flatten_tree(params)
    opt = get_optimizer('adam', lr = 1e-4).init(params)
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((args.batch, args.frames, hp.n_mel_channels))
                           .astype(np.float32)).cuda()
    audio = torch.from_numpy((0.1 * rng.standard_normal(
        (args.batch, args.frames * hp.upsample_stride))).astype(np.float32)).cuda()
    dtype = compute_dtype(args.precision)

    log_s = []          # (mean, max) of each flow's log s, in the forward only
    for name in ('wn_block', 'wn_block_train'):
        def recorded(* a, _block = getattr(arch, name), ** kw):
            out = _block(* a, ** kw)
            if torch.is_grad_enabled() and len(log_s) < hp.n_flows:
                s = out[..., out.shape[-1] // 2:].detach().float()
                log_s.append((float(s.mean()), float(s.max())))
            return out
        setattr(arch, name, recorded)

    steps, previous = [], None
    for _ in range(args.trace_steps):
        log_s.clear()
        opt.zero_grad()
        z, log_s_total, log_det_total = arch.forward(params, mel, audio, remat = True,
                                                     compute_dtype = dtype)
        n, sigma = z.numel(), hp.sigma
        terms = [float(torch.sum(z.float() ** 2)) / (2 * sigma * sigma) / n,
                 -float(log_s_total) / n, -float(log_det_total) / n]
        ((torch.sum(z * z) / (2 * sigma * sigma) - log_s_total - log_det_total) / n).backward()
        norms = {name: float(t.grad.norm()) for name, t in leaves.items() if t.grad is not None}
        record = {'loss': sum(terms), 'z2_term': terms[0], 'log_s_term': terms[1],
                  'log_det_term': terms[2],
                  'grad_norm': float(global_norm([t.grad for t in leaves.values()
                                                  if t.grad is not None])),
                  'flow_log_s_mean': [m for m, _ in log_s],
                  'flow_log_s_max': [x for _, x in log_s],
                  'largest_grad': max(norms.items(), key = lambda kv: kv[1])}
        if previous is not None:
            growth = {name: norms[name] / max(previous[name], 1e-30) for name in norms}
            record['grad_growth_top3'] = sorted(growth.items(), key = lambda kv: -kv[1])[:3]
        steps.append(record)
        previous = norms
        opt.step()
    return {'train': args.train, 'precision': args.precision, 'batch': args.batch,
            'frames': args.frames, 'lr': 1e-4, 'trace': steps}


def main():
    parser = argparse.ArgumentParser(description = __doc__.split('\n')[0])
    parser.add_argument('--texts', type = int, default = 1, choices = range(1, 5))
    parser.add_argument('--frames', type = int, default = 256)
    parser.add_argument('--decoder', choices = ('fused', 'plain'), default = 'fused')
    parser.add_argument('--vocoder', choices = ('default', 'int8'), default = 'default')
    parser.add_argument('--repeats', type = int, default = 5)
    parser.add_argument('--train', choices = ('default', 'fused'))
    parser.add_argument('--precision', choices = ('float32', 'mixed_bfloat16'),
                        default = 'mixed_bfloat16')
    parser.add_argument('--batch', type = int, default = 8)
    parser.add_argument('--trace-steps', type = int, default = 0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_port_profile.py needs a CUDA device', file = sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = lambda: subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                  '--format=csv,noheader'],
                                 capture_output = True, text = True, check = True).stdout.strip()
    if args.train:
        record = train_trace(args) if args.trace_steps else train_step_profile(args)
        print(json.dumps(record), flush = True)
        print(smi())
        return 0
    from text_to_speech_tpu_torch.init import random_tts_models
    from text_to_speech_tpu_torch.models.tts.tacotron2 import pad_batch

    model, vocoder = random_tts_models('cuda', seed = 1)
    generator = torch.Generator(device = 'cuda').manual_seed(0)
    tokens = pad_batch([model.encode_text(t) for t in TEXTS[:args.texts]],
                       pad_value = model.blank_token_idx)

    def decode():
        return model.compiled_infer(tokens, max_length = args.frames, generator = generator,
                                    use_fused_decoder = args.decoder == 'fused')

    out = decode()                                          # warm-up, kernel build
    if args.vocoder == 'int8':
        vocoder.quantize_for_serving(validate = out.mel[:1, :32])
        if vocoder.serving_mode != 'int8':
            raise RuntimeError('the int8 gate failed: {} dB'.format(vocoder._last_serving_snr_db))
    vocoder.compiled_infer(out.mel, generator = generator)
    record = {'texts': args.texts, 'frames': args.frames, 'decoder': args.decoder,
              'vocoder': vocoder.serving_mode}
    out, *stats = profile(decode)
    record['decode'] = dict(zip(STATS, stats))
    _, *stats = profile(lambda: vocoder.compiled_infer(out.mel, generator = generator))
    record['vocode'] = dict(zip(STATS, stats))
    for phase in ('decode', 'vocode'):
        record[phase]['device_busy_share'] = \
            record[phase]['device_busy_ms'] / record[phase]['wall_ms']
        record[phase]['device_busy_share_unprofiled'] = \
            record[phase]['device_busy_ms'] / record[phase]['unprofiled_wall_ms']
    record['decode']['launches_per_step'] = record['decode']['launches'] / args.frames
    record['decode_parts_ms'] = decode_parts(model.arch, decode, args.repeats)
    print(json.dumps(record), flush = True)
    print(smi())
    return 0


if __name__ == '__main__':
    sys.exit(main())
