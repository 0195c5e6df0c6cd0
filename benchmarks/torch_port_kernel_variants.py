"""K4 and K5 on one NVIDIA GPU beside variants of themselves with one part
removed or changed, to split a kernel's time into its parts.

Each variant is the checkout's kernel source with a textual change (each
change must apply, or the script fails), built with the port's nvcc flags
into ``build/torch_kernels/variants/`` and called through the port's own
wrapper (`fused_wn_layer`, `matmul_rate`), so shapes, checks and scratch are
the main path's.  Variants:

  K5 (``csrc/matmul_rate.cu``, int8 and bf16 at the probe's shapes, M = K =
  512, N = 1024, REPS = GRID = 64):
    no_stream        the producer loads nothing and the consumers wait for
                     no stage: the products alone (on stale shared memory)
    no_mma           the consumers issue no wgmma: the stream of w alone
    release_cluster  the stage releases on the peers' barriers with
                     .release.cluster semantics instead of the default
  K4 (``csrc/wn_layer.cu``, bf16, B = 8 and 1, T = 8192, C = 512, a
  residual layer at dilation 1):
    no_cond          the in-GEMM adds no cond (and keeps 4 stages)
    no_gate_store    the in-GEMM stores no gate (what a kernel keeping the
                     gate in shared memory would save on the write side)

Times: CUDA events, median of 7 after 2 warm-ups, L2 evicted before each,
in the order kernel, variant, variant, kernel; outputs of the variants are
not checked.  One JSON line, then the card's name and power limit:

    python benchmarks/torch_port_kernel_variants.py
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from text_to_speech_tpu_torch.ops import _build, matmul_rate as k5, wn_layer as k4  # noqa: E402

VARIANT_DIR = os.path.join(_build.BUILD_DIR, 'variants')

_NO_STREAM = [
    ('          hop::mbar_wait(&empty[s], phase ^ 1);\n',
     '          if (VARIANT) continue;\n          hop::mbar_wait(&empty[s], phase ^ 1);\n'),
    ('        hop::mbar_wait(&full[s], phase);\n',
     '        if (!VARIANT) hop::mbar_wait(&full[s], phase);\n'),
    ('if (lane < R) hop::mbar_arrive_remote(&empty[prev], p * R + lane);',
     'if (lane < R && !VARIANT) hop::mbar_arrive_remote(&empty[prev], p * R + lane);'),
]
_NO_MMA = [('          Op<INT8>::mma(acc, da,', '          if (!VARIANT) Op<INT8>::mma(acc, da,')]
_RELEASE_CLUSTER = [('mbarrier.arrive.shared::cluster.b64 _, [%0];',
                     'mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];')]
_NO_COND = [('wn_in_wgmma<bf16, true>', 'wn_in_wgmma<bf16, false>')]
# the store stays in the code (never taken) so that the gate is still computed
_NO_GATE_STORE = [('          *reinterpret_cast<__nv_bfloat162*>(out + n) =\n'
                   '              __floats2bfloat162_rn(gate(a_t0',
                   '          if (!VARIANT || a_t0 == -1e30f)\n'
                   '          *reinterpret_cast<__nv_bfloat162*>(out + n) =\n'
                   '              __floats2bfloat162_rn(gate(a_t0')]

# name: (source, {file: changes})
VARIANTS = {
    'no_stream': ('matmul_rate', {'matmul_rate.cu': _NO_STREAM}),
    'no_mma': ('matmul_rate', {'matmul_rate.cu': _NO_MMA}),
    'release_cluster': ('matmul_rate', {'wn_wgmma.cuh': _RELEASE_CLUSTER}),
    'no_cond': ('wn_layer', {'wn_layer.cu': _NO_COND}),
    'no_gate_store': ('wn_layer', {'wn_sm90.cuh': _NO_GATE_STORE}),
}


def build_variant(name):
    """Write the variant's changed files beside copies of the others and
    build it; returns its ctypes library."""
    source, changes = VARIANTS[name]
    directory = os.path.join(VARIANT_DIR, name)
    os.makedirs(directory, exist_ok = True)
    for file in os.listdir(_build.SOURCE_DIR):
        with open(os.path.join(_build.SOURCE_DIR, file)) as f:
            text = f.read()
        for old, new in changes.get(file, []):
            if old not in text:
                raise RuntimeError('variant {}: {!r} not found in {}'.format(name, old, file))
            text = text.replace(old, new)
        if file == source + '.cu':
            text = '#define VARIANT 1\n' + text
        with open(os.path.join(directory, file), 'w') as f:
            f.write(text)
    target = os.path.join(directory, 'lib{}.so'.format(source))
    proc = subprocess.run([_build._nvcc(), * _build.NVCC_FLAGS, '-o', target,
                           os.path.join(directory, source + '.cu')],
                          capture_output = True, text = True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed for variant {}:\n{}'.format(name, proc.stdout + proc.stderr))
    return ctypes.CDLL(target)


def time_ms(fn, reps = 7, warmup = 2):
    flush = torch.empty(256 * 2 ** 20, dtype = torch.uint8, device = 'cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing = True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(module, entry, library, call):
    """Kernel, variant, variant, kernel: {'kernel_ms', 'variant_ms'}."""
    kernel = module._kernel()
    variant = getattr(library, entry)
    variant.argtypes, variant.restype = kernel.argtypes, kernel.restype
    times = {'kernel': [], 'variant': []}
    try:
        for which in ('kernel', 'variant', 'variant', 'kernel'):
            module._kernel = (lambda: variant) if which == 'variant' else (lambda: kernel)
            times[which].append(time_ms(call))
    finally:
        module._kernel = lambda: kernel
    return {'kernel_ms': statistics.mean(times['kernel']),
            'variant_ms': statistics.mean(times['variant'])}


def main():
    if not torch.cuda.is_available():
        print('torch_port_kernel_variants.py needs a CUDA device', file = sys.stderr)
        return 1
    _build.build_all(['matmul_rate', 'wn_layer'])
    rng = np.random.default_rng(0)
    f = lambda * shape, scale = 1.: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
    rate_inputs = {
        'int8': (torch.from_numpy(rng.integers(-128, 128, (512, 512)).astype(np.int8)).cuda(),
                 torch.from_numpy(rng.integers(-128, 128, (8, 512, 1024)).astype(np.int8)).cuda()),
        'bf16': (f(512, 512).bfloat16(), f(8, 512, 1024, scale = 0.5 / 512 ** 0.5).bfloat16())}
    C = 512
    layer_inputs = {}
    for B in (8, 1):
        layer_inputs['B{}'.format(B)] = (
            f(B, 8192, C).bfloat16(), f(B, 8192, 2 * C, scale = 0.5).bfloat16(),
            f(3, C, 2 * C, scale = (3 * C) ** -0.5).bfloat16(), f(2 * C, scale = 0.1).bfloat16(),
            f(1, C, 2 * C, scale = C ** -0.5).bfloat16(), f(2 * C, scale = 0.1).bfloat16())
    results = {}
    for name, (source, _) in VARIANTS.items():
        library = build_variant(name)
        if source == 'matmul_rate':
            for dtype, (x, w) in rate_inputs.items():
                results['{}_{}'.format(name, dtype)] = compare(
                    k5, 'matmul_rate_forward', library,
                    lambda: k5.matmul_rate(x, w, 64, 64))
        else:
            for key, args in layer_inputs.items():
                results['{}_{}'.format(name, key)] = compare(
                    k4, 'wn_layer_forward', library,
                    lambda: k4.fused_wn_layer(* args, dilation = 1))
    print(json.dumps({'variants': results}), flush = True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
