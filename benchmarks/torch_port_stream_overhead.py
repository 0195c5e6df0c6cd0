"""One-sentence `tts()` on the GPU with `predict`'s `Stream` thread and
without it, in turns: what running `infer` on that thread costs.

Random weights at NVIDIA sizes (`init.random_tts_models`, seed 1, the stop
gate biased off), 256 frames, the one-launch path, nothing saved or shown.
Three modes, each `--reps` times after a warm-up, in turns:

  stream   ``tts(text)``: `BaseModel.predict` runs `infer` on the
           `Stream`'s producer thread (``workers=1``, the default; a thread
           an earlier call left idle);
  inline   ``tts(text, workers=0)``: `infer` on the calling thread;
  pool     ``tts(text, workers=0)`` called on one long-lived worker
           thread (a thread that is not the main one, but not new).

Prints one JSON line: for each mode the medians of the call's wall ms and
of its decode and vocode ms (`Tacotron2.last_timings`, CUDA events), then
the card's name and power limit.  ``--root`` imports the package from
another checkout (a parent commit ignores ``workers``: every mode runs
inline there).

    python3 benchmarks/torch_port_stream_overhead.py [--reps 9] [--root DIR]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

SENTENCE = 'The quick brown fox jumps over the lazy dog.'


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--reps', type = int, default = 9)
    parser.add_argument('--root', default = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('torch_port_stream_overhead.py needs a CUDA device')
    sys.path.insert(0, os.path.abspath(args.root))
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import random_tts_models
    from text_to_speech_tpu_torch.ops import _build

    _build.build_all(['wn_block', 'decoder_steps'])
    model, vocoder = random_tts_models('cuda', seed = 1)
    generator = torch.Generator(device = 'cuda').manual_seed(0)
    kw = dict(model = model, vocoder = vocoder, max_length = 256, generator = generator,
              min_fpt_ratio = 0., max_fpt_ratio = 1e9, save = False, display = False)
    pool = ThreadPoolExecutor(1)

    def run(mode):
        start = time.perf_counter()
        if mode == 'stream':
            tts(SENTENCE, ** kw)
        elif mode == 'inline':
            tts(SENTENCE, workers = 0, ** kw)
        else:
            pool.submit(lambda: tts(SENTENCE, workers = 0, ** kw)).result()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - start)
        return total, 1e3 * model.last_timings['decode_s'], 1e3 * model.last_timings['vocode_s']

    modes = ('stream', 'inline', 'pool')
    for mode in modes:
        run(mode)                                                       # warm-up
    times = {mode: [] for mode in modes}
    for rep in range(args.reps):
        for mode in (modes if rep % 2 == 0 else modes[::-1]):
            times[mode].append(run(mode))
    pool.shutdown()
    median = lambda values: statistics.median(values)
    print(json.dumps({'root': os.path.abspath(args.root), 'reps': args.reps, 'modes': {
        mode: {'total_ms': median([t[0] for t in values]),
               'decode_ms': median([t[1] for t in values]),
               'vocode_ms': median([t[2] for t in values]),
               'total_ms_all': [t[0] for t in values]}
        for mode, values in times.items()}}), flush = True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip())


if __name__ == '__main__':
    main()
