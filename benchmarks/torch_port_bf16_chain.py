"""How far another float32 summation order moves the rate probe's bf16
chain, on the CPU: the reading behind the bf16 tolerances of K5
(`text_to_speech_tpu_torch.ops.matmul_rate`).

At the probe's widths (M = K = 512, N = 1024, one grid repeat), seeded
x ~ N(0, 1) and w ~ N(0, 0.25 / K) in bf16, it holds against
`matmul_rate_plain` after 1, 4 and 64 products:

  - ``float64``: each product summed in float64, then rounded to float32;
  - ``chunks``: acc += x[:, k:k+64] @ w[k:k+64], acc taking the sums as they
    come, as the tensor cores add into it;
  - ``control``: the feedback left in float32 (not rounded to bf16), which
    the limits must tell apart from the other two.

Prints one JSON line: {reps: {variant: [max, mean]}}, relative to the
largest magnitude of the plain version's output.

    python benchmarks/torch_port_bf16_chain.py
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

from text_to_speech_tpu_torch.ops.matmul_rate import matmul_rate_plain  # noqa: E402

M, K, N = 512, 512, 1024


def variant(x, w, reps, name):
    xs, acc = x, torch.zeros((M, N))
    for r in range(reps):
        if name == 'float64':
            acc += (xs.double() @ w[r % 8].double()).float()
        elif name == 'chunks':
            xf, wf = xs.float(), w[r % 8].float()
            for k in range(0, K, 64):
                acc += xf[:, k:k + 64] @ wf[k:k + 64]
        else:
            acc += xs.float() @ w[r % 8].float()
        xs = acc[:, :K] if name == 'control' else acc[:, :K].to(torch.bfloat16)
    return acc


def main():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((0.5 / np.sqrt(K) * rng.standard_normal((8, K, N)))
                         .astype(np.float32)).to(torch.bfloat16)
    out = {}
    for reps in (1, 4, 64):
        ref = matmul_rate_plain(x, w, reps)
        scale = float(ref.abs().max())
        out[reps] = {}
        for name in ('float64', 'chunks', 'control'):
            diff = (variant(x, w, reps, name) - ref).abs()
            out[reps][name] = [float(diff.max()) / scale, float(diff.mean()) / scale]
    print(json.dumps(out))


if __name__ == '__main__':
    main()
