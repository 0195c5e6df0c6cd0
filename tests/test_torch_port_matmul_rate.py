"""The rate probe (K5): the port's plain version against the JAX kernel, and
the CUDA kernel against the plain version.

The JAX kernel is built inside ``benchmarks/matmul_rate.py``'s `main` and
cannot be imported, and the script stays as it is.  So the test loads it by
path, sets its sizes small (M = K = 32, N = 64, REPS = 10, GRID = 2, one
timed iteration), makes `jax.jit` the identity and wraps `pallas_call` into
interpret mode, keeping each built kernel and what it returned, and runs
`main`.  The kept kernels then also take seeded random inputs.  int8: the
chain is exact in int32 on both sides, so plain == JAX to the bit.  bf16:
both sides sum exact products of bf16 values in float32, in another order,
and round acc to bf16 at every feedback, where another order can flip a
rounding that the chain carries on; held within 1e-3 of the output's largest
magnitude and 1e-5 on average, the 4-product limits below.  The script's
own inputs (ones; 0.01 in bf16) stay finite at these sizes; at the probe's
sizes the bf16 ones overflow to inf at the 49th product, so the `cuda` cases
at those sizes take seeded inputs scaled so that the chain stays finite.

The `cuda` cases hold the kernel (`matmul_rate` on CUDA tensors) against
`matmul_rate_plain` at the probe's shapes (M = K = 512, N = 1024, REPS =
GRID = 64) and at small ones.  int8 to the bit.  bf16 over 64 products
within 1e-2 of the largest output and 1e-3 on average: the chain amplifies
every flipped rounding (on the CPU at these shapes, two other float32
summation orders of the plain version land 3.2e-3 and 3.6e-3 from it, and
3.5e-4 and 3.8e-4 on average, `benchmarks/torch_port_bf16_chain.py`; the
kernel on an H100 3.3e-3, 4.3e-4), and a
wrong tile or index misses by orders of magnitude.  One product, before any
rounding to bf16, is the float32 sums alone: 1e-5 and 1e-6.  Over 4
products it is held within 2e-3 and 5e-5 on average (other orders on the
CPU: 3.9e-4, 1.3e-6; the kernel on an H100, whose tensor cores add into acc
as they go: 5.9e-4, 8.5e-6), and a control with the feedback left in
float32 must miss that (1.2e-3, 2.1e-4).  They skip without a card; on a
machine with a card and without JAX they run alone:

    python -m pytest tests/test_torch_port_matmul_rate.py -m cuda --noconftest
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu_torch.ops import matmul_rate as module
from text_to_speech_tpu_torch.ops.matmul_rate import (
    MAX_SHARED, _check, cluster_shape, l2_bytes, matmul_rate, matmul_rate_plain, ring_stages,
    shared_bytes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(M = 32, K = 32, N = 64, REPS = 10, GRID = 2)
# (max, mean), relative: the CPU's bf16 chains against JAX, and on the card one
# product, 4 and 64
TOL = {'cpu': (1e-3, 1e-5), 'one': (1e-5, 1e-6), 'short': (2e-3, 5e-5), 'long': (1e-2, 1e-3)}


def _errs(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return np.abs(out - ref).max() / scale, np.abs(out - ref).mean() / scale


def _inputs(dtype, M, K, N, seed = 0):
    """Seeded x (M, K) and w (8, K, N): int8 over its whole range; bf16
    x ~ N(0, 1) and w ~ N(0, 0.25 / K), so that the chain grows by about
    sqrt(1.25) a product and stays finite over 64."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return (torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)),
                torch.from_numpy(rng.integers(-128, 128, (8, K, N)).astype(np.int8)))
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (0.5 / np.sqrt(K) * rng.standard_normal((8, K, N))).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


@pytest.fixture(scope = 'module')
def jax_kernels():
    """{'int8' | 'bf16': (built kernel, [(inputs, output), ...])} from one
    run of the script's `main` in interpret mode."""
    import jax
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        'matmul_rate_script', os.path.join(REPO, 'benchmarks', 'matmul_rate.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    kept = {}
    pallas_call = pl.pallas_call

    def interpret(* args, ** kwargs):
        kernel = pallas_call(* args, ** dict(kwargs, interpret = True))

        def call(x, w):
            out = kernel(x, w)
            name = 'int8' if x.dtype == np.int8 else 'bf16'
            kept.setdefault(name, (kernel, []))[1].append(((x, w), out))
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(SMALL, ITERS = 1).items():
            mp.setattr(script, name, value)
        mp.setattr(pl, 'pallas_call', interpret)
        mp.setattr(jax, 'jit', lambda fn, * a, ** kw: fn)
        script.main()
    return kept


def _to_torch(array, dtype):
    return torch.from_numpy(np.array(array.astype(np.float32))).to(dtype)


@pytest.mark.parametrize('name', ['int8', 'bf16'])
def test_plain_matches_jax_at_the_scripts_inputs(jax_kernels, name):
    """Every call `main` made (two warm-ups and one timed): ones, and ones
    times 0.01 in bf16."""
    dtype = torch.int8 if name == 'int8' else torch.bfloat16
    _, calls = jax_kernels[name]
    assert len(calls) == 3
    for (x, w), out in calls:
        plain = matmul_rate_plain(_to_torch(x, dtype), _to_torch(w, dtype),
                                  SMALL['REPS'], SMALL['GRID'])
        out = np.asarray(out)
        assert plain.shape == out.shape == (SMALL['M'], SMALL['N'])
        if name == 'int8':
            assert plain.dtype == torch.int32 and np.array_equal(plain.numpy(), out)
        else:
            assert plain.dtype == torch.float32 and np.isfinite(out).all()
            max_err, mean_err = _errs(plain.numpy(), out)
            assert max_err <= TOL['cpu'][0] and mean_err <= TOL['cpu'][1]


@pytest.mark.parametrize('name', ['int8', 'bf16'])
def test_plain_matches_jax_on_seeded_inputs(jax_kernels, name):
    import jax.numpy as jnp
    dtype = torch.int8 if name == 'int8' else torch.bfloat16
    kernel, _ = jax_kernels[name]
    x, w = _inputs(dtype, SMALL['M'], SMALL['K'], SMALL['N'], seed = 3)
    jdtype = jnp.int8 if name == 'int8' else jnp.bfloat16
    out = np.asarray(kernel(jnp.asarray(x.float().numpy()).astype(jdtype),
                            jnp.asarray(w.float().numpy()).astype(jdtype)))
    plain = matmul_rate_plain(x, w, SMALL['REPS'], SMALL['GRID']).numpy()
    if name == 'int8':
        assert np.abs(out).max() > 2 ** 16 and np.array_equal(plain, out)
    else:
        max_err, mean_err = _errs(plain, out)
        assert max_err <= TOL['cpu'][0] and mean_err <= TOL['cpu'][1]


def test_plain_int8_matches_an_integer_restatement():
    """The int8 chain in numpy's int64, at a width where the float32
    products of the plain version must still be exact (K = 512)."""
    x, w = _inputs(torch.int8, 32, 512, 576, seed = 4)
    out = matmul_rate_plain(x, w, 5, 3)
    xs, acc = x.numpy().astype(np.int64), np.zeros((32, 576), np.int64)
    for r in range(5):
        acc += xs @ w[r % 8].numpy().astype(np.int64)
        xs = acc[:, :512] & 127
    assert np.array_equal(out.numpy(), acc)


def test_wrapper_on_cpu_takes_the_plain_version():
    before = matmul_rate.launches
    x, w = _inputs(torch.bfloat16, 32, 64, 64, seed = 5)
    assert torch.equal(matmul_rate(x, w, 3, 2), matmul_rate_plain(x, w, 3, 2))
    assert matmul_rate.launches == before


def test_envelope_and_tiling_counts():
    """The wrapper's checks (run here on CPU tensors) and the counts that the
    chip run reports: shared memory, cluster shape and L2 bytes."""
    for shape in ((96, 64, 64), (64, 96, 128), (64, 64, 96), (64, 128, 64), (64, 64, 1088),
                  (64, 576, 1024)):
        M, K, N = shape
        with pytest.raises(ValueError):
            _check(torch.zeros((M, K), dtype = torch.int8),
                   torch.zeros((8, K, N), dtype = torch.int8), 4, 1)
    with pytest.raises(TypeError):
        _check(torch.zeros((64, 64), dtype = torch.int8),
               torch.zeros((8, 64, 64), dtype = torch.bfloat16), 4, 1)
    with pytest.raises(ValueError):
        _check(torch.zeros((64, 64), dtype = torch.int8),
               torch.zeros((8, 64, 64), dtype = torch.int8), 0, 1)
    # the edges of the envelope: K = N = 512 (one block a row tile), the
    # probe's shapes, the smallest tile
    for M, K, N in ((64, 512, 512), (512, 512, 1024), (64, 64, 64)):
        _check(torch.zeros((M, K), dtype = torch.bfloat16),
               torch.zeros((8, K, N), dtype = torch.bfloat16), 64, 64)
    # two x buffers (64 KB each in bf16 at K = 512, 32 KB in int8) and as
    # many 32 KB stages as fit in a block's 227 KB
    assert (ring_stages(512, 2), ring_stages(512, 1)) == (3, 5)
    assert shared_bytes(512, 2) == 1024 + 2 * 2 ** 16 + 3 * 2 ** 15 + 256 <= MAX_SHARED
    assert shared_bytes(512, 1) == 1024 + 2 * 2 ** 15 + 5 * 2 ** 15 + 256 <= MAX_SHARED
    # (row tiles a cluster, blocks a row tile): 512 row tiles at the probe's
    # shapes, 2 at (64, 128) x 2, 9 at (192, 192) x 3
    assert cluster_shape(512, 1024, 64) == (4, 2)
    assert cluster_shape(64, 128, 2) == (2, 1) and cluster_shape(192, 192, 3) == (1, 1)
    # 128 clusters, each reading w[r % 8] (0.5 MiB int8) once for each of 64
    # products; 1,024 blocks reading their 64 rows of x; 512 row tiles writing out
    assert l2_bytes(512, 512, 1024, 64, 64, 1) == (128 * 64 * 2 ** 19 + 1024 * 64 * 512
                                                   + 512 * 64 * 1024 * 4)


def test_main_prints_the_scripts_lines(monkeypatch, capsys):
    for name, value in (('MM_M', 32), ('MM_K', 64), ('MM_N', 64), ('MM_REPS', 3),
                        ('MM_GRID', 2)):
        monkeypatch.setenv(name, str(value))
    results = module.main(device = 'cpu')
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r'int8: \d+\.\d{4}s  -> \d+ TOPS/s', lines[0])
    assert re.fullmatch(r'bf16: \d+\.\d{4}s  -> \d+ TFLOP/s', lines[1])
    assert set(results) == {'int8', 'bf16'}
    assert all(r['seconds'] > 0 and r['rate'] > 0 for r in results.values())


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('CUDA device unavailable')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16])
@pytest.mark.parametrize('M,K,N,reps,grid', [(512, 512, 1024, 64, 64), (64, 64, 128, 10, 2),
                                             (192, 128, 192, 5, 3), (64, 512, 512, 6, 4),
                                             (128, 64, 1024, 7, 3), (64, 512, 1024, 3, 1)])
def test_kernel_matches_plain(cuda_device, dtype, M, K, N, reps, grid):
    """The probe's shapes (clusters of 4 row tiles x 2 blocks), and the edges
    of the envelope: the smallest K and N, K = N = 512 (no partner block),
    N = 1024 with K = 64 (the partner's x a partly used chunk), and row
    tiles that divide by 2 or by nothing."""
    x, w = (t.to(cuda_device) for t in _inputs(dtype, M, K, N, seed = M + K))
    before = matmul_rate.launches
    out = matmul_rate(x, w, reps, grid)
    torch.cuda.synchronize()
    assert matmul_rate.launches == before + 1
    ref = matmul_rate_plain(x, w, reps, grid)
    assert out.dtype == ref.dtype and out.shape == (M, N)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert bool(torch.isfinite(out).all())
        max_err, mean_err = _errs(out.cpu().numpy(), ref.cpu().numpy())
        limit = TOL['long']
        assert max_err <= limit[0] and mean_err <= limit[1]


@pytest.mark.cuda
def test_short_bf16_chain_and_its_control(cuda_device):
    x, w = (t.to(cuda_device) for t in _inputs(torch.bfloat16, 512, 512, 1024, seed = 7))
    max_err, mean_err = _errs(matmul_rate(x, w, 1, 64).cpu().numpy(),
                              matmul_rate_plain(x, w, 1, 64).cpu().numpy())
    assert max_err <= TOL['one'][0] and mean_err <= TOL['one'][1]
    out, ref = matmul_rate(x, w, 4, 64), matmul_rate_plain(x, w, 4, 64)
    max_err, mean_err = _errs(out.cpu().numpy(), ref.cpu().numpy())
    assert max_err <= TOL['short'][0] and mean_err <= TOL['short'][1]
    xs, acc = x.float(), torch.zeros_like(ref)
    for r in range(4):
        acc += xs @ w[r].float()
        xs = acc[:, :512]
    control = _errs(acc.cpu().numpy(), ref.cpu().numpy())
    assert control[0] > TOL['short'][0] or control[1] > TOL['short'][1]


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes(cuda_device):
    for (M, K, N) in ((96, 64, 64), (64, 96, 128), (64, 128, 64), (64, 64, 1088),
                      (64, 576, 1024)):
        x, w = (t.to(cuda_device) for t in _inputs(torch.int8, M, K, N))
        with pytest.raises(ValueError):
            matmul_rate(x, w, 2)
    x, w = (t.to(cuda_device) for t in _inputs(torch.int8, 64, 64, 64))
    with pytest.raises(TypeError):
        matmul_rate(x, w.to(torch.bfloat16), 2)
    with pytest.raises(ValueError):
        matmul_rate(x[:, :32], w[:, :32], 2)      # not contiguous, and K % 64


@pytest.mark.cuda
def test_main_runs_the_probe_on_the_card(cuda_device, capsys):
    before = matmul_rate.launches
    results = module.main()
    assert matmul_rate.launches == before + 2 * (2 + module.ITERS)
    assert set(results) == {'int8', 'bf16'} and 'TOPS/s' in capsys.readouterr().out
