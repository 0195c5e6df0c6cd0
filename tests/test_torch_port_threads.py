"""The thread budget of the port's test files.

The suite runs its files in parallel worker processes on a few cores.
Torch's intra-op pool and numpy's BLAS pool in each worker would each take
every core and spin while they wait, so a worker's CPU tests ran many times
slower than alone.  Every ``test_torch_port_*.py`` file imports the module
fixture `one_torch_thread`: one torch thread and one BLAS thread while the
file runs, the previous counts given back after.  This file imports neither
JAX nor the JAX package, so the files that also run on a card without JAX
(``-m cuda --noconftest``) can import it.
"""

import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_info, threadpool_limits
except ImportError:                 # BLAS keeps its own count
    threadpool_info = threadpool_limits = None


def _blas_limit():
    if threadpool_limits is None:
        return contextlib.nullcontext()
    return threadpool_limits(limits = 1, user_api = 'blas')


@pytest.fixture(autouse = True, scope = 'module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _blas_limit():
            yield
    finally:
        torch.set_num_threads(threads)


def test_one_thread_while_the_file_runs():
    assert torch.get_num_threads() == 1
    if threadpool_info is not None:
        assert all(pool['num_threads'] == 1 for pool in threadpool_info()
                   if pool['user_api'] == 'blas')
