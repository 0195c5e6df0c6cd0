"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and may include the
shared headers ``csrc/*.cuh``.  At first use it is compiled with ``nvcc``
for sm_90a into ``build/torch_kernels/lib<name>.so`` at the root of the
checkout and loaded with `ctypes`.  Nothing is built when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
`build_all` starts one ``nvcc`` per source, all at once.
"""

import ctypes
import os
import shutil
import subprocess
import threading

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), 'build', 'torch_kernels')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_libraries = {}
build_logs = {}     # name -> nvcc's output (ptxas register and spill report)


def _nvcc():
    path = shutil.which('nvcc')
    toolkit = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    if path is None and os.path.exists(toolkit):
        path = toolkit
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return path


def _paths(name):
    return (os.path.join(SOURCE_DIR, name + '.cu'),
            os.path.join(BUILD_DIR, 'lib{}.so'.format(name)))


def _is_fresh(source, target):
    """The library is newer than its source and every shared header."""
    if not os.path.exists(target): return False
    headers = [os.path.join(SOURCE_DIR, f) for f in os.listdir(SOURCE_DIR)
               if f.endswith('.cuh')]
    return os.path.getmtime(target) >= max(map(os.path.getmtime, [source, * headers]))


def build_all(names):
    """Compile every stale library in `names`, one ``nvcc`` each, in parallel."""
    os.makedirs(BUILD_DIR, exist_ok = True)
    procs = {}
    for name in names:
        source, target = _paths(name)
        if _is_fresh(source, target):
            continue
        tmp = '{}.{}.tmp'.format(target, os.getpid())
        procs[name] = (subprocess.Popen(
            [_nvcc(), * NVCC_FLAGS, '-o', tmp, source],
            stdout = subprocess.PIPE, stderr = subprocess.STDOUT, text = True),
            tmp, target)
    for name, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for {}:\n{}'.format(name, output))
        os.replace(tmp, target)


def load_library(name):
    """The `ctypes` handle of ``lib<name>.so``, built first if needed."""
    with _lock:
        if name not in _libraries:
            build_all([name])
            _libraries[name] = ctypes.CDLL(_paths(name)[1])
        return _libraries[name]
