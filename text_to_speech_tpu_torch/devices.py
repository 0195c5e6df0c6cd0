"""Device selection, configuration and memory introspection.

Counterpart of ``text_to_speech_tpu/devices.py``.  Entry points run on the
GPU unless the caller asks for the CPU by passing ``device='cpu'``.  Without
a device and without a GPU they raise: the port never carries on silently
on the CPU.  Platforms are named as the JAX package names them: ``'gpu'``
(PyTorch's ``cuda``) and ``'cpu'``.
"""

import logging

import torch

logger = logging.getLogger(__name__)

# JAX's default matmul precisions → torch.set_float32_matmul_precision
_MATMUL_PRECISION = {'bfloat16': 'medium', 'default': 'medium', 'tensorfloat32': 'high',
                     'high': 'high', 'float32': 'highest', 'highest': 'highest'}


def default_device(device = None, mesh = None):
    """`device` as a `torch.device`; ``None`` means this rank's device on a
    `parallel.Mesh` given as `mesh`, else ``cuda``, and raises when no CUDA
    device is present."""
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return torch.device(mesh.device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device available: pass device="cpu" to run the port on '
            'the CPU explicitly')
    return torch.device('cuda')


def _torch_platform(platform):
    if platform in ('gpu', 'cuda'):
        return 'cuda'
    if platform == 'cpu':
        return 'cpu'
    raise ValueError('unknown platform {!r}: the port runs on "gpu" (cuda) or "cpu"'
                     .format(platform))


def set_device_config(*, platform = None, default_device = None, precision = None,
                      preallocate = None, host_device_count = None):
    """Configure PyTorch for the port (call before heavy work).

    - `platform`: ``'gpu'`` (or ``'cuda'``) or ``'cpu'``: its first device
      becomes PyTorch's default device, unless `default_device` is given;
    - `default_device`: a device, a device string or a CUDA index, made
      PyTorch's default device (`torch.set_default_device`); the port's
      entry points keep their own rule (`default_device` above);
    - `precision`: ``'mixed_bfloat16'`` / ``'mixed_float16'`` install the
      training policy ``mixed_bfloat16`` (`train.precision`); the matmul
      precisions ``'float32'``/``'highest'``, ``'tensorfloat32'``/``'high'``
      and ``'bfloat16'``/``'default'`` set
      `torch.set_float32_matmul_precision` (highest, high, medium), and
      ``'float32'`` also installs the float32 policy.

    `preallocate` and `host_device_count` configure XLA and have no PyTorch
    counterpart: they raise `ValueError`.  Returns `list_devices()`."""
    for name, value in (('preallocate', preallocate), ('host_device_count', host_device_count)):
        if value is not None:
            raise ValueError('{} configures XLA and has no counterpart in the port'
                             .format(name))
    if default_device is None and platform is not None:
        default_device = _torch_platform(platform)
    if default_device is not None:
        if isinstance(default_device, int):
            default_device = torch.device('cuda', default_device)
        device = torch.device(default_device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available for default_device={!r}'
                               .format(default_device))
        torch.set_default_device(device)
    if precision is not None:
        from .train.precision import set_global_policy
        precision = str(precision)
        if precision in ('mixed_bfloat16', 'mixed_float16'):
            set_global_policy('mixed_bfloat16')
        elif precision in _MATMUL_PRECISION:
            if precision == 'float32':
                set_global_policy('float32')
            torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])
        else:
            raise ValueError('unknown precision {!r} (known: mixed_bfloat16, mixed_float16, '
                             '{})'.format(precision, ', '.join(sorted(_MATMUL_PRECISION))))
    return list_devices()


def set_default_precision(precision):
    """`set_device_config(precision = precision)`."""
    return set_device_config(precision = precision)


def get_memory_stats(device = None):
    """Device memory of one CUDA device, in bytes: {'bytes_in_use' (tensors
    allocated), 'peak_bytes_in_use' (since the last reset of the peak
    statistics), 'bytes_limit' (the card's total memory)}; ``{}`` for the
    CPU, as the JAX package gives off an accelerator.  `device` defaults to
    `default_device()`."""
    device = default_device(device)
    if device.type != 'cuda':
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {'bytes_in_use': stats.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': stats.get('allocated_bytes.all.peak', 0),
            'bytes_limit': total}


def print_memory_usage():
    for device in list_devices():
        stats = get_memory_stats(device)
        in_use = stats.get('bytes_in_use', 0) / 1024 ** 3
        limit = stats.get('bytes_limit', 0) / 1024 ** 3
        print('{}: {:.2f} / {:.2f} GiB'.format(device, in_use, limit))


def list_devices(platform = None):
    """The devices of `platform` (``'gpu'``/``'cuda'`` or ``'cpu'``), by
    default of `default_backend()`; ``[]`` for a platform that is absent."""
    platform = _torch_platform(platform or default_backend())
    if platform == 'cpu':
        return [torch.device('cpu')]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def default_backend():
    """``'gpu'`` where a CUDA device is present, else ``'cpu'``."""
    return 'gpu' if torch.cuda.is_available() else 'cpu'
