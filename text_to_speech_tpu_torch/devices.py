"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by passing
``device='cpu'``.  Without a device and without a GPU they raise: the port
never carries on silently on the CPU.
"""

import torch


def default_device(device = None):
    """`device` as a `torch.device`; ``None`` means ``cuda`` and raises when
    no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device available: pass device="cpu" to run the port on '
            'the CPU explicitly')
    return torch.device('cuda')
