"""Device resolution shared by the port's entry points (``make_server``,
``run_vcycle``, ``run_scratch``, ``VCycleRunner``)."""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; raises when neither exists,
    so nothing runs on the CPU unless the caller asked for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return torch.device("cuda")
