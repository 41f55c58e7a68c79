"""Width coalescing of one axis of a 2D weight: the CUDA kernel and its
plain PyTorch version.

The counterpart of ``repro/kernels/coalesce_pair.py`` (the Pallas
``_pair_kernel``): for the paper's "stack" variant the averaging F is a pair
merge, ``Y = w0 * (W[i] + W[i + n/2])`` along ``axis`` (0 or 1) with f32
math and the output in the input type; ``w0`` is 0.5 for an "out"-role axis
and 1.0 for an "in"-role one.  One pass over the weight, no F matrix.

The kernel source is ``csrc/coalesce_pair.cu``.  It masks its edges, so it
takes every shape with an even ``axis``, including the odd and prime other
dims for which the reference falls back to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_cuda_inputs


def _check(w: torch.Tensor, axis: int) -> None:
    if w.ndim != 2:
        raise ValueError("coalesce_pair expects a 2D weight (fold other dims first)")
    if axis not in (0, 1):
        raise ValueError(f"coalesce_pair: axis must be 0 or 1, got {axis}")
    if w.shape[axis] % 2:
        raise ValueError(f"axis {axis} size {w.shape[axis]} must be even")


def coalesce_pair_torch(w: torch.Tensor, *, axis: int, w0: float = 0.5) -> torch.Tensor:
    """Plain version: two slices, one f32 add and scale."""
    _check(w, axis)
    a, b = w.chunk(2, dim=axis)
    return (w0 * (a.float() + b.float())).to(w.dtype)


def coalesce_pair_cuda(w: torch.Tensor, *, axis: int, w0: float = 0.5) -> torch.Tensor:
    """Launch ``coalesce_pair`` on the current stream (no fallback)."""
    check_cuda_inputs("coalesce_pair", w)
    _check(w, axis)
    if w.dtype not in DTYPE_CODES:
        raise ValueError(f"coalesce_pair: dtype {w.dtype}; need one of {tuple(DTYPE_CODES)}")
    if not w.is_contiguous():
        raise ValueError("coalesce_pair: the weight must be contiguous")
    r, c = w.shape
    out = torch.empty((r // 2, c) if axis == 0 else (r, c // 2), dtype=w.dtype,
                      device=w.device)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(w.device):
        err = lib.coalesce_pair(w.data_ptr(), out.data_ptr(), DTYPE_CODES[w.dtype], r, c,
                                axis, float(w0),
                                torch.cuda.current_stream(w.device).cuda_stream)
    build.check(err, "coalesce_pair")
    coalesce_pair_cuda.launches += 1
    return out


coalesce_pair_cuda.launches = 0
