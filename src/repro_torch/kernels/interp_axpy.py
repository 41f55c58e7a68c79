"""Interpolation of two parameter tensors: the CUDA kernel and its plain
PyTorch version.

The counterpart of ``repro/kernels/interp_axpy.py`` (the Pallas
``_axpy_kernel``): the paper's Eq. 13, ``out = (1 - alpha) * a + alpha * b``
with f32 math and the output in ``a``'s type, over a leaf of any shape.

The kernel source is ``csrc/interp_axpy.cu``; it masks the tail where the
reference pads a copy to whole blocks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_cuda_inputs


def interp_axpy_torch(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Plain version: two f32 scalings and one add."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return ref.interp_axpy_ref(a, b, alpha)


def interp_axpy_cuda(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch ``interp_axpy`` on the current stream (no fallback)."""
    check_cuda_inputs("interp_axpy", a, b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"interp_axpy: dtypes {a.dtype}/{b.dtype}; need one of "
                         f"{tuple(DTYPE_CODES)} for both")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("interp_axpy: both tensors must be contiguous")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    if a.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(a.device):
        err = lib.interp_axpy(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              DTYPE_CODES[a.dtype], a.numel(), float(1.0 - alpha),
                              float(alpha), torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "interp_axpy")
    interp_axpy_cuda.launches += 1
    return out


interp_axpy_cuda.launches = 0
