"""Kernel backend registry + dispatch (the counterpart of
``repro/kernels/dispatch.py``).

Each op is registered under three backends:

  * ``torch`` -- the plain PyTorch version (runs on any device; the CPU
                 tests use it, and ``chip_smoke.py`` holds the kernels to it)
  * ``cuda``  -- the hand-written CUDA kernel (``csrc/``); CUDA tensors only
  * ``meta``  -- the kernel's meta form: outputs of its shapes and types on
                 the meta device, nothing computed, its cost reported to
                 ``kernels/cost.py`` (the dry run, ``launch/dryrun.py``); meta
                 tensors only

Selection order (first hit wins):

  1. an explicit ``backend=`` argument,
  2. ``ModelConfig.kernel_backend`` (the layers pass it as ``config=``),
  3. the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable,
  4. the tensor's device: ``cuda`` for a CUDA tensor, ``meta`` for a meta
     tensor, ``torch`` otherwise.

Asking for ``cuda`` with a CPU or meta tensor raises, and so does asking
for ``meta`` with a tensor that is not on the meta device.  The ``cuda`` implementations
never catch a build or launch failure and never fall back to ``torch``.

``flash_attention``/``flash_attention_bwd`` are the raw forward and backward;
the layers call :func:`flash_attention`, which resolves one backend and runs
both through the ``FlashAttention`` autograd Function.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import coalesce_pair as cp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import interp_axpy as ia
from repro_torch.kernels import paged_attention as pa

BACKENDS = ("torch", "cuda", "meta")
ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"

_REGISTRY: Dict[str, Dict[str, Callable]] = {
    "flash_attention": {"torch": fa.flash_attention_torch,
                        "cuda": fa.flash_attention_cuda,
                        "meta": fa.flash_attention_meta},
    "flash_attention_bwd": {"torch": fa.flash_attention_bwd_torch,
                            "cuda": fa.flash_attention_bwd_cuda,
                            "meta": fa.flash_attention_bwd_meta},
    "paged_attention_decode": {"torch": pa.paged_attention_decode_torch,
                               "cuda": pa.paged_attention_decode_cuda,
                               "meta": pa.paged_attention_decode_meta},
    "coalesce_pair": {"torch": cp.coalesce_pair_torch,
                      "cuda": cp.coalesce_pair_cuda,
                      "meta": cp.coalesce_pair_meta},
    "interp_axpy": {"torch": ia.interp_axpy_torch,
                    "cuda": ia.interp_axpy_cuda,
                    "meta": ia.interp_axpy_meta},
}


def ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    return backend


def resolve_backend(op: str, device: torch.device, backend: Optional[str] = None,
                    config: Optional[str] = None) -> str:
    """Backend name for ``op`` on tensors living on ``device``."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {ops()}")
    b = backend or config or os.environ.get(ENV_VAR) or (
        device.type if device.type in ("cuda", "meta") else "torch")
    validate_backend(b)
    if b in ("cuda", "meta") and device.type != b:
        raise ValueError(f"op {op!r}: backend {b!r} needs {b.upper() if b == 'cuda' else b} "
                         f"tensors, got a tensor on {device}")
    return b


def dispatch(op: str, *args, backend: Optional[str] = None,
             config: Optional[str] = None, **kw):
    """Resolve ``op`` from its first tensor argument's device and call it."""
    return _REGISTRY[op][resolve_backend(op, args[0].device, backend, config)](*args, **kw)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    backend: Optional[str] = None, config: Optional[str] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention in the layer layout (q [B,S,H,D],
    k [B,T,KH,D], v [B,T,KH,Dv] -> out [B,S,H,Dv]): one backend's forward
    and backward through ``FlashAttention``.  Under ``causal`` query row i
    reads keys ``0..q_offset + i``."""
    b = resolve_backend("flash_attention", q.device, backend, config)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return fa.FlashAttention.apply(q, k, v, causal, scale,
                                   _REGISTRY["flash_attention"][b],
                                   _REGISTRY["flash_attention_bwd"][b], q_offset)
