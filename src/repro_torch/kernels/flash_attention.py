"""Flash attention forward: the CUDA kernel and its plain PyTorch version.

The counterpart of the forward half of ``repro/kernels/flash_attention.py``
(the Pallas ``_flash_kernel``).  Both versions take the layer layout
``q [B,S,H,D]``, ``k``/``v`` ``[B,T,KH,D]`` with ``H % KH == 0`` and query
head ``h`` attending kv head ``h // (H // KH)`` (GQA without a broadcast
copy), and return ``(out [B,S,H,D], lse [B,H,S] f32)``.  Causal masking is
top-left aligned: query ``i`` attends keys ``0..i``.

The kernel source is ``csrc/flash_attention_fwd.cu``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

# storage type -> the dtype code of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: broadcast K/V over the query groups, then the f32
    reference attention."""
    H, KH = q.shape[2], k.shape[2]
    G = H // KH
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    out, lse = ref.naive_attention(q.transpose(1, 2), kh, vh, causal=causal,
                                   scale=scale, return_lse=True)
    return out.transpose(1, 2).contiguous(), lse


def check_cuda_inputs(op: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{op}: the CUDA kernel needs all tensors on one "
                             f"CUDA device, got {[str(x.device) for x in tensors]}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_fwd`` on the current stream (no fallback:
    a bad input, a failed build or a refused launch raises)."""
    check_cuda_inputs("flash_attention", q, k, v)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree (Dv must equal D)")
    if H % KH:
        raise ValueError(f"flash_attention: {H} query heads not a multiple of {KH}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {D} unsupported (64 or 128)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"need one of {tuple(DTYPE_CODES)} for all three")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis must be contiguous")
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return out, lse
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), float(scale),
            int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0
