"""Flash attention, forward and backward: the CUDA kernels, their plain
PyTorch versions and the ``FlashAttention`` autograd Function.

The counterpart of ``repro/kernels/flash_attention.py`` (the Pallas
``_flash_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind
``flash_attention_with_vjp``).  Every version takes the layer layout
``q [B,S,H,D]``, ``k``/``v`` ``[B,T,KH,D]`` with ``H % KH == 0`` and query
head ``h`` attending kv head ``h // (H // KH)`` (GQA without a broadcast
copy).  The forward returns ``(out [B,S,H,D], lse [B,H,S] f32)``; the
backward takes ``(q, k, v, out, lse, do)`` and returns ``(dq, dk, dv)`` with
dk/dv summed over the G query heads of each kv head.  Causal masking is
top-left aligned: query ``i`` attends keys ``0..i``.

The kernel sources are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``.  The raw CUDA wrappers write through
pointers and record no gradient, so ``flash_attention_cuda`` refuses to run
where autograd would expect one; training goes through ``FlashAttention``
(``kernels/dispatch.py::flash_attention``), whose backward is the kernel's
own backward.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def flash_attention_bwd_torch(q, k, v, out, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the flash recipe of the reference's
    ``_bwd_call`` in torch ops: P recomputed from ``lse``,
    ``delta = rowsum(do * out)``, ``dS = P * (dP - delta) * scale``; dk and
    dv summed over the G query heads of each kv head."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    acc = ref.acc_dtype(q.dtype)
    scale = D ** -0.5 if scale is None else scale
    qh = q.transpose(1, 2).to(acc)  # [B,H,S,D]
    kh = k.transpose(1, 2).to(acc).repeat_interleave(G, dim=1)  # [B,H,T,D]
    vh = v.transpose(1, 2).to(acc).repeat_interleave(G, dim=1)
    doh = do.transpose(1, 2).to(acc)
    delta = (doh * out.transpose(1, 2).to(acc)).sum(-1)  # [B,H,S]
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - lse.to(acc)[..., None])  # masked scores give exact 0
    dv = p.transpose(-1, -2) @ doh  # [B,H,T,D]
    ds = p * ((doh @ vh.transpose(-1, -2)) - delta[..., None]) * scale
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dk = dk.view(B, KH, G, T, D).sum(2).transpose(1, 2)
    dv = dv.view(B, KH, G, T, D).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def check_cuda_inputs(op: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{op}: the CUDA kernel needs all tensors on one "
                             f"CUDA device, got {[str(x.device) for x in tensors]}")


def _attention_shapes(op: str, q, k, v) -> Tuple[int, int, int, int, int, int]:
    """(B, S, T, H, KH, D) of a q/k/v triple the kernels take; raises on
    anything else."""
    check_cuda_inputs(op, q, k, v)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, D) or v.shape != k.shape:
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree (Dv must equal D)")
    if H % KH:
        raise ValueError(f"{op}: {H} query heads not a multiple of {KH}")
    if D not in (64, 128):
        raise ValueError(f"{op}: head_dim {D} unsupported (64 or 128)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{op}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"need one of {tuple(DTYPE_CODES)} for all three")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{op}: the head_dim axis must be contiguous")
    return B, S, T, H, KH, D


def _qkv_strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_fwd`` on the current stream (no fallback:
    a bad input, a failed build or a refused launch raises).

    Raises where autograd is recording and an input requires grad: the
    output would carry no gradient back to q/k/v.  Use ``FlashAttention``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda records no gradient; with grad "
                           "enabled call it through FlashAttention "
                           "(kernels.dispatch.flash_attention)")
    B, S, T, H, KH, D = _attention_shapes("flash_attention", q, k, v)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return out, lse
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, *_qkv_strides(q, k, v),
            float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0


def _check_rows(op: str, q, rows, stats) -> None:
    """``rows`` (out, do) must be contiguous [B,S,H,D] in q's type and
    ``stats`` (lse, delta) contiguous [B,H,S] f32, all on q's card."""
    B, S, H, D = q.shape
    check_cuda_inputs(op, q, *rows, *stats)
    for t in rows:
        if t.shape != (B, S, H, D) or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{op}: got {tuple(t.shape)} {t.dtype}, want contiguous "
                             f"{(B, S, H, D)} {q.dtype}")
    for t in stats:
        if t.shape != (B, H, S) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op}: got {tuple(t.shape)} {t.dtype}, want contiguous "
                             f"{(B, H, S)} float32")


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, *, causal: bool = True,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_bwd_dq``: returns ``(dq, delta)``, where
    ``delta [B,H,S] f32 = rowsum(do * out)`` is computed by the same kernel
    for ``flash_attention_bwd_dkv_cuda``."""
    B, S, T, H, KH, D = _attention_shapes("flash_attention_bwd_dq", q, k, v)
    _check_rows("flash_attention_bwd_dq", q, (out, do), (lse,))
    scale = D ** -0.5 if scale is None else scale
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return dq, delta
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, *_qkv_strides(q, k, v),
            float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_bwd_dkv``: returns ``(dk, dv)`` in the
    [B,T,KH,D] layout, each summed over the G query heads of its kv head
    inside one block (no atomics, so the result is the same every run)."""
    B, S, T, H, KH, D = _attention_shapes("flash_attention_bwd_dkv", q, k, v)
    _check_rows("flash_attention_bwd_dkv", q, (do,), (lse, delta))
    scale = D ** -0.5 if scale is None else scale
    dk = torch.empty((B, T, KH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KH, D), dtype=v.dtype, device=q.device)
    if T == 0 or B == 0:
        return dk, dv
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, *_qkv_strides(q, k, v),
            float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, do, *, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: the dq kernel (which also writes delta),
    then the dk/dv kernel, on the current stream."""
    do = do.contiguous()
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal,
                                            scale=scale)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                                          scale=scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward of the same backend: the forward
    saves ``(q, k, v, out, lse)`` and the backward recomputes P from
    ``lse`` (the reference's ``jax.custom_vjp`` around its Pallas kernels).

    ``fwd``/``bwd`` are one backend's pair (``flash_attention_cuda`` and
    ``flash_attention_bwd_cuda``, or the plain versions); the forward is
    deterministic, so a recompute under activation checkpointing gives the
    same ``out`` and ``lse``.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, fwd: Callable, bwd: Callable):
        out, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.bwd = causal, scale, bwd
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None
