"""Flash attention, forward and backward: the CUDA kernels, their plain
PyTorch versions and the ``FlashAttention`` autograd Function.

The counterpart of ``repro/kernels/flash_attention.py`` (the Pallas
``_flash_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind
``flash_attention_with_vjp``).  Every version takes the layer layout
``q [B,S,H,D]``, ``k [B,T,KH,D]`` and ``v [B,T,KH,Dv]`` with ``H % KH == 0``
and query head ``h`` attending kv head ``h // (H // KH)`` (GQA without a
broadcast copy).  The value head dim may differ from the query/key one, as
MLA's does (D = nope + rope = 192, Dv = 128 at DeepSeek-V3's widths).  The
forward returns ``(out [B,S,H,Dv], lse [B,H,S] f32)``; the backward takes
``(q, k, v, out, lse, do)`` and returns ``(dq, dk, dv)`` with dk/dv summed
over the G query heads of each kv head.  Causal masking is aligned at a
query offset: query ``i`` attends keys ``0..q_offset + i`` (0, the default,
is the top-left mask of S == T; a context-parallel rank passes the first
row of its chunk, so ``q_offset + S <= T``).  Without ``causal`` the offset
is ignored.

The kernel sources are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``.  The raw CUDA wrappers write through
pointers and record no gradient, so ``flash_attention_cuda`` refuses to run
where autograd would expect one; training goes through ``FlashAttention``
(``kernels/dispatch.py::flash_attention``), whose backward is the kernel's
own backward.  In bf16 the forward and both backward kernels (dq, dk/dv)
run on the tensor cores and copy 16-byte rows, so their inputs must pass
``check_mma_layout``; f32 inputs take the scalar f32 bodies.  The kernels
are built for three (D, Dv) pairs, ``HEAD_DIMS``; any other pair raises
before anything is built.

Each launch, and each call of the meta forms (``flash_attention_meta``,
``flash_attention_bwd_meta``: outputs of the kernels' shapes and types on
the meta device, nothing computed), reports the work of the cost functions
below to ``kernels/cost.py``: the operations and bytes that the kernel's
bound in ``chip_smoke.py`` counts.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import build, cost, ref

# storage type -> the dtype code of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the (query/key head dim, value head dim) pairs the C entry points
# instantiate: GPT/BERT/TinyLlama heads, Phi-3.5-MoE's and Qwen3's, and MLA's
# (nope 128 + rope 64, v 128)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))


def attention_pairs(B: int, S: int, T: int, H: int, causal: bool, q_offset: int) -> float:
    """The (query row, key) pairs the kernels compute: under ``causal`` the
    pairs on and below the diagonal, which row r of a chunk at ``q_offset``
    reaches at key ``q_offset + r``; else every pair."""
    return B * H * (S * q_offset + S * (S + 1) / 2) if causal else B * H * S * T


def _rows(B, S, T, H, KH, D, Dv):
    """(q rows, out rows, K and V, one f32 [B,H,S] statistic) in elements
    (the statistic in bytes)."""
    return B * S * H * D, B * S * H * Dv, B * T * KH * (D + Dv), 4 * B * H * S


def flash_fwd_cost(B, S, T, H, KH, D, Dv, *, causal: bool, q_offset: int = 0,
                   itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the forward: S = Q K^T over D and O = P V over
    Dv (2 per multiply-add) per pair; q, K/V and out read or written once at
    ``itemsize`` bytes and the f32 lse written once."""
    pairs = attention_pairs(B, S, T, H, causal, q_offset)
    q_rows, o_rows, kv, stats = _rows(B, S, T, H, KH, D, Dv)
    return 2.0 * (D + Dv) * pairs, itemsize * (q_rows + kv + o_rows) + stats


def flash_bwd_dq_cost(B, S, T, H, KH, D, Dv, *, causal: bool, q_offset: int = 0,
                      itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the dq kernel: S and dQ = dS K over D, dP =
    dO V^T over Dv per pair; q, dq, K/V, out, do once, lse read and delta
    written."""
    pairs = attention_pairs(B, S, T, H, causal, q_offset)
    q_rows, o_rows, kv, stats = _rows(B, S, T, H, KH, D, Dv)
    return (2.0 * (2 * D + Dv) * pairs,
            itemsize * (2 * q_rows + kv + 2 * o_rows) + 2 * stats)


def flash_bwd_dkv_cost(B, S, T, H, KH, D, Dv, *, causal: bool, q_offset: int = 0,
                       itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the dk/dv kernel: S and dK = dS^T Q over D, dP
    and dV = P^T dO over Dv per pair; q, do, K/V read and dK/dV written
    once, lse and delta read."""
    pairs = attention_pairs(B, S, T, H, causal, q_offset)
    q_rows, o_rows, kv, stats = _rows(B, S, T, H, KH, D, Dv)
    return 4.0 * (D + Dv) * pairs, itemsize * (q_rows + o_rows + 2 * kv) + 2 * stats


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None, q_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: broadcast K/V over the query groups, then the f32
    reference attention."""
    H, KH = q.shape[2], k.shape[2]
    G = H // KH
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    out, lse = ref.naive_attention(q.transpose(1, 2), kh, vh, causal=causal,
                                   scale=scale, return_lse=True, q_offset=q_offset)
    return out.transpose(1, 2).contiguous(), lse


def flash_attention_bwd_torch(q, k, v, out, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None, q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the flash recipe of the reference's
    ``_bwd_call`` in torch ops: P recomputed from ``lse``,
    ``delta = rowsum(do * out)``, ``dS = P * (dP - delta) * scale``; dk and
    dv summed over the G query heads of each kv head."""
    B, S, H, D = q.shape
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    acc = ref.acc_dtype(q.dtype)
    scale = D ** -0.5 if scale is None else scale
    qh = q.transpose(1, 2).to(acc)  # [B,H,S,D]
    kh = k.transpose(1, 2).to(acc).repeat_interleave(G, dim=1)  # [B,H,T,D]
    vh = v.transpose(1, 2).to(acc).repeat_interleave(G, dim=1)  # [B,H,T,Dv]
    doh = do.transpose(1, 2).to(acc)  # [B,H,S,Dv]
    delta = (doh * out.transpose(1, 2).to(acc)).sum(-1)  # [B,H,S], over Dv
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~ref.causal_mask(S, T, q_offset, q.device), float("-inf"))
    p = torch.exp(s - lse.to(acc)[..., None])  # masked scores give exact 0
    dv = p.transpose(-1, -2) @ doh  # [B,H,T,Dv]
    ds = p * ((doh @ vh.transpose(-1, -2)) - delta[..., None]) * scale
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dk = dk.view(B, KH, G, T, D).sum(2).transpose(1, 2)
    dv = dv.view(B, KH, G, T, Dv).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def check_cuda_inputs(op: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{op}: the CUDA kernel needs all tensors on one "
                             f"CUDA device, got {[str(x.device) for x in tensors]}")


def _attention_dims(op: str, q, k, v, causal: bool = False, q_offset: int = 0
                    ) -> Tuple[int, int, int, int, int, int, int]:
    """(B, S, T, H, KH, D, Dv) of a q/k/v triple of the shapes and types the
    kernels take; raises on anything else (a negative ``q_offset``, or
    ``q_offset + S > T`` under ``causal``), on any device."""
    B, S, H, D = q.shape
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if q_offset < 0 or (causal and q_offset + S > T):
        raise ValueError(f"{op}: q_offset {q_offset} with S {S} and T {T}; need "
                         f"0 <= q_offset and, under causal, q_offset + S <= T")
    if k.shape != (B, T, KH, D) or v.shape != (B, T, KH, Dv):
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if H % KH:
        raise ValueError(f"{op}: {H} query heads not a multiple of {KH}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"{op}: head dims (D {D}, Dv {Dv}) unsupported; the kernels "
                         f"are built for {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{op}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"need one of {tuple(DTYPE_CODES)} for all three")
    return B, S, T, H, KH, D, Dv


def _attention_shapes(op: str, q, k, v, causal: bool = False, q_offset: int = 0
                      ) -> Tuple[int, int, int, int, int, int, int]:
    """:func:`_attention_dims` of CUDA tensors on one card in the layouts
    the bodies copy; raises on anything else, before any build."""
    dims = _attention_dims(op, q, k, v, causal, q_offset)
    check_cuda_inputs(op, q, k, v)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{op}: the head_dim axis must be contiguous")
    check_mma_layout(op, q=q, k=k, v=v)
    return dims


def check_mma_layout(op: str, **tensors: torch.Tensor) -> None:
    """The bf16 bodies copy whole 16-byte rows with cp.async: each bf16
    tensor needs a 16-byte aligned base and, above its contiguous last
    axis, strides that are multiples of 8 elements (on axes longer than 1).  Raises a ValueError naming the
    tensor; there is no slower path to fall back to.  f32 tensors go to the
    scalar bodies, which take any layout with a contiguous last axis."""
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: bf16 {name} starts at an address that is not "
                             f"16-byte aligned (offset {t.data_ptr() % 16})")
        bad = [s for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1 and s % 8]
        if bad:
            raise ValueError(f"{op}: bf16 {name} has strides {tuple(t.stride())}; every "
                             f"stride must be a multiple of 8 elements")


def _qkv_strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None, q_offset: int = 0
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
    B, S, T, H, KH, D, Dv = _attention_shapes("flash_attention", q, k, v, causal, q_offset)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return out, lse
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, Dv, *_qkv_strides(q, k, v),
            float(scale), int(causal), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    if cost.active():
        cost.record("flash_attention_fwd", *flash_fwd_cost(
            B, S, T, H, KH, D, Dv, causal=causal, q_offset=q_offset, itemsize=q.element_size()))
    return out, lse


flash_attention_cuda.launches = 0


def _check_rows(op: str, q, v, rows, stats) -> None:
    """``rows`` (out, do) must be contiguous [B,S,H,Dv] in q's type and
    ``stats`` (lse, delta) contiguous [B,H,S] f32, all on q's card."""
    B, S, H, _ = q.shape
    Dv = v.shape[-1]
    check_cuda_inputs(op, q, *rows, *stats)
    for t in rows:
        if t.shape != (B, S, H, Dv) or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{op}: got {tuple(t.shape)} {t.dtype}, want contiguous "
                             f"{(B, S, H, Dv)} {q.dtype}")
    for t in stats:
        if t.shape != (B, H, S) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op}: got {tuple(t.shape)} {t.dtype}, want contiguous "
                             f"{(B, H, S)} float32")


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, *, causal: bool = True,
                                scale: Optional[float] = None, q_offset: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_bwd_dq``: returns ``(dq, delta)``, where
    ``delta [B,H,S] f32 = rowsum(do * out)`` is computed by the same kernel
    for ``flash_attention_bwd_dkv_cuda``.

    bf16 runs on the tensor cores (``flash_bwd_dq_mma_kernel``): dS is
    rounded to bf16 before dS·K, and ``out`` and ``do`` are copied in 16-byte
    rows, so they must pass ``check_mma_layout`` as q, k and v do; a bad
    layout raises.  f32 takes the scalar f32 body.  Each block owns its
    rows and uses no atomics, so two launches give the same bits."""
    B, S, T, H, KH, D, Dv = _attention_shapes("flash_attention_bwd_dq", q, k, v, causal,
                                              q_offset)
    _check_rows("flash_attention_bwd_dq", q, v, (out, do), (lse,))
    check_mma_layout("flash_attention_bwd_dq", out=out, do=do)
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
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, Dv, *_qkv_strides(q, k, v),
            float(scale), int(causal), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1
    if cost.active():
        cost.record("flash_attention_bwd_dq", *flash_bwd_dq_cost(
            B, S, T, H, KH, D, Dv, causal=causal, q_offset=q_offset, itemsize=q.element_size()))
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                                 scale: Optional[float] = None, q_offset: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_bwd_dkv``: returns ``(dk, dv)`` in the
    [B,T,KH,D] and [B,T,KH,Dv] layouts, each summed over the G query heads
    of its kv head inside one block (no atomics, so the result is the same
    every run).  At (D, Dv) = (192, 128) the entry point runs the body twice,
    dV then dK (see ``csrc/flash_attention_bwd.cu``); it is one launch of
    this wrapper either way."""
    B, S, T, H, KH, D, Dv = _attention_shapes("flash_attention_bwd_dkv", q, k, v, causal,
                                              q_offset)
    _check_rows("flash_attention_bwd_dkv", q, v, (do,), (lse, delta))
    check_mma_layout("flash_attention_bwd_dkv", do=do)
    scale = D ** -0.5 if scale is None else scale
    dk = torch.empty((B, T, KH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KH, Dv), dtype=v.dtype, device=q.device)
    if T == 0 or B == 0:
        return dk, dv
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, T, H, KH, D, Dv, *_qkv_strides(q, k, v),
            float(scale), int(causal), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1
    if cost.active():
        cost.record("flash_attention_bwd_dkv", *flash_bwd_dkv_cost(
            B, S, T, H, KH, D, Dv, causal=causal, q_offset=q_offset, itemsize=q.element_size()))
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, do, *, causal: bool = True,
                             scale: Optional[float] = None, q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: the dq kernel (which also writes delta),
    then the dk/dv kernel, on the current stream."""
    do = do.contiguous()
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal,
                                            scale=scale, q_offset=q_offset)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                                          scale=scale, q_offset=q_offset)
    return dq, dk, dv


def flash_attention_meta(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                         q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's meta form: ``out`` and ``lse`` as ``flash_attention_cuda``
    allocates them, nothing computed; reports the forward's cost."""
    B, S, T, H, KH, D, Dv = _attention_dims("flash_attention", q, k, v, causal, q_offset)
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    cost.record("flash_attention_fwd", *flash_fwd_cost(
        B, S, T, H, KH, D, Dv, causal=causal, q_offset=q_offset, itemsize=q.element_size()))
    return out, lse


def flash_attention_bwd_meta(q, k, v, out, lse, do, *, causal: bool = True,
                             scale: Optional[float] = None, q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's meta form: what ``flash_attention_bwd_cuda``
    allocates (``do`` made contiguous, dq and delta, dk and dv), nothing
    computed; reports the dq and the dk/dv kernels' costs."""
    B, S, T, H, KH, D, Dv = _attention_dims("flash_attention_bwd", q, k, v, causal, q_offset)
    do = do.contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    kw = dict(causal=causal, q_offset=q_offset, itemsize=q.element_size())
    cost.record("flash_attention_bwd_dq", *flash_bwd_dq_cost(B, S, T, H, KH, D, Dv, **kw))
    dk = torch.empty((B, T, KH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KH, Dv), dtype=v.dtype, device=q.device)
    cost.record("flash_attention_bwd_dkv", *flash_bwd_dkv_cost(B, S, T, H, KH, D, Dv, **kw))
    del delta
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
    def forward(ctx, q, k, v, causal: bool, scale: float, fwd: Callable, bwd: Callable,
                q_offset: int = 0):
        out, lse = fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.bwd, ctx.q_offset = causal, scale, bwd, q_offset
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale,
                             q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None, None
