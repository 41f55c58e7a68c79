"""Plain PyTorch oracles for the kernels (the counterparts of
``repro/kernels/ref.py``): f32 softmax, exact zeros for a length-0 row.

Math runs in f32 for f32 and bf16 inputs and in f64 for f64 inputs (which
only ``torch.autograd.gradcheck`` feeds them)."""
from __future__ import annotations

from typing import Optional

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the oracles compute in: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def causal_mask(S: int, T: int, q_offset: int, device) -> torch.Tensor:
    """[S, T] bool: query row i may read key j iff ``j <= q_offset + i``."""
    return (torch.arange(T, device=device)[None, :]
            <= torch.arange(S, device=device)[:, None] + q_offset)


def naive_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False, q_offset: int = 0):
    """q: [B,H,S,D], k: [B,H,T,D], v: [B,H,T,Dv] -> [B,H,S,Dv]; f32 softmax.

    Under ``causal`` query row i reads keys ``0..q_offset + i``.

    With ``return_lse`` also the row log-sum-exp of the scaled, masked scores
    ([B,H,S] f32), which the flash forward emits for its backward.
    """
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    acc = acc_dtype(q.dtype)
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bhsd,bhtd->bhst", q.to(acc), k.to(acc)) * scale
    if causal:
        s = s.masked_fill(~causal_mask(S, T, q_offset, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtv->bhsv", p, v.to(acc)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale: Optional[float] = None):
    """Gather-based paged decode attention (the block-table oracle).

    q: [B,KH,G,D], k_pages: [N,P,KH,D], v_pages: [N,P,KH,Dv],
    block_tables: [B,M] int, lengths: [B] int -> [B,KH,G,Dv].

    Reassembles each sequence's K/V through its block table, masks positions
    >= length and runs one f32 softmax.  A length-0 row (idle slot) yields
    exact zeros, the convention the CUDA kernel pins too.
    """
    B, KH, G, D = q.shape
    N, P, _, Dv = v_pages.shape
    M = block_tables.shape[1]
    scale = D ** -0.5 if scale is None else scale
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, M * P, KH, D)
    v = v_pages[bt].reshape(B, M * P, KH, Dv)
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * scale
    valid = (torch.arange(M * P, device=q.device)[None, :]
             < lengths.long().to(q.device)[:, None])  # [B, T]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))  # empty rows -> 0
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkv->bkgv", p / l, v.float())
    return out.to(q.dtype)


def coalesce_pair_ref(w: torch.Tensor, *, axis: int, w0: float = 0.5) -> torch.Tensor:
    """Dense F-matrix oracle: F = [w0*I ; w0*I] contraction along ``axis``."""
    n = w.shape[axis]
    half = n // 2
    F = torch.zeros((n, half), dtype=torch.float32, device=w.device)
    idx = torch.arange(half, device=w.device)
    F[idx, idx] = w0
    F[idx + half, idx] = w0
    if axis == 0:
        return torch.einsum("nm,nc->mc", F, w.float()).to(w.dtype)
    return torch.einsum("rn,nm->rm", w.float(), F).to(w.dtype)


def interp_axpy_ref(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    return ((1.0 - alpha) * a.float() + alpha * b.float()).to(a.dtype)
