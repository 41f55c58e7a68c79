"""GQA attention for training, prefill and paged decode (the counterpart of
the GQA parts of ``repro/layers/attention.py``).

Two attention computations:
  * ``plain_attention`` -- materialized scores; decode, short sequences, and
                           the paged multi-token (prefix-extend) step
  * the flash op        -- ``kernels/dispatch.py::flash_attention``: the
                           CUDA kernels (forward and backward) on the card,
                           their plain versions on CPU

``run_attention`` keeps the reference's routing thresholds.  Softmax runs in
f32 with compute-dtype matmul inputs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.layers.basic import apply_rope, rms_norm
from repro_torch.param import Spec

NEG_INF = -1e30
FLASH_IMPLS = ("blockwise", "pallas", "pairs")  # attn_impl values routed to flash


def paged_write(pages: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
                block_tables: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` [B,S,...] into ``pages`` [N,P,...] at absolute
    ``positions`` [B,S] routed through per-sequence ``block_tables`` [B,M].

    Writes IN PLACE and returns ``pages`` (the reference returns an updated
    copy).  Touches only the pages the written tokens land in.  Position -1
    marks a padding slot; its write goes to page 0, the pool's reserved null
    page that no request ever owns.
    """
    P = pages.shape[1]
    valid = positions >= 0
    pos = positions.clamp_min(0)
    page_ix = (pos // P).clamp_max(block_tables.shape[1] - 1)
    pid = torch.gather(block_tables, 1, page_ix)
    pid = torch.where(valid, pid, torch.zeros_like(pid))
    off = torch.where(valid, pos % P, torch.zeros_like(pos))
    pages[pid, off] = new.to(pages.dtype)
    return pages


# ---------------------------------------------------------------------------
# core attention computations


def _mask(qp: torch.Tensor, tp: torch.Tensor, causal: bool) -> torch.Tensor:
    """qp: [B,S] query positions, tp: [T] key positions -> [B,S,T] bool."""
    if not causal:
        return torch.ones(qp.shape + (tp.shape[0],), dtype=torch.bool, device=qp.device)
    return tp[None, None, :] <= qp[:, :, None]


def plain_attention(q, k, v, *, causal: bool, scale: float, q_positions=None) -> torch.Tensor:
    """q: [B,S,KH,G,Dq], k: [B,T,KH,Dq], v: [B,T,KH,Dv] -> [B,S,KH,G,Dv]."""
    B, S = q.shape[:2]
    T = k.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device)[None].expand(B, S)
    m = _mask(q_positions, torch.arange(T, device=q.device), causal)  # [B,S,T]
    s = s.masked_fill(~m[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkv->bskgv", p.to(v.dtype), v)


def _flash_attention(q, k, v, *, causal: bool, scale: float,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Adapter from the layer layout [B,S,KH,G,D] to the flash op, the
    counterpart of the reference's ``_flash_pallas``.  The op takes the
    [B,S,H,D] layout as it is and reads kv head ``h // G`` itself, so no
    transpose and no GQA broadcast is made here; its backward sums dk/dv
    over the groups."""
    B, S, KH, G, D = q.shape
    out = kdispatch.flash_attention(q.reshape(B, S, KH * G, D), k, v, causal=causal,
                                    scale=scale, config=backend)
    return out.reshape(B, S, KH, G, -1)


def run_attention(q, k, v, cfg: ModelConfig, *, causal: bool, scale: float,
                  q_positions=None, decode: bool = False) -> torch.Tensor:
    S, T = q.shape[1], k.shape[1]
    if decode or S <= 128 or T <= cfg.attn_block_k or cfg.attn_impl not in FLASH_IMPLS:
        return plain_attention(q, k, v, causal=causal, scale=scale, q_positions=q_positions)
    # every flash-style impl computes the same function; the kernel takes any
    # S and T (ragged tails masked), so there is no untileable fallback
    return _flash_attention(q, k, v, causal=causal, scale=scale,
                            backend=cfg.kernel_backend or None)


# ---------------------------------------------------------------------------
# GQA layer


def gqa_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": Spec((E, H, D), ("embed", "heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wk": Spec((E, KH, D), ("embed", "kv_heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wv": Spec((E, KH, D), ("embed", "kv_heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wo": Spec((H, D, E), ("heads", "head_dim", "embed"), ("in", "-", "out"), init="fan_in"),
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((D,), ("head_dim",), ("-",), init="ones")
        s["k_norm"] = Spec((D,), ("head_dim",), ("-",), init="ones")
    if cfg.use_bias:
        s["bq"] = Spec((H, D), ("heads", "head_dim"), ("out", "-"), init="zeros")
        s["bk"] = Spec((KH, D), ("kv_heads", "head_dim"), ("out", "-"), init="zeros")
        s["bv"] = Spec((KH, D), ("kv_heads", "head_dim"), ("out", "-"), init="zeros")
        s["bo"] = Spec((E,), ("embed",), ("out",), init="zeros")
    return s


def gqa_paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> Dict[str, Spec]:
    """Page-pool K/V leaves: ``[n_pages, page_size, KH, D]`` shared across all
    sequences (block tables route each sequence to its pages)."""
    KH, D = cfg.n_kv_heads, cfg.resolved_head_dim
    ax = ("pages", "page_seq", "cache_kv_heads", "head_dim")
    dt = cfg.compute_dtype
    return {
        "k": Spec((n_pages, page_size, KH, D), ax, init="zeros", dtype=dt),
        "v": Spec((n_pages, page_size, KH, D), ax, init="zeros", dtype=dt),
    }


def _paged_gqa_attention(qg, cache_k, cache_v, cfg: ModelConfig, *,
                         positions: torch.Tensor, block_tables: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """qg: [B,S,KH,G,D] against paged K/V [N,P,KH,D] -> [B,S,KH,G,D].

    S == 1 (decode) dispatches to the ``paged_attention_decode`` op; S > 1
    (prefix-extend prefill) gathers the table's pages and runs the plain
    masked attention.  Either way work scales with the pages the batch spans.
    """
    B, S = qg.shape[:2]
    P = cache_k.shape[1]
    M = block_tables.shape[1]
    if S == 1:
        lengths = positions[:, -1] + 1  # the just-written token is attendable
        out = kdispatch.dispatch("paged_attention_decode", qg[:, 0], cache_k, cache_v,
                                 block_tables, lengths, scale=scale,
                                 config=cfg.kernel_backend or None)
        return out[:, None]
    k = cache_k[block_tables].reshape(B, M * P, *cache_k.shape[2:])
    v = cache_v[block_tables].reshape(B, M * P, *cache_v.shape[2:])
    return plain_attention(qg, k, v, causal=True, scale=scale, q_positions=positions)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,ehd->bshd") as one matmul."""
    B, S, E = x.shape
    return (x @ w.reshape(E, -1)).view(B, S, *w.shape[1:])


def _out_project(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshd,hde->bse") as one matmul."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])


def gqa_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B,S] absolute positions (rope + causal mask)
    causal: bool,
    use_rope: bool = True,
    cache: Optional[Dict] = None,
    block_tables: Optional[torch.Tensor] = None,  # [B,M]: cache is paged
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, E = x.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = cfg.compute_dtype
    q = _project(x, p["wq"].to(cdt))
    k = _project(x, p["wk"].to(cdt))
    v = _project(x, p["wv"].to(cdt))
    if cfg.use_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        if block_tables is None:
            raise NotImplementedError("dense decode caches are not ported; "
                                      "serve through the paged engine")
        # paged decode/extend: write the new tokens' K/V into their pages,
        # then attend through the block table
        ck = paged_write(cache["k"], k, positions, block_tables)
        cv = paged_write(cache["v"], v, positions, block_tables)
        qg = q.reshape(B, S, KH, H // KH, D)
        out = _paged_gqa_attention(qg, ck, cv, cfg, positions=positions,
                                   block_tables=block_tables, scale=D ** -0.5)
        y = _out_project(out, p["wo"].to(cdt))
        if cfg.use_bias:
            y = y + p["bo"].to(cdt)
        return y, {"k": ck, "v": cv}

    qg = q.reshape(B, S, KH, H // KH, D)
    out = run_attention(qg, k, v, cfg, causal=causal, scale=D ** -0.5,
                        q_positions=positions)
    y = _out_project(out, p["wo"].to(cdt))
    if cfg.use_bias:
        y = y + p["bo"].to(cdt)
    return y, None
