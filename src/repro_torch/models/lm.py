"""Stage-based decoder LM for training, prefill and paged decode (the
counterpart of ``repro/models/lm.py``, attention mixers with dense FFNs).

Parameters are stacked per stage-pattern position with a leading "layers"
axis, as in the reference; ``run_stages`` walks that axis in a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import BlockSpec, ModelConfig, Stage
from repro_torch.layers import attention as attn
from repro_torch.layers import ffn as ffn_lib
from repro_torch.layers.basic import (apply_rope, embed_specs, embed_tokens, norm_apply,
                                      norm_specs, rms_norm, unembed)
from repro_torch.param import Spec, tree_map

SUPPORTED_MIXERS = ("attn",)
SUPPORTED_FFNS = ("dense",)


def _stack(tree, n: int):
    return tree_map(lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, ("-",) + s.roles,
                                   init=s.init, scale=s.scale, dtype=s.dtype), tree)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configs whose blocks the port lacks."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.name}: attn_type {cfg.attn_type!r} is not "
                                  f"ported (gqa only)")
    for st in cfg.stages:
        for bs in st.pattern:
            if bs.mixer not in SUPPORTED_MIXERS or bs.ffn not in SUPPORTED_FFNS:
                raise NotImplementedError(
                    f"{cfg.name}: block {bs.tag!r} is not ported (mixers "
                    f"{SUPPORTED_MIXERS}, ffns {SUPPORTED_FFNS})")
    if cfg.n_encoder_layers or cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}: encoder/MTP heads are not ported")


def block_specs(cfg: ModelConfig, bs: BlockSpec) -> Dict[str, Any]:
    """An attention + dense-FFN block (``check_supported`` admits no other)."""
    return {"norm1": norm_specs(cfg), "mixer": attn.gqa_specs(cfg),
            "norm2": norm_specs(cfg), "ffn": ffn_lib.ffn_specs(cfg)}


def paged_block_cache_specs(cfg: ModelConfig, bs: BlockSpec, n_pages: int,
                            page_size: int) -> Dict[str, Any]:
    """Block-table layout for the serving page pool (self-attention only)."""
    if bs.mixer != "attn":
        raise NotImplementedError(
            f"paged KV serving supports mixer 'attn' only, got {bs.mixer!r}")
    return {"self": attn.gqa_paged_cache_specs(cfg, n_pages, page_size)}


# ---------------------------------------------------------------------------
# per-block apply


def block_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    bs: BlockSpec,
    *,
    positions: torch.Tensor,
    mode: str,  # train | prefill | decode
    cache: Optional[Dict] = None,  # decode: this layer's page pools
    block_tables: Optional[torch.Tensor] = None,  # [B,M]: decode cache is paged
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x, cache): None in train mode, the fresh K/V in prefill
    mode, the updated page pools in decode mode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (train, prefill, decode)")
    decode = mode == "decode"
    h = norm_apply(p["norm1"], x, cfg)
    y, c_new = attn.gqa_apply(p["mixer"], h, cfg, positions=positions, causal=True,
                              cache=cache["self"] if decode else None,
                              block_tables=block_tables)
    x = x + y
    new_cache = None
    if mode != "train":
        new_cache = {"self": c_new if decode else _prefill_self_cache(p["mixer"], h, cfg,
                                                                       positions)}
    h = norm_apply(p["norm2"], x, cfg)
    x = x + ffn_lib.ffn_apply(p["ffn"], h, cfg)
    return x, new_cache


def _prefill_self_cache(p: Dict, h: torch.Tensor, cfg: ModelConfig, positions) -> Dict:
    """Recompute the (cheap, linear) K/V projections to fill the decode cache
    after a prefill forward."""
    cdt = cfg.compute_dtype
    k = attn._project(h, p["wk"].to(cdt))
    v = attn._project(h, p["wv"].to(cdt))
    if cfg.use_bias:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# whole-model specs


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    return {
        "embed": embed_specs(cfg),
        "stages": {
            f"stage_{i}": {f"b{j}": _stack(block_specs(cfg, bsj), st.repeats)
                           for j, bsj in enumerate(st.pattern)}
            for i, st in enumerate(cfg.stages)
        },
        "final_norm": norm_specs(cfg),
    }


def paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> Dict[str, Any]:
    """Whole-model page-pool specs: one ``[n_pages, page_size, ...]`` pool per
    stacked layer leaf, shared across requests via per-request block tables."""
    return {
        f"stage_{i}": {
            f"b{j}": _stack(paged_block_cache_specs(cfg, bsj, n_pages, page_size),
                            st.repeats)
            for j, bsj in enumerate(st.pattern)
        }
        for i, st in enumerate(cfg.stages)
    }


# ---------------------------------------------------------------------------
# forward


def _train_layer(p_l: Dict, x: torch.Tensor, cfg: ModelConfig, bs: BlockSpec,
                 positions: torch.Tensor) -> torch.Tensor:
    """One block in train mode, under ``cfg.remat``: "none" keeps its
    activations; "full" recomputes the block in the backward (the
    reference's ``jax.checkpoint`` of the scan body), so the flash forward
    runs twice per layer per step."""
    def fn(x):
        return block_apply(p_l, x, cfg, bs, positions=positions, mode="train")[0]

    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat {cfg.remat!r} is not ported (none, full)")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False)


def run_stages(
    params: Dict,
    stages: Tuple[Stage, ...],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    mode: str,
    caches: Optional[Dict] = None,  # decode: the page pools (written in place)
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Walk each stage's stacked ``layers`` axis.  Train returns no caches;
    prefill returns fresh caches stacked like the parameters
    ([layers, B, S, ...]); decode returns the page-pool tree it was given,
    updated in place."""
    new_caches: Dict[str, Any] = {}
    for i, st in enumerate(stages):
        p_st = params[f"stage_{i}"]
        c_st = caches[f"stage_{i}"] if mode == "decode" else None
        # unbind once per stage: its backward stacks the layers' gradients
        # in one pass (indexing per layer would scatter into a full-size
        # zero tensor per layer)
        p_layers = {f"b{j}": tree_map(lambda a: a.unbind(0), p_st[f"b{j}"])
                    for j in range(len(st.pattern))}
        per_layer: Dict[str, list] = {f"b{j}": [] for j in range(len(st.pattern))}
        for r in range(st.repeats):
            for j, bsj in enumerate(st.pattern):
                name = f"b{j}"
                p_l = tree_map(lambda a: a[r], p_layers[name])
                if mode == "train":
                    x = _train_layer(p_l, x, cfg, bsj, positions)
                    continue
                c_l = tree_map(lambda a: a[r], c_st[name]) if c_st is not None else None
                x, c_new = block_apply(p_l, x, cfg, bsj, positions=positions, mode=mode,
                                       cache=c_l, block_tables=block_tables)
                per_layer[name].append(c_new)
        if mode == "decode":
            new_caches[f"stage_{i}"] = c_st
        elif mode == "prefill":
            new_caches[f"stage_{i}"] = {
                name: tree_map(lambda *ls: torch.stack(ls), *cs)
                for name, cs in per_layer.items()}
    return x, (new_caches if mode != "train" else None)


def lm_forward(
    params: Dict,
    tokens: torch.Tensor,  # [B,S] int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B,S]; default arange
    mode: str = "train",
    caches: Optional[Dict] = None,
    # [B,M]: decode caches are paged.  S==1 is batched decode; S>1 with
    # explicit positions is the multi-token prefix-extend step (positions
    # == -1 mark padding: writes land on the null page, attention is masked)
    block_tables: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg)
    x, new_caches = run_stages(params["stages"], cfg.stages, x, cfg, positions=positions,
                               mode=mode, caches=caches, block_tables=block_tables)
    x = norm_apply(params["final_norm"], x, cfg)
    return {"logits": unembed(params["embed"], x, cfg), "caches": new_caches}


# ---------------------------------------------------------------------------
# losses


def lm_loss(logits: torch.Tensor,  # [B,S,V]
            labels: torch.Tensor,  # [B,S] int, -1 = ignore
            cfg: ModelConfig,
            z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy in f32 over the labels that are not -1
    (the reference's ``lm_loss`` for models without MoE or MTP heads).

    The logsumexp runs over every column of the padded vocabulary, the
    padding columns included, as in the reference; the label's logit is a
    gather, where the reference contracts with a one-hot (the same value)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.clamp_min(0).unsqueeze(-1)).squeeze(-1)
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    if z_loss:
        nll = nll + z_loss * lse.square() * mask
    loss = nll.sum() / mask.sum().clamp_min(1.0)
    return loss, {"ce": loss, "loss": loss}
