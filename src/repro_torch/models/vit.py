"""ViT / DeiT classifier on patch embeddings (the counterpart of
``repro/models/vit.py``): the paper's DeiT-B arm (Table 3).

A patch projection, a CLS token and learned positions feed the stacked
encoder blocks of ``models/lm.py`` (``enc_attn``: bidirectional); the
logits come from the CLS row, in f32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import fsdp
from repro_torch.layers.basic import norm_apply, norm_specs
from repro_torch.models.lm import _stack, block_specs, run_stages
from repro_torch.param import Spec


def n_patches(cfg: ModelConfig) -> int:
    return (cfg.image_size // cfg.patch_size) ** 2


def patch_dim(cfg: ModelConfig) -> int:
    return cfg.patch_size * cfg.patch_size * 3


def vit_specs(cfg: ModelConfig) -> Dict[str, Any]:
    N = n_patches(cfg)
    return {
        "patch_proj": Spec((patch_dim(cfg), cfg.d_model), ("patch", "embed"), ("-", "out"),
                           init="fan_in"),
        "cls": Spec((1, cfg.d_model), ("seq", "embed"), ("-", "out"), init="normal", scale=0.02),
        "pos": Spec((N + 1, cfg.d_model), ("seq", "embed"), ("-", "out"), init="normal",
                    scale=0.02),
        "stages": {
            f"stage_{i}": {f"b{j}": _stack(block_specs(cfg, bsj), st.repeats)
                           for j, bsj in enumerate(st.pattern)}
            for i, st in enumerate(cfg.stages)
        },
        "final_norm": norm_specs(cfg),
        "head": Spec((cfg.d_model, cfg.n_classes), ("embed", "classes"), ("in", "-"),
                     init="fan_in"),
    }


@functools.lru_cache(maxsize=16)
def _outside_layout(cfg: ModelConfig, mesh):
    """``fsdp.layout`` of the leaves outside the stacks, gathered once a
    forward."""
    return fsdp.outside_stacks(fsdp.layout(vit_specs(cfg), mesh))


def vit_forward(params: Dict, patches: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """patches: [B, N, patch_dim] -> logits [B, n_classes] (f32)."""
    B, N, _ = patches.shape
    cdt = cfg.compute_dtype
    mesh = fsdp.per_layer()
    if mesh is not None:  # the leaves outside the stacks; the blocks gather per layer
        params = fsdp.gather_tree(params, _outside_layout(cfg, mesh), mesh)
    x = patches.to(cdt) @ params["patch_proj"].to(cdt)
    cls = params["cls"].to(cdt).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cdt)[None, :N + 1]
    positions = torch.arange(N + 1, device=x.device)[None].expand(B, N + 1)
    x, _, _ = run_stages(params["stages"], cfg.stages, x, cfg, positions=positions, mode="train")
    x = norm_apply(params["final_norm"], x, cfg)
    return (x[:, 0] @ params["head"].to(cdt)).float()


def vit_loss(logits: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy, {"loss", "acc"})."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (lse - ll).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}
