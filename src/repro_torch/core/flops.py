"""Analytic FLOPs accounting (the counterpart of the FLOPs functions of
``repro/core/flops.py``; its energy layer is not ported).

The paper's evaluation axis: FLOPs-to-quality comparisons between the
V-cycle and training from scratch.  Only relative numbers matter, so one
consistent formula is applied to every arm; the functions are copies of the
reference's and give the same numbers for the same specs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.param import is_spec


def _walk(tree, path=()):
    if is_spec(tree):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _walk(v, path + (k,))


def active_matmul_params(cfg: ModelConfig, specs) -> float:
    """Parameters participating in per-token matmuls, with MoE expert weights
    scaled by top_k / n_experts (active fraction) and the embedding table
    counted once iff tied (the unembed matmul)."""
    total = 0.0
    moe_frac = (cfg.moe_top_k / cfg.n_experts) if cfg.n_experts else 1.0
    for path, s in _walk(specs):
        if len(s.shape) < 2:
            continue
        n = float(np.prod(s.shape))
        if "experts" in s.axes:
            n *= moe_frac
        total += n
    return total


def total_params(specs) -> float:
    return float(sum(np.prod(s.shape) for _, s in _walk(specs)))


def _attn_layers(cfg: ModelConfig):
    n_self = sum(st.repeats * sum(1 for b in st.pattern
                                  if b.mixer in ("attn", "dec_attn", "enc_attn"))
                 for st in cfg.stages)
    n_cross = sum(st.repeats * sum(1 for b in st.pattern if b.mixer in ("cross_attn", "dec_attn"))
                  for st in cfg.stages)
    n_rec = sum(st.repeats * sum(1 for b in st.pattern if b.mixer in ("mamba", "mlstm", "slstm"))
                for st in cfg.stages)
    return n_self, n_cross, n_rec


def forward_flops(cfg: ModelConfig, specs, batch: int, seq: int) -> float:
    """Forward-pass FLOPs for a [batch, seq] input (2 FLOPs per MAC)."""
    tokens = batch * seq
    f = 2.0 * active_matmul_params(cfg, specs) * tokens
    n_self, n_cross, n_rec = _attn_layers(cfg)
    if cfg.attn_type == "mla":
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    t_avg = seq / 2 if cfg.causal else seq
    f += tokens * n_self * 2.0 * cfg.n_heads * (dqk + dv) * t_avg
    n_kv = cfg.n_image_tokens or cfg.encoder_seq
    if n_cross and n_kv:
        f += tokens * n_cross * 2.0 * cfg.n_heads * 2 * cfg.resolved_head_dim * n_kv
    if n_rec:  # recurrent state updates (mamba: d_in*d_state; xlstm: NH*dh^2)
        di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
        f += tokens * n_rec * 6.0 * di * ds
    if cfg.n_encoder_layers:  # encoder runs on encoder_seq tokens
        enc_tokens = batch * cfg.encoder_seq
        per_layer = 2.0 * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff)
        f += enc_tokens * cfg.n_encoder_layers * per_layer
        f += (enc_tokens * cfg.n_encoder_layers * 2.0 * cfg.n_heads * 2
              * cfg.resolved_head_dim * cfg.encoder_seq)
    return f


def train_step_flops(cfg: ModelConfig, specs, batch: int, seq: int) -> float:
    """fwd + bwd ~= 3x fwd (standard convention)."""
    return 3.0 * forward_flops(cfg, specs, batch, seq)


def model_flops_reference(cfg: ModelConfig, specs, tokens: float, train: bool = True) -> float:
    """Roofline reference: 6*N*D (dense) / 6*N_active*D (MoE), N = matmul params."""
    n = active_matmul_params(cfg, specs)
    return (6.0 if train else 2.0) * n * tokens
