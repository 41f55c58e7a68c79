"""Dense FFN (SwiGLU, or the classic two-matrix GELU FFN with biases) and
the Mixture-of-Experts layer with GShard-style capacity dispatch (the
counterpart of ``repro/layers/ffn.py``).

The MoE products are plain ``torch.einsum`` contractions, as the reference's
are ``jnp.einsum``: no kernel of the reference lies on this layer.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.basic import act_fn
from repro_torch.param import Spec


def ffn_specs(cfg: ModelConfig, d_ff: int = 0, axis: str = "mlp") -> Dict[str, Spec]:
    E = cfg.d_model
    F = d_ff or cfg.d_ff
    s = {
        "w_gate": Spec((E, F), ("embed", axis), ("in", "out"), init="fan_in"),
        "w_up": Spec((E, F), ("embed", axis), ("in", "out"), init="fan_in"),
        "w_down": Spec((F, E), (axis, "embed"), ("in", "out"), init="fan_in"),
    }
    if cfg.act == "gelu":  # classic 2-matrix FFN (BERT/GPT/DeiT/Whisper)
        s.pop("w_gate")
    if cfg.use_bias:
        s["b_up"] = Spec((F,), (axis,), ("out",), init="zeros")
        s["b_down"] = Spec((E,), ("embed",), ("out",), init="zeros")
    return s


def ffn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    act = act_fn(cfg.act)
    h = x @ p["w_up"].to(cdt)
    if cfg.use_bias:
        h = h + p["b_up"].to(cdt)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(cdt)) * h
    else:
        h = act(h)
    y = h @ p["w_down"].to(cdt)
    if cfg.use_bias:
        y = y + p["b_down"].to(cdt)
    return y


# ---------------------------------------------------------------------------
# MoE


def moe_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E, X, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": Spec((E, X), ("embed", "experts"), ("in", "-"), init="normal", scale=0.02),
        "w_gate": Spec((X, E, F), ("experts", "embed", "moe_mlp"), ("-", "in", "out"),
                       init="fan_in"),
        "w_up": Spec((X, E, F), ("experts", "embed", "moe_mlp"), ("-", "in", "out"),
                     init="fan_in"),
        "w_down": Spec((X, F, E), ("experts", "moe_mlp", "embed"), ("-", "in", "out"),
                       init="fan_in"),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
        s["shared"] = ffn_specs(cfg, d_ff=Fs, axis="shared_mlp")
    return s


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert in one group of ``seq`` tokens (padding included):
    ``max(ceil(seq * k * capacity_factor / n_experts), 4)``."""
    X, k = cfg.n_experts, cfg.moe_top_k
    cap = int(math.ceil(seq * k * cfg.capacity_factor / X))
    return max(cap, 4)


class DroppedRoutings:
    """Tally of the (token, slot) routings, and of those that found their
    expert full, by step kind: the caller names the kind (``tally.kind =
    "decode"``) before each step.  Counts stay on the device until
    ``counts()``.  A forward that ``torch.utils.checkpoint`` recomputes
    counts twice, so tally serving steps only."""

    def __init__(self):
        self.kind = "step"
        self._counts: Dict[str, torch.Tensor] = {}

    def add(self, dropped: torch.Tensor, routed: torch.Tensor) -> None:
        n = torch.stack([dropped, routed])
        prev = self._counts.get(self.kind)
        self._counts[self.kind] = n if prev is None else prev + n

    def counts(self) -> Dict[str, Tuple[int, int]]:
        """Step kind -> (routings dropped, routings made)."""
        return {k: tuple(int(x) for x in v.tolist()) for k, v in self._counts.items()}


_TALLY: Optional[DroppedRoutings] = None


@contextlib.contextmanager
def count_dropped():
    """``with count_dropped() as tally:`` every ``moe_apply`` inside adds its
    over-capacity routings to ``tally``."""
    global _TALLY
    prev, _TALLY = _TALLY, DroppedRoutings()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux load-balancing loss), as the reference's GShard
    dispatch: one batch row is one group, position-in-expert is a cumulative
    count along the sequence, and a token past an expert's ``moe_capacity``
    slots is dropped from that expert.

    Routing ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them (a stable descending sort); the capacity one-hot is built by
    comparison, so a position past the last slot gives a zero row as
    ``jax.nn.one_hot`` does.  Positions are counted in f32 (exact to 2**24);
    the combine weights are kept in the compute dtype."""
    B, S, E = x.shape
    X, k = cfg.n_experts, cfg.moe_top_k
    C = moe_capacity(cfg, S)
    cdt = cfg.compute_dtype
    act = act_fn(cfg.act)

    logits = (x @ p["router"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)  # [B,S,X]
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, idx)  # [B,S,k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch): X * sum_e f_e * p_e
    experts = torch.arange(X, device=x.device)
    me = probs.mean(dim=(0, 1))
    ce = (idx[..., 0, None] == experts).float().mean(dim=(0, 1))
    aux = X * torch.sum(me * ce)

    slots = torch.arange(C, device=x.device)
    combine = torch.zeros((B, S, X, C), dtype=cdt, device=x.device)
    prior = torch.zeros((B, X), dtype=torch.float32, device=x.device)
    for slot in range(k):
        oh = (idx[..., slot, None] == experts).float()  # [B,S,X]
        pos = torch.cumsum(oh, dim=1) - oh + prior[:, None, :]
        prior = prior + oh.sum(dim=1)
        keep = (pos < C) & (oh > 0)
        if _TALLY is not None:
            _TALLY.add(((oh > 0) & ~keep).sum(), oh.sum().long())
        w = torch.where(keep, gate_vals[..., slot, None], 0.0).to(cdt)  # [B,S,X]
        pos_oh = (pos.long()[..., None] == slots).to(cdt)  # [B,S,X,C]
        combine = combine + w[..., None] * pos_oh
    dispatch = (combine > 0).to(cdt)

    xb = torch.einsum("bsxc,bse->bxce", dispatch, x)
    g = torch.einsum("bxce,xef->bxcf", xb, p["w_gate"].to(cdt))
    u = torch.einsum("bxce,xef->bxcf", xb, p["w_up"].to(cdt))
    yb = torch.einsum("bxcf,xfe->bxce", act(g) * u, p["w_down"].to(cdt))
    y = torch.einsum("bsxc,bxce->bse", combine, yb)
    if cfg.n_shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg)
    return y, aux
