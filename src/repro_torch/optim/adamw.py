"""AdamW with warmup-cosine/linear schedules, global-norm clipping and
decoupled weight decay (the counterpart of ``repro/optim/adamw.py``).

The weight-decay mask is the reference's code, not its docstring: a leaf
is decayed when ``p.ndim >= 2``, and that is the *stacked* leaf, so the
stacked biases and norm scales (``[layers, E]``) are decayed while
``final_norm`` (``[E]``) is not.

Where the reference returns new trees, ``adamw_update`` writes the
parameters and moments IN PLACE (under ``torch.no_grad``) and returns the
same objects.  ``count`` is a Python int: the schedule and the bias
corrections are a few f32 scalars computed on the host, so no step waits
on the device for them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.param import flatten, tree_map


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(step: int, tc: TrainConfig) -> float:
    """Warmup then cosine/linear/constant decay, in f32 as the reference."""
    step = _f32(float(step))
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    total = max(tc.steps - tc.warmup_steps, 1)
    frac = torch.clamp((step - tc.warmup_steps) / total, 0.0, 1.0)
    if tc.schedule == "cosine":
        decay = tc.end_lr_frac + (1 - tc.end_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif tc.schedule == "linear":
        decay = 1.0 - (1.0 - tc.end_lr_frac) * frac
    else:
        decay = torch.ones_like(frac)
    return float(tc.peak_lr * warm * decay)


def adamw_init(params, tc: TrainConfig) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (on their devices) and count 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=tc.opt_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": 0}


def _clip_by_global_norm(grads, max_norm: float) -> Tuple[list, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm before
    scaling); the norm is taken in f32 over all leaves, on the device."""
    gs = list(flatten(grads).values())
    g2 = sum(g.float().square().sum() for g in gs)
    gn = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in gs], gn


@torch.no_grad()
def adamw_update(params, grads, opt_state, tc: TrainConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step; ``params`` and the moments are updated in place.
    Returns (params, opt_state, {"grad_norm": device scalar, "lr": float})."""
    gs, gnorm = _clip_by_global_norm(grads, tc.grad_clip)
    count = opt_state["count"] + 1
    b1, b2 = tc.b1, tc.b2
    lr = lr_at(count, tc)
    cf = _f32(float(count))
    bc1 = float(1 - b1 ** cf)
    bc2 = float(1 - b2 ** cf)
    for p, g, m, v in zip(flatten(params).values(), gs, flatten(opt_state["m"]).values(),
                          flatten(opt_state["v"]).values()):
        gf = g.float()
        mf, vf = m.float(), v.float()  # the moments themselves when f32
        mf.mul_(b1).add_(gf * (1 - b1))
        vf.mul_(b2).add_(gf.square() * (1 - b2))
        step = (mf / bc1).div_((vf / bc2).sqrt_().add_(tc.eps))
        if p.ndim >= 2 and tc.weight_decay:
            step.add_(p.float() * tc.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(step * lr)
        else:
            p.copy_(p.float() - step * lr)
        if mf is not m:
            m.copy_(mf)
            v.copy_(vf)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
