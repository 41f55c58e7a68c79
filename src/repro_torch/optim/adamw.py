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
on the device for them.  A large leaf is updated in slices of at most
``CHUNK`` elements (the same elementwise arithmetic, so the same bits), so
the update's temporaries stay near a gigabyte: whole, DeepSeek-V3's
129280 x 7168 embedding alone took ~15 GB of them beside a train state that
fills most of the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.param import Spec, flatten, tree_map


CHUNK = 1 << 26  # elements of a leaf updated at a time (256 MB at f32)


def _slices(*ts: torch.Tensor):
    """Aligned flat slices of at most ``CHUNK`` elements of tensors of one
    shape that are all contiguous, else the tensors whole."""
    n = ts[0].numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


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


def adamw_init_specs(param_specs, tc: TrainConfig) -> Dict[str, Any]:
    """Spec tree of the AdamW state: ``m`` and ``v`` mirror the parameter
    specs in ``tc.opt_dtype``; ``count`` is the reference's int32 scalar
    (this package holds it as a Python int, see ``adamw_init``)."""
    one = lambda s: Spec(s.shape, s.axes, s.roles, init="zeros", dtype=tc.opt_dtype)
    return {"m": tree_map(one, param_specs), "v": tree_map(one, param_specs),
            "count": Spec((), (), (), init="zeros", dtype=torch.int32)}


def adamw_init(params, tc: TrainConfig) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (on their devices) and count 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=tc.opt_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": 0}


def sum_squares(gs, device) -> torch.Tensor:
    """The f32 sum of squares of the tensors ``gs`` on ``device`` (zero
    when there are none)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return sum((g.float().square().sum() for g in gs), zero)


def clip_scale(g2: torch.Tensor, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the factor that scales the gradients to a global norm of at most
    ``max_norm``, the norm before scaling) from the gradients' global sum
    of squares ``g2``, on the device.  ``adamw_update`` scales each leaf as
    it reaches it, so no second copy of the gradients is ever whole."""
    gn = torch.sqrt(g2)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


@torch.no_grad()
def adamw_update(params, grads, opt_state, tc: TrainConfig, *, clip=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step; ``params`` and the moments are updated in place.
    Returns (params, opt_state, {"grad_norm": device scalar, "lr": float}).
    ``clip`` is :func:`clip_scale`'s pair when the norm is taken across a
    mesh (of this process's blocks, or of gradients whole over data axes
    while ``params`` are data blocks); the update itself is elementwise on
    each block."""
    gs = list(flatten(grads).values())
    if clip is None:
        clip = clip_scale(sum_squares(gs, gs[0].device), tc.grad_clip)
    scale, gnorm = clip
    count = opt_state["count"] + 1
    b1, b2 = tc.b1, tc.b2
    lr = lr_at(count, tc)
    cf = _f32(float(count))
    bc1 = float(1 - b1 ** cf)
    bc2 = float(1 - b2 ** cf)
    for leaf in zip(flatten(params).values(), gs, flatten(opt_state["m"]).values(),
                    flatten(opt_state["v"]).values()):
        decay = leaf[0].ndim >= 2 and tc.weight_decay  # the stacked leaf's rank
        for p, g, m, v in _slices(*leaf):
            gf = (g.float() * scale).to(g.dtype).float()  # clipped, in the gradient's type
            mf, vf = m.float(), v.float()  # the moments themselves when f32
            mf.mul_(b1).add_(gf * (1 - b1))
            vf.mul_(b2).add_(gf.square() * (1 - b2))
            step = (mf / bc1).div_((vf / bc2).sqrt_().add_(tc.eps))
            if decay:
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
