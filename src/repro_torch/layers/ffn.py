"""Dense FFN (SwiGLU, or the classic two-matrix GELU FFN with biases) and
the Mixture-of-Experts layer with GShard-style capacity dispatch (the
counterpart of ``repro/layers/ffn.py``).

The MoE products are plain ``torch.einsum`` contractions, as the reference's
are ``jnp.einsum``: no kernel of the reference lies on this layer.

On a "model" axis (``distributed/tensor_parallel.py``) the dense FFN holds a
block of ``w_gate``/``w_up`` columns and ``w_down`` rows and sums its partial
output over the axis before ``b_down``.  The MoE layer holds a block of
experts (or, where the experts do not split, a block of every expert's
columns): the router's logits are gathered whole, routing, capacity and
drops are computed alike on every process, each process combines its own
experts' outputs, and one sum over the axis completes the routed experts
and the shared expert together; a term that does not split (too few
experts or columns for the axis) is added whole after that sum.  For the
backward the input enters the split products through ``tp.enter_split``,
and so do the gate weights where the combine is split, so the replicated
router and the Switch aux loss, computed on the gathered logits as one
process computes them, get the whole gradient on every process.  In the
FSDP step the aux loss takes the global batch's routing statistics over
the data axes (``distributed/fsdp.py::batch_mean``), as the reference's
step over the whole batch does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import rows_split_over_data, shard_l
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


def _ffn_partial(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 d_ff: int = 0) -> Tuple[torch.Tensor, bool]:
    """(output before ``b_down``, whether it is a partial sum over a block of
    the ``d_ff or cfg.d_ff`` hidden columns)."""
    cdt = cfg.compute_dtype
    act = act_fn(cfg.act)
    h = x @ p["w_up"].to(cdt)
    if cfg.use_bias:
        h = h + p["b_up"].to(cdt)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(cdt)) * h
    else:
        h = act(h)
    h = shard_l(h, ("batch", "seq", "act_mlp"))
    return h @ p["w_down"].to(cdt), tp.is_split(h.shape[-1], d_ff or cfg.d_ff)


def ffn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if tp.is_split(p["w_up"].shape[1], cfg.d_ff):
        x = tp.enter_split(x)
    y, split = _ffn_partial(p, x, cfg)
    if split:
        y = tp.all_reduce_sum(y)
    if cfg.use_bias:
        y = y + p["b_down"].to(cfg.compute_dtype)
    return shard_l(y, ("batch", "seq", "act_embed"))


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
    the combine weights are kept in the compute dtype.

    On a "model" axis the local experts are the block ``w_gate`` holds: the
    combine tensor is built for them alone, the over-capacity tally is kept
    by block 0 only, and the routed and shared partial outputs are summed
    over the axis in one all-reduce; a whole term is added after it.  When
    serving on a "data" axis too, the experts split over ("model", "data"),
    model-major (``SERVE_RULES``): the router's columns are gathered, the
    local experts offset and the routed partial summed over that group in
    block order, while the shared expert splits over "model" alone, so its
    partial joins the sum on data coordinate 0 only (exact zeros
    elsewhere) and is counted once.  Where too few experts split over both
    axes (16 on 16x16), ``SERVE_RULES`` puts them on "data" and their hidden
    dim on "model": the routed partial is then summed over ("model",
    "data"), the shared expert's joining it on data coordinate 0.  Where the
    rows also split over "data" (``sharding.rows_split_over_data``: the dry
    run's decode, as the reference's ``moe_batch: None``), the experts of a
    data block see every block's tokens: the rows are gathered over "data"
    first and each process keeps its own rows of the sum."""
    B, S, E = x.shape
    X, k = cfg.n_experts, cfg.moe_top_k
    X_l, F_l = p["w_gate"].shape[0], p["w_gate"].shape[2]
    mlp_split = tp.is_split(F_l, cfg.moe_d_ff or cfg.d_ff)
    if X_l != X and mlp_split:
        # experts over "data" and their hidden dim over "model" (SERVE_RULES
        # with too few experts for both axes): one sum over both completes it
        ex_axes, axes = tp.split_axes(X_l, X, ("data",)), tp.EXPERTS_SERVE
    else:
        ex_axes = tp.split_axes(X_l, X, tp.MODEL, tp.EXPERTS_SERVE)
        axes = ex_axes or tp.MODEL  # the routed partial's group
    experts_split = bool(ex_axes)
    routed_split = experts_split or mlp_split
    own = None  # this process's rows, where the rows of every data block are gathered
    if "data" in ex_axes and rows_split_over_data():
        own = slice(tp.block_index(("data",)) * B, (tp.block_index(("data",)) + 1) * B)
        x = tp.all_gather_cat(x, dim=0, axes=("data",))
        B = x.shape[0]
    Fs = cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
    shared_split = bool(Fs) and tp.is_split(p["shared"]["w_up"].shape[1], Fs)
    C = moe_capacity(cfg, S)
    cdt = cfg.compute_dtype
    act = act_fn(cfg.act)
    # the input of the split products (the router's columns, the experts,
    # the shared expert's columns) enters them once; a whole one reads x
    xs = (tp.enter_split(x, axes if routed_split else tp.MODEL)
          if routed_split or shared_split else x)

    logits = ((xs if experts_split else x) @ p["router"].to(cdt)).float()
    if experts_split:  # the router's columns are the local experts'
        logits = tp.all_gather_cat(logits, dim=-1, axes=ex_axes)
    probs = torch.softmax(logits, dim=-1)  # [B,S,X]
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, idx)  # [B,S,k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    if routed_split:  # the combine below reads them for the local experts only
        gate_vals = tp.enter_split(gate_vals, axes)

    # load-balancing aux loss (Switch): X * sum_e f_e * p_e
    experts = torch.arange(X, device=x.device)
    me = probs.mean(dim=(0, 1))
    ce = (idx[..., 0, None] == experts).float().mean(dim=(0, 1))
    if fsdp.batch_ways() > 1:  # the global batch's statistics, in one all-reduce
        both = fsdp.batch_mean(torch.cat([me, ce]))
        me, ce = both[:X], both[X:].detach()
    aux = X * torch.sum(me * ce)

    x0 = tp.block_index(ex_axes) * X_l if experts_split else 0
    local = slice(x0, x0 + X_l)
    tally = _TALLY if tp.block_index(axes) == 0 else None
    slots = torch.arange(C, device=x.device)
    combine = torch.zeros((B, S, X_l, C), dtype=cdt, device=x.device)
    prior = torch.zeros((B, X), dtype=torch.float32, device=x.device)
    for slot in range(k):
        oh = (idx[..., slot, None] == experts).float()  # [B,S,X]
        pos = torch.cumsum(oh, dim=1) - oh + prior[:, None, :]
        prior = prior + oh.sum(dim=1)
        keep = (pos < C) & (oh > 0)
        if tally is not None:
            tally.add(((oh > 0) & ~keep).sum(), oh.sum().long())
        w = torch.where(keep[..., local], gate_vals[..., slot, None], 0.0).to(cdt)
        pos_oh = (pos[..., local].long()[..., None] == slots).to(cdt)  # [B,S,X_l,C]
        combine = combine + w[..., None] * pos_oh
    combine = shard_l(combine, ("batch", "seq", "act_experts", "capacity"))
    dispatch = (combine > 0).to(cdt)

    xb = torch.einsum("bsxc,bse->bxce", dispatch, xs if routed_split else x)
    g = torch.einsum("bxce,xef->bxcf", xb, p["w_gate"].to(cdt))
    u = torch.einsum("bxce,xef->bxcf", xb, p["w_up"].to(cdt))
    yb = torch.einsum("bxcf,xfe->bxce", act(g) * u, p["w_down"].to(cdt))
    y = torch.einsum("bsxc,bxce->bse", combine, yb)
    if not Fs:
        if routed_split:
            y = tp.all_reduce_sum(y, axes)
        return shard_l(y if own is None else y[own], ("batch", "seq", "act_embed")), aux
    ys, _ = _ffn_partial(p["shared"], xs if shared_split else x, cfg, d_ff=Fs)
    bias = p["shared"]["b_down"].to(cdt) if cfg.use_bias else None
    if routed_split and shared_split:  # one sum completes both
        if axes != tp.MODEL and tp.block_index(("data",)) != 0:
            ys = torch.zeros_like(ys)  # the "model" partial joins once, on data coordinate 0
        y = tp.all_reduce_sum(y + ys, axes)
    elif routed_split:
        y = tp.all_reduce_sum(y, axes) + ys
    elif shared_split:
        y = y + tp.all_reduce_sum(ys)
    else:  # the reference's order: the shared FFN with its bias, then the sum
        y, bias = y + (ys if bias is None else ys + bias), None
    if bias is not None:
        y = y + bias
    return shard_l(y if own is None else y[own], ("batch", "seq", "act_embed")), aux
