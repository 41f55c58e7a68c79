"""Tensor, expert and context parallelism over the mesh's "model" axis (and
experts over ("model", "data") when serving): the explicit collectives,
with their autograd rules (port only).

The reference places its layers with ``shard_l`` constraints and lets GSPMD
insert the collectives.  Here every process holds its block of each weight
(``distributed/sharding.py::local_slices``), computes its local heads, FFN
columns, experts and vocabulary rows, and meets the others at the calls of
this module, on the "model" group of the mesh in ``mesh_ctx``
(Megatron-style).  Each call is a ``torch.autograd.Function`` whose backward
is the transpose of its forward:

  * :func:`all_reduce_sum` -- the row-parallel outputs: attention's ``wo``,
    the FFN's ``w_down``, the MoE combine fused with its shared expert, and
    the vocabulary-parallel embedding's masked rows.  Sum forward, identity
    backward (the sum's every input gets the output's gradient);
  * :func:`enter_split` -- where a replicated tensor enters a split region
    (a layer's input before its column-parallel products, MLA's latents,
    the MoE gate weights, a replicated weight read by a block of heads).
    Identity forward, sum backward: each process's partial gradient becomes
    the whole one, so replicated leaves get the same gradient everywhere;
  * :func:`all_gather_cat` -- the vocabulary-sharded logits where a
    serving step or a distillation loss reads them whole, the
    expert-sharded router logits and a context-parallel layer's output
    rows, concatenated in block order.  Gather forward; backward, this
    process's block of the (replicated) gradient.
  * :func:`all_reduce_max` -- the vocabulary-parallel loss's row max over
    the blocks of logits (``models/lm.py::lm_loss``), a constant for
    autograd; the loss's other reductions are :func:`all_reduce_sum`.
  * :func:`enter_split_all` -- :func:`enter_split` of several tensors at
    once, their gradients summed in ONE flat buffer (a context-parallel
    layer's input and replicated weights).

Each takes ``axes``, the mesh axes the dimension is split over (default
"model").  A block over several axes is numbered major to minor, as
``distributed/sharding.py::local_slices`` cuts it: experts over ("model",
"data") on a DxM mesh put block ``m * D + d`` on process (d, m).  A process
group numbers its ranks in global rank order, which on a DxM mesh is
data-major (``d * M + m``), so a gather over such a group puts each part
at its block index, not at its group rank (:func:`axes_group`).

A whole (unsplit) term beside a split one is added after the sum, on every
process alike, so its replicated weights get their gradient everywhere
without a collective.

They take tensors on any device (gloo copies CUDA tensors through the host
when ranks share a card).  A sum adds in float32 or wider and rounds once,
to the input's dtype, after the sum; a row-parallel partial is already
rounded to the compute dtype by its own product, so at bf16 a split product
rounds twice (each rank's partial, then the sum) where one process's rounds
once, and its result may differ from one process's by a few bf16 units in
the last place.  A gather moves the blocks in their own dtype: a
concatenation rounds nothing.  Every collective is counted where it runs,
forward or backward (read and zeroed by :func:`counts` and
:func:`reset_counts`), as the kernel wrappers count their launches.  The
group is taken in the forward and kept for the backward, which the autograd
engine may run on another thread.  A layer decides what it computes from
its local weights' shapes; whether a dimension is split is :func:`is_split`
of the local size against the configured one.  Outside a mesh context, or
on a "model" axis of 1, nothing is split and nothing is called.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding import current_mesh, mesh_coordinate, mesh_shape

MODEL = ("model",)
EXPERTS_SERVE = ("model", "data")  # SERVE_RULES' experts, model-major

_GROUPS: dict = {}


def axes_size(axes: Tuple[str, ...] = MODEL) -> int:
    """The product of ``axes``' sizes in the current mesh context (1 without
    one; an axis the mesh lacks counts 1)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= int(sizes.get(a, 1))
    return n


def block_index(axes: Tuple[str, ...] = MODEL) -> int:
    """This process's block over ``axes``, numbered major to minor (0
    without a split)."""
    if axes_size(axes) == 1:
        return 0
    mesh = current_mesh()
    if axes == MODEL:
        return int(mesh.get_local_rank("model"))
    sizes = mesh_shape(mesh)
    at = dict(zip(sizes, mesh_coordinate(mesh)))
    idx = 0
    for a in axes:
        if a in sizes:
            idx = idx * sizes[a] + at[a]
    return idx


def model_size() -> int:
    """The "model" axis' size in the current mesh context (1 without one)."""
    return axes_size(MODEL)


def model_rank() -> int:
    """This process's coordinate on the "model" axis (0 without a mesh)."""
    return block_index(MODEL)


def is_split(local: int, whole: int, axes: Tuple[str, ...] = MODEL) -> bool:
    """True when a dimension of ``whole`` is held as a block of ``local``
    over ``axes``: ``local * axes_size(axes) == whole``.  Raises for any
    other local size (a step run outside the mesh context its weights were
    placed for)."""
    if local == whole:
        return False
    n = axes_size(axes)
    if n == 1 or local * n != whole:
        raise ValueError(f"a block of {local} of a dimension of {whole} is no split over "
                         f"{axes} of {n}: run the step in the mesh_ctx of the mesh "
                         f"its weights were placed on")
    return True


def split_axes(local: int, whole: int, *candidates: Tuple[str, ...]) -> Tuple[str, ...]:
    """The first of ``candidates`` (tuples of mesh axes) over which a block
    of ``local`` makes ``whole``; ``()`` when the dimension is whole.
    Raises when none does."""
    if local == whole:
        return ()
    for axes in candidates:
        n = axes_size(axes)
        if n > 1 and local * n == whole:
            return tuple(axes)
    raise ValueError(f"a block of {local} of a dimension of {whole} is no split over any "
                     f"of {candidates} in the current mesh context")


def axes_group(axes: Tuple[str, ...] = MODEL):
    """(group, order): the process group spanning ``axes`` that holds this
    process, and for each of its ranks (global rank order) the block index
    it holds, or None where the two agree (one axis)."""
    mesh = current_mesh()
    if len(axes) == 1:
        return mesh.get_group(axes[0]), None
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        from repro_torch.distributed.reduce import axis_group

        group = axis_group(mesh, tuple(axes))  # made by every process together
        sizes = mesh_shape(mesh)
        names = list(sizes)
        n = axes_size(axes)
        rows = mesh.mesh.permute(*[names.index(a) for a in names if a not in axes],
                                 *[names.index(a) for a in axes]).reshape(-1, n).tolist()
        row = next(r for r in rows if dist.get_rank() in r)  # global ranks, block order
        _GROUPS[key] = (mesh, group, [row.index(r) for r in sorted(row)])
    return _GROUPS[key][1:]


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in float32 or wider, in ``x``'s dtype;
    ``x`` itself is left as it was (a gradient may be shared)."""
    buf = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    _CALLS["all_reduce"] += 1
    return buf.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterSplit(torch.autograd.Function):
    """Identity forward on one or more tensors; backward, their gradients
    summed in one flat buffer in float32 or wider (a missing one as
    zeros), each returned in its own dtype."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        ctx.wide = torch.float32
        for x in xs:
            ctx.wide = torch.promote_types(ctx.wide, x.dtype)
        ctx.device = xs[0].device
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([(torch.zeros(s, dtype=ctx.wide, device=ctx.device) if g is None
                           else g).reshape(-1).to(ctx.wide) for g, (s, _) in zip(gs, ctx.meta)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        _CALLS["all_reduce"] += 1
        out, off = [], 0
        for s, dt in ctx.meta:
            out.append(flat[off:off + s.numel()].view(s).to(dt))
            off += s.numel()
        return (None, *out)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, order, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        _CALLS["all_gather"] += 1
        if order is not None:  # group rank i holds block order[i]
            blocks = [None] * len(parts)
            for i, b in enumerate(order):
                blocks[b] = parts[i]
            parts = blocks
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def all_reduce_sum(x: torch.Tensor, axes: Tuple[str, ...] = MODEL) -> torch.Tensor:
    """``x`` summed over the group of ``axes`` (default "model") in float32
    or wider, returned in ``x``'s dtype; the gradient passes through
    unchanged."""
    return _AllReduceSum.apply(x, axes_group(axes)[0])


def all_reduce_max(x: torch.Tensor, axes: Tuple[str, ...] = MODEL) -> torch.Tensor:
    """The elementwise max of ``x`` over the group of ``axes`` (default
    "model"), a new tensor outside autograd: a constant, such as the
    vocabulary-parallel loss's row max (counted as an all-reduce)."""
    buf = x.detach().to(memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=axes_group(axes)[0])
    _CALLS["all_reduce"] += 1
    return buf


def enter_split(x: torch.Tensor, axes: Tuple[str, ...] = MODEL) -> torch.Tensor:
    """``x`` itself; in the backward its gradient is summed over the group
    of ``axes`` (default "model").  A no-op without a split there."""
    if axes_size(axes) == 1:
        return x
    return _EnterSplit.apply(axes_group(axes)[0], x)[0]


def enter_split_all(xs: Sequence[torch.Tensor],
                    axes: Tuple[str, ...] = MODEL) -> List[torch.Tensor]:
    """:func:`enter_split` of every tensor of ``xs``, their gradients summed
    over the group of ``axes`` in ONE all-reduce of a flat buffer."""
    if axes_size(axes) == 1 or not xs:
        return list(xs)
    return list(_EnterSplit.apply(axes_group(axes)[0], *xs))


def all_gather_cat(x: torch.Tensor, dim: int = -1,
                   axes: Tuple[str, ...] = MODEL) -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` (default "model") concatenated along
    ``dim`` in block order (block 0 first); the gradient of this process's
    block is its block of the output's gradient."""
    group, order = axes_group(axes)
    return _AllGatherCat.apply(x, dim % x.ndim, group, order, block_index(axes))


_CALLS = {"all_reduce": 0, "all_gather": 0}


def counts() -> Dict[str, int]:
    """Collectives run since :func:`reset_counts`, forward and backward
    (a fused :func:`enter_split_all` sum counts as one all-reduce)."""
    return dict(_CALLS)


def reset_counts() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """``F.embedding(tokens, table)`` for a ``table`` of ``vocab`` rows held
    as a block of rows: each process looks up the tokens its block holds,
    zeros for the rest, and the sum over "model" assembles every row
    exactly (one value and zeros)."""
    v_local = table.shape[0]
    if not is_split(v_local, vocab):
        return F.embedding(tokens, table)
    t = tokens - model_rank() * v_local
    inside = (t >= 0) & (t < v_local)
    rows = F.embedding(t.clamp(0, v_local - 1), table)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return all_reduce_sum(rows)
