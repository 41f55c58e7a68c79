"""Tensor and expert parallelism over the mesh's "model" axis: the explicit
collectives, with their autograd rules (port only).

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
  * :func:`all_gather_cat` -- the vocabulary-sharded logits and the
    expert-sharded router logits, concatenated in the axis' order.  Gather
    forward; backward, this process's block of the (replicated) gradient.

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
forward or backward (``.calls``, read and zeroed by :func:`counts` and
:func:`reset_counts`), as the kernel wrappers count their launches.  The
group is taken in the forward and kept for the backward, which the autograd
engine may run on another thread.  A layer decides what it computes from
its local weights' shapes; whether a dimension is split is :func:`is_split`
of the local size against the configured one.  Outside a mesh context, or
on a "model" axis of 1, nothing is split and nothing is called.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding import current_mesh, mesh_shape


def model_size() -> int:
    """The "model" axis' size in the current mesh context (1 without one)."""
    mesh = current_mesh()
    return 1 if mesh is None else int(mesh_shape(mesh).get("model", 1))


def model_rank() -> int:
    """This process's coordinate on the "model" axis (0 without a mesh)."""
    if model_size() == 1:
        return 0
    return int(current_mesh().get_local_rank("model"))


def is_split(local: int, whole: int) -> bool:
    """True when a dimension of ``whole`` is held as a block of ``local``:
    ``local * model_size() == whole``.  Raises for any other local size (a
    step run outside the mesh context its weights were placed for)."""
    if local == whole:
        return False
    n = model_size()
    if n == 1 or local * n != whole:
        raise ValueError(f"a block of {local} of a dimension of {whole} is no split over a "
                         f"'model' axis of {n}: run the step in the mesh_ctx of the mesh "
                         f"its weights were placed on")
    return True


def _group():
    return current_mesh().get_group("model")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in float32 or wider, in ``x``'s dtype;
    ``x`` itself is left as it was (a gradient may be shared)."""
    buf = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    return buf.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        all_gather_cat.calls += 1
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the "model" group in float32 or wider, returned in
    ``x``'s dtype; the gradient passes through unchanged."""
    return _AllReduceSum.apply(x, _group())


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; in the backward its gradient is summed over the "model"
    group.  A no-op without a split "model" axis."""
    if model_size() == 1:
        return x
    return _EnterSplit.apply(x, _group())


def all_gather_cat(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The "model" group's blocks of ``x`` concatenated along ``dim`` in the
    axis' order (coordinate 0 first); the gradient of this process's block
    is its block of the output's gradient."""
    return _AllGatherCat.apply(x, dim % x.ndim, _group(), model_size(), model_rank())


all_reduce_sum.calls = 0
all_gather_cat.calls = 0


def counts() -> Dict[str, int]:
    """Collectives run since :func:`reset_counts`, forward and backward."""
    return {"all_reduce": all_reduce_sum.calls, "all_gather": all_gather_cat.calls}


def reset_counts() -> None:
    all_reduce_sum.calls = 0
    all_gather_cat.calls = 0


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
