"""Fully sharded data parallelism over the mesh's data axes: the weight
gathers, with their autograd rules (port only).

Under the training rules (``distributed/sharding.py::RULES``) every leaf
with an ``embed`` (or ``embed_cat2``) dimension is split over the data-like
axes ("pod", "data") on that dimension, as the reference's FSDP layout
(ZeRO-3 style): parameters, AdamW moments and stashes alike, so each data
rank holds ``1/D`` of them.  The layers read weights whole over the data
axes (they still hold their "model" blocks), so the step gathers them:

  * :func:`gather_tree` -- the data-split leaves of a tree in ONE flat
    buffer, one all-gather over the data group per layout (a tuple of data
    axes and a dtype: one per call in every config of the repo).  Its
    backward is one reduce-scatter of the whole leaves' gradients, summed in
    float32 or wider and rounded once to the leaves' dtype, which leaves
    this process the SUM over the data axes of its block's gradient (the
    step divides by the axes' size);
  * per layer (the default, :func:`per_layer` in :func:`fsdp_ctx`):
    ``models/lm.py`` gathers each block's leaves inside its checkpointed
    function, so a "full" or "dots" backward re-gathers them, and the leaves
    outside the stacks (embedding, head, final norm, MTP head, the encoder's
    final norm) once where the forward starts;
  * per step (``TrainConfig.pregather_params``): the whole tree, cast to the
    compute dtype, gathered once before the microbatch loop, and its
    gradient reduce-scattered once (:func:`gather_flat`,
    :func:`reduce_scatter_flat`).

The reference's FSDP step takes its loss over the GLOBAL batch, and so does
this one: each process computes a loss on its rows whose mean over the data
axes is the global loss, and the step averages the gradients.  Where a loss
is not a plain mean over rows, the forward takes the statistic it needs over
the data axes with :func:`batch_mean` (the cross-entropy's count of labels
that are not -1, the MoE load-balancing loss's routing fractions and mean
router probabilities); outside the FSDP step it is the identity.

Collectives run on the group ``distributed/reduce.py::axis_group`` makes
for the data axes, whose ranks lie in the order ``local_slices`` numbers
the blocks (major axis first).  They take tensors on any device (gloo
copies CUDA tensors through the host when ranks share a card).  Every
gather and reduce-scatter is counted where it runs (:func:`counts`,
:func:`reset_counts`), as ``tensor_parallel.counts()`` counts its own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import _entry_axes, logical_spec, mesh_shape
from repro_torch.param import flatten, unflatten

DATA_AXES = ("pod", "data")

_CTX: dict = {"mesh": None, "batch": None}
_CALLS = {"all_gather": 0, "reduce_scatter": 0, "batch_mean": 0}


def counts() -> Dict[str, int]:
    """Gathers, reduce-scatters and :func:`batch_mean` all-reduces run since
    :func:`reset_counts`, forward and backward."""
    return dict(_CALLS)


def reset_counts() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


@contextlib.contextmanager
def fsdp_ctx(mesh, gather_per_layer: bool = True):
    """Inside, the FSDP step's forward on ``mesh``: batch statistics are
    taken over its data axes (:func:`batch_mean`), and with
    ``gather_per_layer`` the weights are gathered per layer
    (:func:`per_layer`)."""
    prev = dict(_CTX)
    _CTX.update(mesh=mesh if gather_per_layer else None, batch=mesh)
    try:
        yield mesh
    finally:
        _CTX.update(prev)


def per_layer():
    """The mesh whose data axes the forward gathers per layer, or None."""
    return _CTX["mesh"]


def _batch_axes():
    mesh = _CTX["batch"]
    if mesh is None:
        return None, (), 1
    axes = tuple(a for a in DATA_AXES if a in mesh_shape(mesh))
    return mesh, axes, _size(mesh, axes)


def batch_ways() -> int:
    """How many processes split the batch in the FSDP step (1 outside)."""
    return _batch_axes()[2]


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _mean(x, group, n)

    @staticmethod
    def backward(ctx, g):
        # every process's loss carries the mean and the step averages the
        # processes' gradients: each block's input gets the mean gradient
        return _mean(g, ctx.group, ctx.n), None, None


def _mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    buf = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    _CALLS["batch_mean"] += 1
    return (buf / n).to(x.dtype)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a statistic of this process's rows, averaged over the data
    axes in the FSDP step (the global batch's, every process holding as many
    rows), in one all-reduce; differentiable (its backward averages the
    gradient the same way).  ``x`` itself outside the step or on one
    process."""
    mesh, axes, n = _batch_axes()
    if n == 1:
        return x
    if not x.is_floating_point():
        x = x.float()
    return _BatchMean.apply(x, _group(mesh, axes), n)


def data_split(spec: Sequence) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dimension, data axes) of the one dimension ``spec`` splits over data
    axes, or None.  Raises on an entry that mixes data and other axes (no
    training rule makes one)."""
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        data = tuple(a for a in axes if a in DATA_AXES)
        if data:
            if data != axes:
                raise ValueError(f"spec {tuple(spec)} mixes data and other axes on dim {d}")
            return d, data
    return None


def _group(mesh, axes):
    from repro_torch.distributed.reduce import axis_group

    return axis_group(mesh, axes)


def _size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)
    _CALLS["all_gather"] += 1


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)
    _CALLS["reduce_scatter"] += 1


def _whole(flat: torch.Tensor, n: int, shapes, dims) -> List[torch.Tensor]:
    """The ``[n * sum(block sizes)]`` gathered buffer as whole leaves: block
    ``r`` of every leaf is the ``r``-th slice of its split dimension."""
    rows = flat.view(n, -1)
    out, off = [], 0
    for shape, d in zip(shapes, dims):
        k = 1
        for s in shape:
            k *= s
        blocks = rows[:, off:off + k].reshape((n,) + tuple(shape))
        whole = list(shape)
        whole[d] *= n
        out.append(blocks.movedim(0, d).reshape(whole))
        off += k
    return out


def _rows(wholes: Sequence[torch.Tensor], n: int, dims, dtype) -> torch.Tensor:
    """The inverse of :func:`_whole`: whole leaves as one ``[n, sum(block
    sizes)]`` buffer of ``dtype``, row ``r`` holding every leaf's block
    ``r``."""
    parts = []
    for g, d in zip(wholes, dims):
        shape = list(g.shape)
        split = shape[:d] + [n, shape[d] // n] + shape[d + 1:]
        parts.append(g.to(dtype).reshape(split).movedim(d, 0).reshape(n, -1))
    return torch.cat(parts, dim=1)


def gather_flat(blocks: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                axes: Tuple[str, ...]) -> List[torch.Tensor]:
    """The whole leaves of ``blocks`` (each split over ``axes`` on its
    ``dims`` entry, one dtype), gathered in one all-gather; no autograd."""
    n = _size(mesh, axes)
    flat = torch.cat([b.reshape(-1) for b in blocks])
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    _all_gather(out, flat, _group(mesh, axes))
    return _whole(out, n, [tuple(b.shape) for b in blocks], dims)


def reduce_scatter_flat(wholes: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                        axes: Tuple[str, ...]) -> List[torch.Tensor]:
    """This process's blocks of ``wholes`` summed over ``axes``, in one
    reduce-scatter: the sum runs in float32 or wider and is rounded once to
    each leaf's dtype."""
    n = _size(mesh, axes)
    wide = torch.float32
    for g in wholes:
        wide = torch.promote_types(wide, g.dtype)
    rows = _rows(wholes, n, dims, wide)
    out = torch.empty(rows.shape[1], dtype=wide, device=rows.device)
    _reduce_scatter(out, rows.reshape(-1), _group(mesh, axes))
    res, off = [], 0
    for g, d in zip(wholes, dims):
        shape = list(g.shape)
        shape[d] //= n
        k = 1
        for s in shape:
            k *= s
        res.append(out[off:off + k].view(shape).to(g.dtype))
        off += k
    return res


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, *blocks):
        mesh, axes, dims = meta
        ctx.meta = meta
        out = tuple(gather_flat(blocks, dims, mesh, axes))
        ctx.like = [(tuple(o.shape), o.dtype, o.device) for o in out]
        return out

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes, dims = ctx.meta
        # a leaf the loss does not read gets zeros, as its gradient is
        wholes = [torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
                  for g, (shape, dtype, dev) in zip(grads, ctx.like)]
        return (None,) + tuple(reduce_scatter_flat(wholes, dims, mesh, axes))


def layout(specs, mesh) -> Dict[str, Optional[Tuple[int, Tuple[str, ...]]]]:
    """``{path: (dimension, data axes)}`` of a ``Spec`` tree on ``mesh``
    under the training rules: where each leaf splits over data axes of more
    than one process (None where it does not)."""
    out = {}
    for k, s in flatten(specs).items():
        where = data_split(logical_spec(s.shape, s.axes, mesh))
        out[k] = where if where is not None and _size(mesh, where[1]) > 1 else None
    return out


def _groups(flat, where) -> Dict[tuple, List[str]]:
    groups: Dict[tuple, List[str]] = {}
    for k, x in flat.items():
        if where.get(k) is not None:
            groups.setdefault((where[k][1], x.dtype), []).append(k)
    return groups


def gather_leaves(flat: Dict[str, torch.Tensor], where, mesh) -> Dict[str, torch.Tensor]:
    """``flat`` (``{path: this process's block}``) with every leaf that
    ``where`` (:func:`layout`) splits gathered whole: one all-gather per
    (data axes, dtype) layout, differentiable (its backward is the matching
    reduce-scatter, see the module docstring); the other leaves pass
    through."""
    out = dict(flat)
    for (axes, _), keys in _groups(flat, where).items():
        dims = tuple(where[k][0] for k in keys)
        out.update(zip(keys, _Gather.apply((mesh, axes, dims), *[flat[k] for k in keys])))
    return out


def reduce_scatter_leaves(flat: Dict[str, torch.Tensor], where, mesh) -> Dict[str, torch.Tensor]:
    """The inverse layout of :func:`gather_leaves` for gradients: every leaf
    that ``where`` splits becomes this process's block of its sum over the
    data axes, one reduce-scatter per layout; the rest pass through."""
    out = dict(flat)
    for (axes, _), keys in _groups(flat, where).items():
        dims = tuple(where[k][0] for k in keys)
        out.update(zip(keys, reduce_scatter_flat([flat[k] for k in keys], dims, mesh, axes)))
    return out


def cut_leaves(flat: Dict[str, torch.Tensor], where, mesh) -> Dict[str, torch.Tensor]:
    """This process's data blocks of whole leaves (views; the leaves that
    ``where`` does not split pass through)."""
    from repro_torch.distributed.sharding import local_slices

    out = dict(flat)
    for k, w in where.items():
        if w is None or k not in flat:
            continue
        x = flat[k]
        spec = [None] * x.ndim
        spec[w[0]] = w[1]
        out[k] = x[local_slices(tuple(x.shape), spec, mesh)]
    return out


def gather_tree(tree, where, mesh):
    """``tree`` (this process's blocks) with every leaf that ``where``
    (:func:`layout` of its specs) splits gathered whole
    (:func:`gather_leaves`)."""
    return unflatten(gather_leaves(flatten(tree), where, mesh))


def outside_stacks(where):
    """``where`` (:func:`layout`) without the leaves of a ``stages``
    subtree (at any depth: the decoder's and the encoder's stacks), whose
    blocks gather per layer in ``models/lm.py``."""
    return {k: w for k, w in where.items() if "stages" not in k.split("/")}
