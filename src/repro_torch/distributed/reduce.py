"""Pluggable gradient-reduction strategies for the data-parallel train step
(the counterpart of ``repro/distributed/reduce.py``).

- ``DenseReduce``: full-precision mean over every data-like mesh axis.
- ``HierarchicalInt8EF``: full-precision mean within the fast sub-axis
  ("data"), then int8 + error-feedback sum across the slow axis ("pod") via
  ``ef_int8_psum``.

A strategy owns its carried state: the global EF tree has a leading
``[n_dcn]`` axis, one residual per rank of the slow axis, of which each
process holds its own ``[1, *shape]`` row (``init_state``; ``state_shards``
says where that row lies in the global tree, for coordinated checkpoints),
and ``reduce`` runs between the local backward and the optimizer step, over
the process groups of the mesh's data-like axes only, on gradients whole
over them (the step gathers the FSDP blocks of the train state at its
entry).  On a "model" axis a process's gradients, and so its EF residuals,
are its blocks of the split leaves.  The residual rows keep their leading
``[n_dcn]`` dim on the slow axis; their other dims split as the parameter
over the axes left, "model" and the fast data axes (``state_shardings``),
so a process holds, and a checkpoint writes, its block of its slow rank's
row, and the step gathers the fast-axis blocks around ``reduce``
(``state_layout``).  "none" names no strategy: on a mesh the step is then
the FSDP one (``models/api.py::make_train_step``), as the reference's.
``models/api.py::make_train_step`` injects the strategy; the V-cycle
threads the state through checkpoints and resets it at level transitions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.compression import (dense_wire_bytes, ef_int8_psum,
                                                 int8_wire_bytes)
from repro_torch.distributed.multiprocess import shard_tree
from repro_torch.distributed.sharding import _entry_axes, mesh_shape, split_factors
from repro_torch.distributed.sharding import data_axes as _data_axes
from repro_torch.param import flatten, tree_map, unflatten

# (mesh, axes) -> this process's group over those axes (sub-world groups are
# made once per mesh: ``dist.new_group`` is a collective of every rank)
_GROUPS: dict = {}


def axis_group(mesh, axes: Tuple[str, ...]):
    """The process group spanning ``axes`` of ``mesh`` that holds this
    process: the axis's own group for one axis, the default group when
    ``axes`` cover every rank, else one group per coordinate of the other
    axes (each data group of a DxM or PxDxM mesh), made on first use by
    every process together."""
    if mesh is None:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    if n == dist.get_world_size():
        return dist.group.WORLD
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        names = list(sizes)
        ranks = mesh.mesh.permute(*[names.index(a) for a in names if a not in axes],
                                  *[names.index(a) for a in axes]).reshape(-1, n)
        me = dist.get_rank()
        for row in ranks.tolist():  # every process makes every group, in one order
            g = dist.new_group(row)
            if me in row:
                _GROUPS[key] = (mesh, g)  # the mesh kept alive: its id stays unique
    return _GROUPS[key][1]


def mean_over(tree, group, size: int):
    """Every leaf summed over ``group`` and divided by ``size``, in ONE
    all-reduce per dtype of a packed buffer (the tree itself for one
    process)."""
    if size == 1:
        return tree
    flat = flatten(tree)
    out = {}
    by_dtype = {}
    for k, g in flat.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        buf = torch.cat([flat[k].reshape(-1) for k in keys])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf = buf / size
        off = 0
        for k in keys:
            n = flat[k].numel()
            out[k] = buf[off:off + n].reshape(flat[k].shape)
            off += n
    return unflatten({k: out[k] for k in flat})


@dataclasses.dataclass(frozen=True)
class GradReduce:
    """Base strategy: mean-reduce the local (microbatch-mean) gradients over
    the data-like mesh axes.  ``reduce(grads, ef)`` returns the reduced tree
    and the new carried state (``None`` for stateless strategies);
    ``wire_bytes(grads)`` is the analytic per-step payload on the slowest
    link."""

    data_axes: Tuple[str, ...]
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    name = "dense"
    stateful = False

    def init_state(self, params, param_shardings=None) -> Any:
        return None

    def state_shards(self, ef, param_shardings=None) -> Any:
        """``ef`` as this process's blocks of the global state tree (what a
        coordinated checkpoint writes and restores per process); ``ef``
        itself when every process holds the whole state.
        ``param_shardings`` is the parameters' spec tree on the mesh."""
        return ef

    def state_shardings(self, param_shardings, mesh=None) -> Any:
        """The spec tree of the carried state (None: stateless)."""
        return None

    def reduce(self, grads, ef):
        raise NotImplementedError

    def wire_bytes(self, grads) -> int:
        raise NotImplementedError

    def axes_size(self, axes) -> int:
        """The number of processes along ``axes`` of the mesh."""
        sizes = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n


class DenseReduce(GradReduce):
    """One full-precision mean over every data-like axis."""

    name = "dense"
    stateful = False

    def reduce(self, grads, ef):
        return mean_over(grads, axis_group(self.mesh, self.data_axes),
                         self.axes_size(self.data_axes)), None

    def wire_bytes(self, grads) -> int:
        return dense_wire_bytes(grads)


@dataclasses.dataclass(frozen=True)
class HierarchicalInt8EF(GradReduce):
    """Dense within the fast axes, int8 + error feedback across the slow
    one.  Each slow-axis rank pre-divides its gradients by ``dcn_size`` and
    the int8 payloads are summed, so the residual is carried in mean units
    and the result matches ``DenseReduce`` up to quantization noise."""

    dcn_axis: str = "pod"
    ici_axes: Tuple[str, ...] = ()
    dcn_size: int = 1

    name = "int8_ef"
    stateful = True

    def init_state(self, params, param_shardings=None) -> Any:
        """This process's ``[1, *block]`` f32 rows of the global ``[n_dcn,
        *shape]`` EF tree (zeros): with ``param_shardings`` (the parameters'
        specs on the mesh, ``params`` their blocks) the block of
        :meth:`state_shardings`, else the parameter's shape."""
        if param_shardings is None:
            return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                                                  device=p.device), params)

        def one(p, spec):
            whole = [d * f for d, f in zip(p.shape, split_factors(spec, self.mesh))]
            ef_spec = self._row_spec(spec)
            block = [d // f for d, f in zip(whole, split_factors(ef_spec, self.mesh))]
            return torch.zeros([1] + block, dtype=torch.float32, device=p.device)

        return tree_map(one, params, param_shardings)

    def state_specs(self) -> Tuple:
        """The spec of the EF tree's leading ``[n_dcn]`` dim: the slow axis
        (the reference's ``P(dcn_axis)``); the other dims follow the
        parameter's layout without the slow axis (:meth:`state_shardings`)."""
        return (self.dcn_axis,)

    def _row_spec(self, spec) -> Tuple:
        """A parameter's spec without the slow axis (it lays out the rows)."""
        out = []
        for e in spec:
            axes = tuple(a for a in _entry_axes(e) if a != self.dcn_axis)
            out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
        return tuple(out)

    def state_shardings(self, param_shardings, mesh=None) -> Any:
        """Every EF leaf's spec: :meth:`state_specs` on its leading dim, then
        its parameter's spec without the slow axis, so the residuals split
        over "model" and the fast data axes as the gradients they carry and
        no axis is named twice."""
        return tree_map(lambda s: self.state_specs() + self._row_spec(s), param_shardings)

    def state_layout(self, param_shardings) -> Any:
        """``{path: (dimension, fast data axes)}`` of the EF leaves split
        over the fast data axes (``fsdp.layout``'s form; None where whole),
        or None when none is: what the step gathers around
        :meth:`reduce`."""
        from repro_torch.distributed import fsdp

        sizes = mesh_shape(self.mesh)
        out = {}
        for k, s in flatten(self.state_shardings(param_shardings)).items():
            where = fsdp.data_split(s[1:])
            n = 1
            for a in (where[1] if where else ()):
                n *= sizes[a]
            out[k] = (where[0] + 1, where[1]) if where is not None and n > 1 else None
        return out if any(v is not None for v in out.values()) else None

    def state_shards(self, ef, param_shardings=None) -> Any:
        """Each ``[1, *block]`` row as the block at this process's slow-axis
        coordinate (and its blocks over "model" and the fast data axes) of
        the global ``[dcn_size, *shape]`` tree.  The processes that hold
        equal rows (averaged over the fast axes first, or a replicated
        leaf's on every model coordinate) are replicas: the first writes."""
        if self.dcn_size == 1 and param_shardings is None:
            return ef
        if param_shardings is None:
            param_shardings = tree_map(lambda e: (None,) * (e.ndim - 1), ef)
        return shard_tree(ef, self.state_shardings(param_shardings), self.mesh)

    def reduce(self, grads, ef):
        if self.ici_axes:
            grads = mean_over(grads, axis_group(self.mesh, self.ici_axes),
                              self.axes_size(self.ici_axes))
        inv = 1.0 / self.dcn_size
        pre = tree_map(lambda g: g * inv, grads)
        reduced, new_ef = ef_int8_psum(pre, tree_map(lambda e: e[0], ef),
                                       axis_group(self.mesh, (self.dcn_axis,)))
        reduced = tree_map(lambda r, g: r.to(g.dtype), reduced, grads)
        return reduced, tree_map(lambda e: e[None], new_ef)

    def wire_bytes(self, grads) -> int:
        return int8_wire_bytes(grads)


def make_grad_reduce(name: Optional[str], mesh) -> Optional[GradReduce]:
    """A strategy from a ``TrainConfig.grad_compression`` name: "dense" ->
    ``DenseReduce`` over every data-like axis; "int8_ef" ->
    ``HierarchicalInt8EF``, whose slow axis is "pod" when the mesh has one
    (fast = "data"), else the whole "data" axis.  "none" is None, as the
    reference's: on a mesh the step is then the FSDP one."""
    if name in (None, "", "none"):
        return None
    axes = _data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {tuple(mesh_shape(mesh))} has no data-like axis to "
                         f"reduce over")
    if name == "dense":
        return DenseReduce(data_axes=axes, mesh=mesh)
    if name == "int8_ef":
        dcn_axis = "pod" if "pod" in mesh_shape(mesh) else axes[0]
        return HierarchicalInt8EF(
            data_axes=axes, mesh=mesh, dcn_axis=dcn_axis,
            ici_axes=tuple(a for a in axes if a != dcn_axis),
            dcn_size=int(mesh_shape(mesh)[dcn_axis]))
    raise ValueError(f"unknown grad_compression {name!r} (none | dense | int8_ef)")
