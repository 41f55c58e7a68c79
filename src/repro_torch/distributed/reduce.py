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
the process groups of the mesh's axes.  ``models/api.py::make_train_step`` injects the
strategy; the V-cycle threads the state through checkpoints and resets it at
level transitions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.compression import (dense_wire_bytes, ef_int8_psum,
                                                 int8_wire_bytes)
from repro_torch.distributed.multiprocess import ProcessShard
from repro_torch.distributed.sharding import data_axes as _data_axes
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.param import flatten, tree_map, unflatten


def axis_group(mesh, axes: Tuple[str, ...]):
    """The process group spanning ``axes`` of ``mesh``: the axis's own group
    for one axis, the default group when ``axes`` cover every rank (training
    refuses a "model" axis larger than 1, so the data-like axes always do)."""
    if mesh is None:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    n = 1
    for a in axes:
        n *= mesh_shape(mesh)[a]
    if n != dist.get_world_size():
        raise NotImplementedError(f"a group over {axes} that is not the whole world")
    return dist.group.WORLD


def mean_over(tree, group, size: int):
    """Every leaf summed over ``group`` and divided by ``size``, in ONE
    all-reduce per dtype of a packed buffer."""
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

    def init_state(self, params) -> Any:
        return None

    def state_shards(self, ef) -> Any:
        """``ef`` as this process's blocks of the global state tree (what a
        coordinated checkpoint writes and restores per process); ``ef``
        itself when every process holds the whole state."""
        return ef

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

    def init_state(self, params) -> Any:
        """This process's ``[1, *shape]`` f32 rows of the global ``[n_dcn,
        *shape]`` EF tree (zeros)."""
        return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)

    def state_shards(self, ef) -> Any:
        """Each ``[1, *shape]`` row as the row at this process's "pod" (or
        slow-axis) coordinate of the global ``[dcn_size, *shape]`` tree.
        The processes of one slow-axis rank hold equal rows (their
        gradients were averaged over the fast axes first): the one at fast
        coordinate 0 is replica 0 and writes it."""
        if self.dcn_size == 1:
            return ef
        row = self.mesh.get_local_rank(self.dcn_axis)
        replica = 0
        for a in self.ici_axes:
            replica = replica * self.axes_size((a,)) + self.mesh.get_local_rank(a)
        return tree_map(lambda e: ProcessShard(e, (self.dcn_size,) + tuple(e.shape[1:]),
                                               (row,) + (0,) * (e.ndim - 1), replica), ef)

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
    (fast = "data"), else the whole "data" axis.  "none" is None without a
    mesh and ``DenseReduce`` on one: the reference's implicit reduction,
    spelled out."""
    if name in (None, "", "none"):
        if mesh is None:
            return None
        name = "dense"
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
