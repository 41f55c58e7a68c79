"""What one step costs, counted as it runs: FLOPs, bytes, collectives and
peak live memory (the counterpart of ``repro/launch/hlo_cost.py``).

The reference parses the compiled HLO of its step.  The port runs the step
eagerly under :class:`OpCounter`, a ``TorchDispatchMode``, on meta tensors
for the dry run (``launch/dryrun.py``) or on the card, and counts four
things:

  * FLOPs -- the matrix products and convolutions (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``convolution``, ``_scaled_*``) by
    ``torch.utils.flop_counter``'s formulas (2 per multiply-add), plus the
    costs the hand-written kernels report (``kernels/cost.py``): a kernel
    is no aten op, so its launch or its meta form reports its own;
  * bytes, by the reference's convention: the operands plus the result of
    each op that moves data.  Views, metadata ops and allocations move
    none.  A write into part of a buffer (``copy_`` into a view,
    ``index_put_``, ``scatter``) counts twice the update, and a gather
    (``index``, ``gather``, ``embedding``) twice its result, not the whole
    buffer (the reference's dynamic-update-slice and dynamic-slice rules);
  * collectives, from the ``c10d`` ops and their group's size ``g``, under
    the reference's ring model (per device): all-reduce ``2 B (g-1)/g``,
    all-gather ``B (g-1)/g`` (B the gathered output), reduce-scatter
    ``B_out (g-1)``, all-to-all ``B (g-1)/g``, send/recv ``B``.  Each is
    tagged NVLink when every rank of its group lies in one node of
    ``NODE_SIZE`` consecutive global ranks, and IB otherwise;
  * peak live bytes: the arguments (:meth:`OpCounter.add_arguments`), and
    every storage an op makes from its creation until its last reference
    dies (a weakref finalizer on the storage).

A tally by op kind (count, FLOPs, bytes) rides along.  There are no loop
multipliers to recover, as the reference must for a ``while`` body: eager
execution runs every iteration (every layer, microbatch and recompute).
The one exception is a recurrent mixer's time loop on meta tensors
(``layers/ssm.py``), where one step stands for all of them and its forward
and backward ops count once per step (``kernels/cost.py::repeated``): an op
on a meta tensor costs this process about 0.1-0.2 ms, and Jamba's 63
recurrent layers step 4096 or 32768 times.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.launch.mesh import NODE_SIZE

aten = torch.ops.aten

# allocations and ops that move no data (views are found by their schema)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.detach, aten._local_scalar_dense,
         aten.alias, aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size}
# a write into part of ``self``: twice the update
_UPDATES = {aten.copy_: 1, aten.index_put_: 2, aten.index_put: 2, aten.slice_scatter: 1,
            aten.select_scatter: 1, aten.scatter_: 3, aten.scatter: 3,
            aten.scatter_add_: 3, aten.scatter_add: 3, aten.index_add_: 3,
            aten.index_add: 3, aten.index_copy_: 3, aten.index_copy: 3}
# a read of part of a table: twice the result
_GATHERS = {aten.index, aten.gather, aten.embedding, aten.index_select}

_c10d = torch.ops.c10d
COLLECTIVES = {}
for _name, _kind in (("allreduce_", "all-reduce"), ("allreduce_coalesced_", "all-reduce"),
                     ("allgather_", "all-gather"), ("_allgather_base_", "all-gather"),
                     ("allgather_into_tensor_coalesced_", "all-gather"),
                     ("reduce_scatter_", "reduce-scatter"),
                     ("_reduce_scatter_base_", "reduce-scatter"),
                     ("reduce_scatter_tensor_coalesced_", "reduce-scatter"),
                     ("alltoall_", "all-to-all"), ("alltoall_base_", "all-to-all"),
                     ("send", "send-recv"), ("recv_", "send-recv"),
                     ("broadcast_", "broadcast")):
    if hasattr(_c10d, _name):
        COLLECTIVES[getattr(_c10d, _name)] = _kind


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (nested lists, tuples, dicts):
    elements times their size, a view counted at its own extent."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group(args) -> Optional[dist.ProcessGroup]:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError, AttributeError):
                continue
    return None


def _moved(kind: str, args, g: int) -> float:
    """Bytes a device moves for one collective of group size ``g`` (see
    the module docstring): the tensors it is given, by kind."""
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes(args[0]) * frac
    if kind == "all-gather":
        return nbytes(args[0]) * frac  # the gathered output
    if kind == "reduce-scatter":
        return nbytes(args[0]) * (g - 1)  # the output block
    if kind == "all-to-all":
        return nbytes(args[1]) * frac
    return float(nbytes(args[0]))  # send, recv, broadcast


class OpCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, collectives and live memory (see the
    module docstring).  Use as a context manager around one step; register
    the step's inputs first with :meth:`add_arguments`, and pass its result
    to :meth:`finish` before dropping it."""

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__()
        self.node_size = node_size
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[str, Dict[str, float]] = {}
        self._live: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._kcost = None
        self._depth = 0

    # ---- memory -----------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self.live_bytes -= n

    def add_arguments(self, *trees) -> None:
        """Count the storages of every tensor of ``trees`` (nested dicts,
        lists, tuples) as the step's arguments: live from the start."""
        for tree in trees:
            for t in _tensors(tree):
                key = self._key(t)
                if key not in self._args:
                    self._args[key] = t.untyped_storage().nbytes()
                self._track(t)

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def finish(self, result) -> None:
        """Count the step's ``result`` as its outputs, and those that alias
        an argument (a state updated in place and returned) apart too."""
        seen = set()
        for t in _tensors(result):
            key = self._key(t)
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            self.output_bytes += n
            if key in self._args:
                self.alias_bytes += n

    # ---- the mode ---------------------------------------------------------
    def __enter__(self):
        # the mode re-enters itself to count a composite op's parts: the
        # kernels' recorder is pushed on the outermost entry only
        if self._depth == 0:
            self._kcost = kcost.recording(self._record_kernel)
            self._kcost.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._kcost.__exit__(*exc)

    def _record_kernel(self, name: str, flops: float, nbytes_: float, n: int) -> None:
        k = self.kernels.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        k["count"] += n
        k["flops"] += flops * n
        k["bytes"] += nbytes_ * n
        self.flops += flops * n
        self.bytes += nbytes_ * n

    def _bytes_of(self, packet, func, args, kwargs, out) -> float:
        if packet in _FREE or func.is_view:
            return 0.0
        if packet in _UPDATES:
            upd = args[_UPDATES[packet]] if len(args) > _UPDATES[packet] else None
            if packet is aten.copy_:  # dst is the view written
                return float(nbytes(args[0]) + nbytes(args[1]))
            if isinstance(upd, torch.Tensor):
                return 2.0 * nbytes(upd)
        if packet in _GATHERS:
            return 2.0 * nbytes(out)
        return float(nbytes(args) + nbytes(kwargs) + nbytes(out))

    def _collective(self, kind: str, args) -> None:
        pg = _group(args)
        g = pg.size() if pg is not None else 1
        c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0,
                                               "nvlink_bytes": 0.0, "ib_bytes": 0.0})
        c["count"] += 1
        if g <= 1:
            return
        moved = _moved(kind, args, g)
        ranks = dist.get_process_group_ranks(pg)
        link = "nvlink" if len({r // self.node_size for r in ranks}) == 1 else "ib"
        c["bytes"] += moved
        c[f"{link}_bytes"] += moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._can_decompose():
            # a composite op reaches the mode whole where autograd is off
            # (inference mode): count the ops it is made of, as a step with
            # autograd on sees them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = str(packet).removeprefix("aten.")
        kind = COLLECTIVES.get(packet)
        n = kcost.multiplier()
        if kind is not None:
            for _ in range(n):
                self._collective(kind, args)
            flops = nb = 0.0
        else:
            flops = 0.0
            fn = flop_registry.get(packet)
            if fn is not None:
                flops = float(fn(*args, **kwargs, out_val=out)) * n
            nb = self._bytes_of(packet, func, args, kwargs, out) * n
            self.flops += flops
            self.bytes += nb
        t = self.by_op.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        t["count"] += n
        t["flops"] += flops
        t["bytes"] += nb
        for o in _tensors(out):
            self._track(o)
        return out

    # ---- summaries ----------------------------------------------------------
    def collective_totals(self) -> Dict[str, Dict[str, float]]:
        """Per kind ``{"count", "bytes", "nvlink_bytes", "ib_bytes"}`` and
        their ``"total"`` (the reference's keys)."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total"] = {f: sum(v[f] for v in self.collectives.values())
                        for f in ("count", "bytes", "nvlink_bytes", "ib_bytes")}
        return out

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collective_totals(),
                "peak_bytes": self.peak_bytes, "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes, "alias_bytes": self.alias_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "by_op": {k: dict(v) for k, v in self.by_op.items()}}


def count_step(step, *args, arguments=None, **kwargs):
    """(result, counter) of ``step(*args, **kwargs)`` run once under a fresh
    :class:`OpCounter`, with ``arguments`` (default ``args``) counted as
    live from the start."""
    counter = OpCounter()
    counter.add_arguments(args if arguments is None else arguments)
    with counter:
        result = step(*args, **kwargs)
    counter.finish(result)
    return result, counter
