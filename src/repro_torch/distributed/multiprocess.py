"""Multi-process coordination for data-parallel training (the counterpart of
``repro/distributed/multiprocess.py``, over the default ``torch.distributed``
process group).

Everything here is the identity with one process, so the same training code
serves one process and several.  The global batch does not depend on the
process count: every process regenerates the canonical batch of a step and
keeps the rows its data coordinate addresses (:class:`GlobalBatchFn`).

The reference's key-value store exchanges (``kv_put``/``kv_fetch``, their
streams, ``kv_allgather``, ``any_process_flag``, ``barrier``) serve its
coordinated checkpoints and drain flag, which wait for port slice 14.
"""
from __future__ import annotations

from typing import Any, Optional

import torch.distributed as dist

from repro_torch.distributed.sharding import batch_shardings, mesh_coordinate, mesh_shape


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and the watchdog."""
    return process_index() == 0


def _row_slice(entry, mesh, n_rows: int) -> slice:
    """The rows of a leading dim sharded over ``entry`` (None, an axis or a
    tuple of axes) that this process's mesh coordinate addresses."""
    if entry is None:
        return slice(None)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh_coordinate(mesh)))
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    rows = n_rows // n
    return slice(idx * rows, (idx + 1) * rows)


class GlobalBatchFn:
    """A batch fn for a mesh that spans processes: every process regenerates
    the canonical batch of a step (batches are functions of (seed, step,
    shard)) and keeps the rows its data coordinate addresses, so a
    2-process ``--mesh 2x1`` run consumes the same stream as a 1-process
    run.  A leading dim the data axes do not divide is kept whole
    (replicated), as the reference's batch shardings drop such a mapping."""

    def __init__(self, batch_fn, mesh, rules=None):
        self.inner = batch_fn
        self.mesh = mesh
        self.shardings = batch_shardings(batch_fn(0), mesh, rules)

    def __call__(self, step):
        full = self.inner(step)
        return {k: v[_row_slice(self.shardings[k][0], self.mesh, v.shape[0])]
                for k, v in full.items()}


def as_global_batch_fn(batch_fn, mesh: Optional[Any], rules=None):
    """The multi-process batch fn (the identity with one process or no
    mesh)."""
    if mesh is None or process_count() == 1:
        return batch_fn
    return GlobalBatchFn(batch_fn, mesh, rules)
