"""Multi-process coordination for data-parallel training (the counterpart of
``repro/distributed/multiprocess.py``, over the default ``torch.distributed``
process group).

Everything here is the identity with one process, so the same training code
serves one process and several.  The global batch does not depend on the
process count: every process regenerates the canonical batch of a step and
keeps the rows its data coordinate addresses (:class:`GlobalBatchFn`).

Three facts the rest of the port leans on, as in the reference:

* **Collectives are called symmetrically.**  Every process reaches the same
  collective in the same order, so the preemption drain is polled once per
  step on every process (:func:`any_process_flag`, or
  :class:`FusedDrainFlag`, which rides the step's own all-reduce).
* **Host exchanges go through the group's store.**  ``launch/mesh.py``
  makes the process group on an explicit ``TCPStore`` (process 0 hosts it)
  and hands it to :func:`bind_store`; :func:`barrier` and the ``kv_*``
  exchanges are plain RPCs to it, never device collectives, so they are
  safe between training steps under NCCL too.
* **A process's block of a global array is explicit.**  Torch tensors do
  not know they are shards: :class:`ProcessShard` says where a tensor lies
  in the global array, on any dimensions (a leaf split over the data axes
  or "model", the int8_ef residuals' ``[n_dcn, *shape]``), and which
  replica of it this
  process holds, which is what coordinated checkpoints write and read per
  process (:func:`shard_tree` makes them from a spec tree).
  :func:`put_global_tree` cuts a global tree into this process's blocks by
  a spec tree (``sharding.param_shardings``), and :func:`gather_global_tree`
  assembles the global tree back from every process's blocks.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (_entry_axes, batch_shardings, current_mesh,
                                              local_slices, mesh_coordinate, mesh_shape,
                                              split_factors)
from repro_torch.param import tree_map

_BARRIER_TIMEOUT_S = 600.0
_KEY_PREFIX = "repro:"
# the store the default process group was made on (``bind_store``), and this
# process's key of its last barrier (deleted at the next one)
_STORE = None
_LAST_BARRIER_KEY: Optional[str] = None


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
        self.like = batch_like(batch_fn)  # the global shapes
        self.shardings = batch_shardings(self.like, mesh, rules)

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


def batch_like(batch_fn):
    """The batch of ``batch_fn`` as meta tensors (shapes and dtypes, no
    data) -- honours a precomputed ``.like`` (set by :class:`GlobalBatchFn`,
    whose per-process rows are not the global shapes)."""
    like = getattr(batch_fn, "like", None)
    if like is not None:
        return like
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch_fn(0).items()}


# ---------------------------------------------------------------------------
# the store exchanges


def bind_store(store) -> None:
    """Keep ``store`` -- the one the default process group was made on -- for
    :func:`barrier` and the ``kv_*`` exchanges (``launch/mesh.py`` calls
    this)."""
    global _STORE, _LAST_BARRIER_KEY
    _STORE, _LAST_BARRIER_KEY = store, None


def _require_store():
    if _STORE is None or not dist.is_initialized():
        raise RuntimeError(
            "the key-value exchanges need the process group's store "
            "(repro_torch.launch.mesh.init_distributed or make_cli_mesh)")
    return _STORE


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def barrier(name: str) -> None:
    """Block until every process reaches this barrier (a no-op with one
    process).  ``name`` is unique per synchronization point (the checkpoint
    manager keys it on a per-save sequence number).  A store barrier: each
    process sets one key, then waits for every process's key -- a host RPC,
    never ``dist.barrier()``, which under NCCL would launch a device
    collective between steps.  Each process deletes its key of the barrier
    before this one: every process has set its key here only after passing
    that one, so no process still waits on it."""
    global _LAST_BARRIER_KEY
    if process_count() == 1:
        return
    store = _require_store()
    key = f"{_KEY_PREFIX}barrier/{name}/"
    store.set(key + str(process_index()), b"1")
    store.wait([key + str(r) for r in range(process_count())],
               _timeout(_BARRIER_TIMEOUT_S))
    if _LAST_BARRIER_KEY is not None:
        store.delete_key(_LAST_BARRIER_KEY)
    _LAST_BARRIER_KEY = key + str(process_index())


def kv_put(key: str, payload: bytes) -> None:
    """Publish bytes under ``key`` in the group's store.  Keys are unique per
    run (callers scope them with per-instance sequence counters)."""
    _require_store().set(_KEY_PREFIX + key, payload)


def kv_fetch(key: str, timeout_s: float = _BARRIER_TIMEOUT_S) -> bytes:
    """Block until some process publishes ``key`` (:func:`kv_put`); returns its bytes."""
    store = _require_store()
    store.wait([_KEY_PREFIX + key], _timeout(timeout_s))
    return bytes(store.get(_KEY_PREFIX + key))


def kv_delete(key: str) -> None:
    """Best-effort delete of an entry.  Process 0's store holds every key in
    memory for the life of the job, so producers delete once every consumer
    is provably past its fetch (after a barrier); a failure is swallowed (a
    leaked key is a leak, not a fault)."""
    try:
        _require_store().delete_key(_KEY_PREFIX + key)
    except Exception:
        pass


def _kv_chunk_bytes() -> int:
    """The most bytes in one store message (``REPRO_KV_CHUNK_BYTES``; tests
    shrink it to force streams of several parts)."""
    return max(1, int(os.environ.get("REPRO_KV_CHUNK_BYTES", 2 * 1024 * 1024)))


def kv_put_stream(key: str, payload: bytes) -> None:
    """Publish any number of bytes under ``key`` as parts of at most
    :func:`_kv_chunk_bytes` (``{key}/part{i}``); the part count goes LAST,
    under ``{key}/meta``, so a :func:`kv_fetch_stream` that sees it finds
    every part published.  (The reference prefixes each part with two bytes
    for its coordination service's sake; the store needs no prefix.)"""
    chunk = _kv_chunk_bytes()
    n = max(1, -(-len(payload) // chunk))
    for i in range(n):
        kv_put(f"{key}/part{i}", payload[i * chunk:(i + 1) * chunk])
    kv_put(f"{key}/meta", f"n={n}".encode())


def kv_fetch_stream(key: str, timeout_s: float = _BARRIER_TIMEOUT_S) -> bytes:
    """Block until :func:`kv_put_stream` publishes ``key``; the parts joined
    in order."""
    n = int(kv_fetch(f"{key}/meta", timeout_s).decode().split("=", 1)[1])
    return b"".join(kv_fetch(f"{key}/part{i}", timeout_s) for i in range(n))


def kv_delete_stream(key: str) -> None:
    """Best-effort cleanup of a streamed key (as :func:`kv_delete`: only
    after every consumer is past its fetch)."""
    try:
        n = int(kv_fetch(f"{key}/meta", timeout_s=1.0).decode().split("=", 1)[1])
    except Exception:
        return
    for i in range(n):
        kv_delete(f"{key}/part{i}")
    kv_delete(f"{key}/meta")


def kv_allgather(tag: str, payload: bytes, timeout_s: float = _BARRIER_TIMEOUT_S) -> list:
    """Every process contributes ``payload`` under ``tag``; returns every
    process's payload, in rank order, the same everywhere.  A collective:
    put, fetch all, barrier (every consumer is past its fetches), then
    process 0 deletes the keys.  ``tag`` is unique per exchange."""
    pid, n = process_index(), process_count()
    kv_put(f"{tag}-{pid}", payload)
    out = [kv_fetch(f"{tag}-{r}", timeout_s) for r in range(n)]
    barrier(f"{tag}-ag")
    if pid == 0:
        for r in range(n):
            kv_delete(f"{tag}-{r}")
    return out


def kv_json_allgather(tag: str, obj: Any, timeout_s: float = _BARRIER_TIMEOUT_S) -> list:
    """:func:`kv_allgather` of JSON-serializable objects (the checkpoint
    manager's elections, manifest merges and have/want lists)."""
    return [json.loads(p) for p in kv_allgather(tag, json.dumps(obj).encode(), timeout_s)]


def any_process_flag(flag: bool) -> bool:
    """The OR of a host flag over every process (the identity with one).  A
    collective -- one MAX all-reduce of one int over the default group --
    so every process calls it at the same point, and every process sees the
    same answer at the same step."""
    if process_count() == 1:
        return bool(flag)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


class FusedDrainFlag:
    """The preemption drain flag, carried by the train step's own
    all-reduce instead of a collective of its own.

    The reference feeds the flag into its jitted step as a mesh-shaped input
    and reduces it there.  The port has no jit: the data-parallel step
    (``models/api.py``) appends :meth:`value` -- 1.0 when this process's
    guard was signalled -- as one more element of the metrics vector it
    already SUM-reduces over every rank, hands the summed element to
    :meth:`observe`, and :meth:`last` reads sum > 0.  So a notice on ANY one
    process is seen by every process after the same step, and the poll adds
    no collective."""

    def __init__(self, guard=None):
        self.guard = guard  # anything with a host ``triggered`` bool
        self._last = None

    def value(self) -> float:
        """This step's contribution: 1.0 when this process was signalled."""
        return 1.0 if getattr(self.guard, "triggered", False) else 0.0

    def observe(self, drain) -> None:
        """Record the step's summed flag (a device scalar, read lazily)."""
        self._last = drain

    def last(self) -> bool:
        """True when some process was signalled as of the last step."""
        return self._last is not None and float(self._last) > 0


class ProcessShard:
    """This process's piece of a global array: ``local`` is the block at
    ``start`` of an array of ``global_shape`` (the reference's non-fully
    addressable array, which torch tensors cannot express).  ``replica`` is
    nonzero on a process whose block another process (replica 0) holds too:
    only replica 0 writes it.  Coordinated checkpoints write ``local`` as a
    chunk at ``start`` and restore only the chunks it touches
    (``checkpoint/store.py::needed_digests`` reads
    :meth:`addressable_devices_indices_map`, as the reference's reads a
    sharding's)."""

    is_fully_addressable = False

    def __init__(self, local: torch.Tensor, global_shape: Tuple[int, ...],
                 start: Tuple[int, ...], replica: int = 0):
        if len(start) != len(global_shape) or len(local.shape) != len(global_shape):
            raise ValueError(f"a block of shape {tuple(local.shape)} at {tuple(start)} "
                             f"cannot lie in an array of shape {tuple(global_shape)}")
        self.local = local
        self.shape = tuple(int(d) for d in global_shape)
        self.start = tuple(int(s) for s in start)
        self.replica = int(replica)

    @property
    def index(self) -> Tuple[slice, ...]:
        """The block's slices of the global array."""
        return tuple(slice(st, st + n) for st, n in zip(self.start, self.local.shape))

    def addressable_devices_indices_map(self, shape) -> dict:
        if tuple(shape) != self.shape:
            raise ValueError(f"a block of an array of shape {self.shape} asked "
                             f"about shape {tuple(shape)}")
        return {process_index(): self.index}


def process_shard(local: torch.Tensor, spec, mesh, shape=None):
    """``local`` -- this process's block under ``spec`` on ``mesh`` of a
    global array of ``shape`` (by default the block's shape times the split
    factors) -- as a :class:`ProcessShard`; its replica index is this
    process's coordinate over the mesh axes ``spec`` does not use (the
    processes holding the same block), flattened.  ``local`` itself when
    ``spec`` splits nothing: a replicated leaf, written whole by process 0."""
    factors = split_factors(spec, mesh)
    if all(f == 1 for f in factors):
        return local
    if shape is None:
        shape = tuple(d * f for d, f in zip(local.shape, factors))
    start = tuple(sl.start for sl in local_slices(shape, spec, mesh))
    used = {a for e in spec for a in _entry_axes(e)}
    sizes = mesh_shape(mesh)
    replica = 0
    for a, c in zip(sizes, mesh_coordinate(mesh)):
        if a not in used:
            replica = replica * sizes[a] + c
    return ProcessShard(local, shape, start, replica)


def shard_tree(tree, shardings, mesh):
    """:func:`process_shard` over a tree of local blocks and its spec tree
    (``shardings=None`` is the identity)."""
    if shardings is None:
        return tree
    return tree_map(lambda x, s: process_shard(x, s, mesh) if torch.is_tensor(x) else x,
                    tree, shardings)


def like_shard_tree(like, shardings, mesh):
    """Restore like-trees for a target layout: each leaf of the GLOBAL
    ``like`` tree (any device, "meta" too) that ``shardings`` splits becomes
    a :class:`ProcessShard` over an empty block of its dtype and device, so
    a restore lands this process's block only (``CheckpointManager.restore
    (shardings=)``)."""
    def one(x, spec):
        if not torch.is_tensor(x):
            return x
        block = tuple(d // f for d, f in zip(x.shape, split_factors(spec, mesh)))
        local = torch.empty(block, dtype=x.dtype, device=x.device)
        return process_shard(local, spec, mesh, shape=tuple(x.shape)) if block != x.shape else x

    return tree_map(one, like, shardings)


# ---------------------------------------------------------------------------
# placement by spec trees


def put_global(x: torch.Tensor, spec, mesh=None, device=None) -> torch.Tensor:
    """This process's block of the global tensor ``x`` (whole on every
    process) under ``spec`` (a ``logical_spec`` tuple; None is the
    identity): a fresh contiguous tensor on ``device`` (default: ``x``'s),
    so the global value can be freed.  ``mesh`` defaults to the mesh
    context's."""
    if spec is None or not torch.is_tensor(x):  # AdamW's count is a Python int
        return x
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("put_global needs a mesh (or an active mesh_ctx)")
    block = x[local_slices(tuple(x.shape), spec, mesh)]
    out = torch.empty(block.shape, dtype=block.dtype,
                      device=device if device is not None else x.device)
    return out.copy_(block)


def put_global_tree(tree, shardings, mesh=None, device=None):
    """:func:`put_global` over a tree and its spec tree (``shardings=None``
    is the identity)."""
    if shardings is None:
        return tree
    return tree_map(lambda x, s: put_global(x, s, mesh, device), tree, shardings)


def gather_global(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The global array whose block ``x`` is, assembled from every
    process's block with ``all_gather`` over each split dimension's mesh
    axes (minor axis first); a collective, called by every process."""
    mesh = mesh if mesh is not None else current_mesh()
    if spec is None or mesh is None:
        return x
    sizes = mesh_shape(mesh)
    for d, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            if sizes[a] == 1:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(sizes[a])]
            dist.all_gather(parts, x, group=mesh.get_group(a))
            x = torch.cat(parts, d)
    return x


def gather_global_tree(tree, shardings, mesh=None):
    """The inverse of :func:`put_global_tree`: every leaf's global array,
    on every process (a collective per split leaf)."""
    if shardings is None:
        return tree
    return tree_map(lambda x, s: gather_global(x, s, mesh), tree, shardings)
