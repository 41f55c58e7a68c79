"""Logical-axis -> mesh-axis sharding rules, the mesh context and the
placement helpers (the counterpart of ``repro/distributed/sharding.py``).

One rules table maps every logical axis name to mesh axes.
:func:`logical_spec` drops a mapping whose size does not divide the mesh
axes' product and never assigns a mesh axis twice; it returns one entry per
dimension: ``None``, an axis name, or a tuple of names (the reference's
``PartitionSpec`` as a plain tuple).  A mesh is a ``DeviceMesh`` or anything
with ``axis_names`` and a ``shape`` dict (:func:`mesh_shape`).

Placement is explicit, one process per device: :func:`param_shardings`
gives every ``Spec`` leaf its spec tuple, and a process holds, of each
dimension, the block its mesh coordinate names (:func:`local_slices`;
``distributed/multiprocess.py::put_global_tree`` cuts the blocks).  The
serving path places its parameters and page pools this way
(``models/api.py::serve_shardings``), and training its parameters,
optimizer moments and stashes under :data:`RULES`
(``models/api.py::train_state_shardings``): split over "model" by their
tensor and expert axes and over the data axes by ``embed`` (FSDP).  The
layers compute on their local blocks and meet at the explicit collectives
of ``distributed/tensor_parallel.py``; the FSDP weight gathers of
``distributed/fsdp.py`` hand them weights whole over the data axes.  :func:`mesh_ctx` carries the mesh to
them; they need no rules, since each reads what is split from its local
weights' shapes.  The reference's GSPMD needs ``shard_l``
constraints to place activations; here the layout follows from the local
weights, so :func:`shard_l` stays an identity kept at the reference's call
points.  The batch rows a data-parallel process takes follow
:func:`batch_shardings`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.param import tree_map

AxisMap = Union[None, str, Tuple[str, ...]]

# the data-like axes, resolved per mesh: ("pod", "data") when a "pod" axis exists
FSDP = "__fsdp__"  # parameter (ZeRO-3 style) sharding
DP = "__dp__"  # activation batch dims

RULES: Dict[str, AxisMap] = {
    # --- parameter axes ---
    "embed": FSDP,
    "embed_cat2": FSDP,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "moe_mlp": None,
    "shared_mlp": "model",
    "q_lora": None,
    "kv_lora": None,
    "head_dim": None,
    "v_head_dim": None,
    "rope_dim": None,
    "layers": None,
    "mamba_inner": "model",
    "mamba_state": None,
    "dt_rank": None,
    "conv_k": None,
    "xlstm_inner": "model",
    "vision_embed": None,
    "classes": None,
    "patch": None,
    "mtp": None,
    # --- activation axes ---
    "batch": DP,
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "act_experts_mid": "model",
    "moe_batch": DP,
    "act_vocab": "model",
    "act_mamba": "model",
    "act_xlstm": "model",
    "cache_seq": "model",
    "attn_seq": "model",
    "cache_kv_heads": None,
    "capacity": None,
    "img_seq": None,
    "enc_seq": None,
}

# serving overrides: read-only parameters replicate over the data axes, and
# experts spread over every device
SERVE_RULES: Dict[str, AxisMap] = {
    "experts": ("model", "data"),
    "act_experts": ("model", "data"),
    "moe_batch": None,
    "moe_mlp": "model",
    "embed": None,
    "embed_cat2": None,
}


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, or of anything with
    ``axis_names`` and a ``shape`` dict (as the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: int(n) for a, n in zip(names, mesh.shape)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_coordinate(mesh) -> Optional[Tuple[int, ...]]:
    """This process's coordinate on a ``DeviceMesh`` (None when it is not
    one)."""
    get = getattr(mesh, "get_coordinate", None)
    return tuple(get()) if get is not None else None


def _resolve(rules: Dict[str, AxisMap], mesh, name: str) -> Tuple[str, ...]:
    m = rules.get(name, None)
    names = tuple(mesh_shape(mesh))
    if m is None:
        return ()
    if m in (FSDP, DP):
        return tuple(a for a in ("pod", "data") if a in names)
    if isinstance(m, str):
        return (m,) if m in names else ()
    return tuple(a for a in m if a in names)


def _axis_size(shape: dict, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def logical_spec(shape: Sequence[int], axes: Sequence[str], mesh,
                 rules: Optional[Dict[str, AxisMap]] = None) -> Tuple:
    """One entry per dimension (``None``, an axis name or a tuple of names);
    drops non-divisible mappings and never assigns a mesh axis twice."""
    rules = rules or RULES
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        cand = tuple(a for a in _resolve(rules, mesh, name) if a not in used)
        # drop leading axes until the dim divides (16 experts on a 256-way
        # ("model", "data") serving map -> ("data",) or ("model",))
        while cand and dim % _axis_size(sizes, cand) != 0:
            cand = cand[1:]
        if cand:
            used.update(cand)
            entries.append(cand if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    return tuple(entries)


def param_shardings(specs, mesh, rules=None):
    """The :func:`logical_spec` tuple of every ``Spec`` leaf of ``specs``
    (parameters, optimizer state or caches): the reference's
    ``NamedSharding`` tree without the mesh."""
    return tree_map(lambda s: logical_spec(s.shape, s.axes, mesh, rules), specs)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(shape: Sequence[int], spec: Sequence, mesh,
                 coord: Optional[Sequence[int]] = None) -> Tuple[slice, ...]:
    """This process's block of a global array of ``shape`` laid out by
    ``spec``: per dimension, the slice its mesh coordinate (or ``coord``)
    names.  A dimension over several mesh axes splits major to minor, in
    the order the entry names them (as a ``PartitionSpec`` does)."""
    sizes = mesh_shape(mesh)
    coord = mesh_coordinate(mesh) if coord is None else tuple(coord)
    at = dict(zip(sizes, coord)) if coord is not None else {a: 0 for a in sizes}
    out = []
    for dim, entry in zip(shape, spec):
        idx, n = 0, 1
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + at[a]
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {n} ways ({spec})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def split_factors(spec: Sequence, mesh) -> Tuple[int, ...]:
    """How many blocks each dimension is cut into under ``spec``."""
    sizes = mesh_shape(mesh)
    return tuple(_axis_size(sizes, _entry_axes(e)) for e in spec)


# ---------------------------------------------------------------------------
# the mesh context

_CTX: dict = {"mesh": None, "train": False, "dense_serving": False}


def set_mesh_ctx(mesh, train: bool = False, dense_serving: bool = False) -> None:
    _CTX["mesh"] = mesh
    _CTX["train"] = train
    _CTX["dense_serving"] = dense_serving


@contextlib.contextmanager
def mesh_ctx(mesh, train: bool = False, dense_serving: bool = False):
    """Run inside ``mesh``: the layers find its "model" group here
    (``distributed/tensor_parallel.py``).  ``train`` marks a training step,
    the only place context-parallel attention runs
    (:func:`context_parallel_ways`): the reference enters its mesh context
    to train (and for the dry run), never in its server.
    ``dense_serving`` is the reference's layout for serving on dense
    caches, the dry run's prefill and decode cells: each cache's sequence
    splits over "model" (the ``"cache_seq"`` rule, :func:`cache_seq_ways`)
    and the batch rows over the data axes (:func:`rows_split_over_data`).
    The servers keep their caches whole over the sequence and give every
    data rank the whole batch."""
    prev = dict(_CTX)
    set_mesh_ctx(mesh, train, dense_serving)
    try:
        yield mesh
    finally:
        _CTX.update(prev)


def current_mesh():
    return _CTX["mesh"]


def context_parallel_ways(seq: int) -> int:
    """How many ways a training step's attention splits its query sequence
    of ``seq`` rows (the reference's ``"attn_seq"`` rule, ``RULES``): the
    "model" axis' size inside a ``mesh_ctx(train=True)`` where ``seq``
    divides it, else 1 (``logical_spec``'s drop rule).  The caller asks
    only for a layer that sets ``attn_seq_shard``, has no cache and keeps
    its heads whole."""
    mesh = _CTX["mesh"]
    if mesh is None or not _CTX["train"]:
        return 1
    entry = logical_spec((seq,), ("attn_seq",), mesh)[0]
    return _axis_size(mesh_shape(mesh), _entry_axes(entry))


def rows_split_over_data() -> bool:
    """Whether a serving step's batch rows split over the data axes (the
    ``dense_serving`` of :func:`mesh_ctx`), so that a layer whose weights
    split over "data" (the MoE's experts under ``SERVE_RULES``) must gather
    the other blocks' rows."""
    return _CTX["mesh"] is not None and _CTX["dense_serving"]


def cache_seq_ways() -> int:
    """How many ways the dense decode caches split their sequence (the
    reference's ``"cache_seq"`` rule, flash-decode context parallelism):
    the size of the mesh axes the rule names inside a
    ``mesh_ctx(dense_serving=True)``, else 1.  The caller lays the caches out
    with the same rule (``logical_spec`` of ``"cache_seq"``), so each
    process holds positions ``[c T/M, (c+1) T/M)`` of every K/V head at its
    coordinate c."""
    mesh = _CTX["mesh"]
    if mesh is None or not _CTX["dense_serving"]:
        return 1
    return _axis_size(mesh_shape(mesh), _resolve(RULES, mesh, "cache_seq"))


def shard_l(x, axes: Sequence[str], overrides: Optional[Dict] = None):
    """The reference's logical sharding constraint.  An identity here: a
    process holds its block of every weight, so an activation computed from
    local weights already has the layout the constraint names."""
    return x


def batch_shardings(batch_like, mesh, rules=None):
    """The :func:`logical_spec` of every leaf of a batch tree (tensors or
    anything with a ``shape``): the leading dim is the logical "batch" axis,
    the rest replicate."""
    def one(x):
        axes = ("batch",) + ("seq",) * (len(x.shape) - 1)
        return logical_spec(tuple(x.shape), axes, mesh, rules)

    return tree_map(one, batch_like)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def data_shard_index(mesh=None) -> int:
    """This process's data shard: its coordinate along ("pod", "data"),
    flattened; 0 with one process or no mesh coordinate."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 0
    if mesh is None:
        return dist.get_rank()
    coord = mesh_coordinate(mesh)
    if coord is None:
        return dist.get_rank()
    sizes = mesh_shape(mesh)
    shard = 0
    for a, c in zip(sizes, coord):
        if a in ("pod", "data"):
            shard = shard * sizes[a] + c
    return shard
