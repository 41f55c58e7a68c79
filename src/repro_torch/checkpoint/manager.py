"""Fault-tolerant checkpointing: the single-process part of
``repro/checkpoint/manager.py``, on torch trees.

* **Atomic**: each save writes into ``step_XXXXXXXX.tmp/``, renames it to
  ``step_XXXXXXXX/`` and then replaces ``manifest.json``; a crash at any
  point leaves the previous checkpoint intact.  A manifest that names a
  missing directory falls back to the newest published one.
* **Content-addressed (layout v3, the default)**: leaves go once into the
  ``objects/`` pool (``checkpoint/store.py``) and the step directory holds an
  ``objects.json`` manifest, so consecutive saves rewrite only the leaves
  whose content changed (``last_save_stats`` measures it) and GC is
  manifest-driven refcounting.  ``dedup=False`` writes the v2 whole-file
  layout (percent-encoded leaf names); v1 (``/`` stored as ``__``) and v2
  directories, including those of the reference's coordinated multi-process
  saves, stay readable.
* **Async**: ``save(..., blocking=False)`` copies every leaf to host memory
  before it returns -- the training loop updates parameters and moments in
  place right after -- and writes the files on a background thread.
* **keep_last**: old steps are collected after a successful save, never the
  directory ``manifest.json`` references; pool objects go when no kept step
  manifest references their digest.

Leaf names are the reference's: dict keys sorted, list items numbered, joined
by ``/``.  A Python ``int`` leaf -- AdamW's ``count`` -- is stored as an int32
0-d array, as the reference holds it, and restores as an ``int``; so either
package restores the other's optimizer.  Restored leaves are each a tensor
of their own, also where two leaves share one pool object (``m`` and ``v`` at
step 0, a stash equal to the parameters): the in-place AdamW must never
write into two leaves at once.

Not ported (they need a mesh or several processes): coordinated saves,
``local=True`` per-host directories and ``peer_dirs``.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np
import torch

from repro_torch.checkpoint import store as store_lib
from repro_torch.checkpoint.store import ObjectStore

# v2 layout marker written into every tree dir: leaf paths are percent-encoded
_LAYOUT_MARKER = "leafenc.json"
_LAYOUT_VERSION = 2
# per-process chunk index of a coordinated (multi-process) v2 save
_SHARD_INDEX = "index.json"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(flat: Dict[str, Any], like):
    def rec(t, prefix):
        if isinstance(t, dict):
            return {k: rec(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)([rec(v, f"{prefix}{i}/") for i, v in enumerate(t)])
        return flat[prefix.rstrip("/")]

    return rec(like, "")


def _host_leaf(x) -> np.ndarray:
    """One leaf as a host array owned by the snapshot (device tensors are
    copied off the card before this returns); a Python int -- AdamW's count
    -- becomes an int32 0-d array, the reference's form of it."""
    if isinstance(x, int) and not isinstance(x, bool):
        return np.asarray(x, np.int32)
    if isinstance(x, np.ndarray):
        return store_lib.as_host_leaf(x.copy())
    return store_lib.as_host_leaf(x)


def _host_tree(tree) -> Dict[str, np.ndarray]:
    return {k: _host_leaf(v) for k, v in _flatten(tree).items()}


def save_tree(path: str, tree) -> None:
    """Whole-leaf v2 layout (one ``.npy`` per leaf path)."""
    _save_flat(path, _host_tree(tree))


def _save_flat(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(path, exist_ok=True)
    for k, v in flat.items():
        np.save(os.path.join(path, quote(k, safe="") + ".npy"), v, allow_pickle=False)
    with open(os.path.join(path, _LAYOUT_MARKER), "w") as f:
        json.dump({"version": _LAYOUT_VERSION, "encoding": "percent"}, f)


def _read_leaves(path: str, pools: Optional[List[ObjectStore]] = None
                 ) -> Dict[str, np.ndarray]:
    """All leaves of one tree dir as logical host arrays: v3 step manifests
    (digests resolved through ``pools``, by default the checkpoint root's
    pool), whole-leaf files (v2 percent-encoded, legacy ``__``) and the chunk
    files of coordinated v2 saves in sibling ``shard_<pid>/`` dirs."""
    step_dir, tree_key = os.path.split(os.path.normpath(path))
    trees = store_lib.read_step_manifest(step_dir) if step_dir else None
    if trees is not None:
        if pools is None:
            pools = [ObjectStore(os.path.dirname(step_dir))]
        return store_lib.assemble_tree(trees.get(tree_key, {}), pools)
    flat: Dict[str, np.ndarray] = {}
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, _LAYOUT_MARKER)):
            decode = unquote
        else:  # legacy layout: "/" was stored as "__"
            decode = lambda s: s.replace("__", "/")
        for fn in os.listdir(path):
            if fn.endswith(".npy"):
                flat[decode(fn[:-4])] = np.load(os.path.join(path, fn),
                                                allow_pickle=False)
    for sd in sorted(glob.glob(os.path.join(step_dir, "shard_*"))):
        idx_path = os.path.join(sd, _SHARD_INDEX)
        if not os.path.exists(idx_path):
            continue
        with open(idx_path) as f:
            index = json.load(f)["trees"]
        for k, rec in index.get(tree_key, {}).items():
            for ch in rec["chunks"]:
                data = np.load(os.path.join(sd, tree_key, ch["file"]),
                               allow_pickle=False)
                if k not in flat:
                    flat[k] = np.empty(rec["shape"], dtype=data.dtype)
                sl = tuple(slice(st, st + sz)
                           for st, sz in zip(ch["start"], ch["shape"]))
                flat[k][sl] = data
    return flat


# numpy dtypes a restored leaf may have (torch.from_numpy takes each)
_RESTORABLE = {"float64", "float32", "float16", "int64", "int32", "int16", "int8",
               "uint8", "bool", store_lib.BF16}


def _to_tensor(host: np.ndarray) -> torch.Tensor:
    """A tensor over ``host`` (a bf16 leaf from its 2-byte host form).
    Every restored host array is read afresh for its leaf, so the tensors of
    two leaves never share memory; a read-only array is copied first."""
    name = store_lib.dtype_name(host.dtype)
    if name not in _RESTORABLE:
        raise ValueError(f"cannot restore a checkpoint leaf of dtype {name!r}")
    if not host.flags.writeable:
        host = host.copy()
    if name == store_lib.BF16:
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host)


def _put(x: np.ndarray, like, device=None):
    """Land one restored logical leaf in the form of its like-leaf: a tensor
    of the like's dtype on ``device`` (default: the like's device), or a
    Python int (AdamW's count)."""
    host = np.asarray(x)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(host)
    if not isinstance(like, torch.Tensor):
        raise TypeError(f"cannot restore onto a like-leaf of type {type(like).__name__}")
    if tuple(host.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {host.shape} cannot land on "
                         f"a like-leaf of shape {tuple(like.shape)}")
    return _to_tensor(host).to(device=device if device is not None else like.device,
                               dtype=like.dtype)


def _land_tree(flat: Dict[str, np.ndarray], like, device=None):
    """Unflatten restored logical leaves into ``like``'s structure and land
    them (see :func:`_put`)."""
    flat_like = _flatten(like)
    missing = sorted(set(flat_like) - set(flat))
    if missing:
        raise KeyError(f"checkpoint lacks leaves {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    return _unflatten_into({k: _put(flat[k], l, device) for k, l in flat_like.items()},
                           like)


def restore_tree(path: str, like, device=None,
                 pools: Optional[List[ObjectStore]] = None):
    return _land_tree(_read_leaves(path, pools=pools), like, device)


class CheckpointManager:
    """Atomic, content-addressed checkpoints of named trees, single process.

    ``save(step, {"params": ..., "opt": ...}, meta=...)`` publishes a step
    (v3 pool objects + manifest, or v2 whole files with ``dedup=False``);
    ``restore(like)`` lands the newest valid step onto torch like-trees.
    """

    def __init__(self, directory: str, keep_last: int = 3, *, dedup: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.dedup = bool(dedup)
        self.store = ObjectStore(directory)
        #: dedup accounting of the most recent v3 save:
        #: {bytes,objects}_{written,reused} (reused = content-addressed hits)
        self.last_save_stats: Dict[str, int] = {}
        self.last_gather_stats: Dict[str, int] = {}
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _pools(self) -> List[ObjectStore]:
        return [self.store]

    # ---- manifest ----------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest valid checkpoint's manifest record, or None."""
        if not os.path.exists(self.manifest_path):
            return None
        with open(self.manifest_path) as f:
            m = json.load(f)
        if not os.path.isdir(os.path.join(self.dir, m["dir"])):
            return self._scan_fallback()  # torn manifest
        return m

    def step_manifest(self, m: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The content-addressed (v3) manifest of the step ``m`` (a
        :meth:`latest` result) references: ``{tree_key -> {leaf_path ->
        {shape, dtype, chunks: [{digest, ...}]}}}``; None for a step written
        in the v1/v2 layout, which carries no digests to diff."""
        return store_lib.read_step_manifest(os.path.join(self.dir, m["dir"]))

    def assemble_diff(self, trees: Dict[str, Any], key: str,
                      leaves) -> Dict[str, np.ndarray]:
        """Host arrays for exactly ``leaves`` of tree ``key`` -- the
        digest-diff restore behind live weight reload: the caller passes only
        the changed leaf paths, and no other leaf is read.
        ``last_gather_stats`` records the split (in the reference's form)."""
        entries = {k: trees[key][k] for k in leaves}
        needed = {ch["digest"] for rec in entries.values() for ch in rec["chunks"]}
        pools = self._pools()
        all_digests = sorted(set(store_lib.manifest_digests(trees)))
        have = [d for d in all_digests if any(p.has(d) for p in pools)]
        self.last_gather_stats = {
            "manifest": len(all_digests), "needed": len(needed),
            "skipped": len(all_digests) - len(needed), "held": len(have),
            "fetched": len(needed - set(have)), "served": 0}
        return store_lib.assemble_tree(entries, pools)

    def _step_dirs(self) -> list:
        """Published step dirs, oldest publish first (mtime order, name as
        tie-break): a restarted run with a shorter schedule publishes smaller
        step numbers than stale dirs of a longer one."""

        def key(d):
            try:
                mt = os.path.getmtime(os.path.join(self.dir, d))
            except OSError:
                mt = 0.0
            return (mt, d)

        return sorted((d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp")
                       and os.path.isdir(os.path.join(self.dir, d))), key=key)

    def _scan_fallback(self) -> Optional[Dict[str, Any]]:
        cands = self._step_dirs()
        if not cands:
            return None
        d = cands[-1]
        meta_p = os.path.join(self.dir, d, "meta.json")
        meta = {}
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                meta = json.load(f)
        return {"dir": d, "step": int(d.split("_")[1]), "meta": meta}

    # ---- save ---------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], meta: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """``state``: named trees, e.g. ``{"params": ..., "opt": ...}``.
        Every leaf is on the host, in a copy of its own, before this returns;
        with ``blocking=False`` the files are written on a background thread
        (the next ``save`` or ``wait`` joins it)."""
        self.wait()
        host_state = {key: _host_tree(tree) for key, tree in state.items()}

        def _write():
            name = f"step_{step:08d}"
            tmp = os.path.join(self.dir, name + ".tmp")
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            if self.dedup:
                before = self.store.stats()
                trees = {key: self._pool_whole_tree(flat)
                         for key, flat in host_state.items()}
                store_lib.write_step_manifest(tmp, trees)
                self._set_save_stats(before)
            else:
                for key, flat in host_state.items():
                    _save_flat(os.path.join(tmp, key), flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta or {}, f)
            self._publish(name, tmp, step, meta)

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _set_save_stats(self, before: Dict[str, int]) -> None:
        after = self.store.stats()
        self.last_save_stats = {k: after[k] - before[k] for k in after}

    def _pool_whole_tree(self, flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Pool every leaf of one flattened host tree whole; returns the
        manifest entries."""
        entries: Dict[str, Any] = {}
        for k, v in flat.items():
            d = store_lib.leaf_digest(v)
            self.store.put(d, v)
            entries[k] = store_lib.whole_leaf_entry(d, v)
        return entries

    def _publish(self, name: str, tmp: str, step: int,
                 meta: Optional[Dict]) -> None:
        """Atomic publish: rename the staged step dir, replace
        ``manifest.json``, GC."""
        final = os.path.join(self.dir, name)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(self.manifest_path + ".tmp", "w") as f:
            json.dump({"dir": name, "step": step, "meta": meta or {}}, f)
        os.replace(self.manifest_path + ".tmp", self.manifest_path)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        # keep the keep_last most recently published dirs and, whatever its
        # age, the one the manifest references
        current = None
        try:
            with open(self.manifest_path) as f:
                current = json.load(f).get("dir")
        except (OSError, ValueError):
            pass
        for d in self._step_dirs()[:-self.keep_last]:
            if d != current:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        # stale .tmp dirs of a crashed earlier save (none is being filled: GC
        # runs inside a publish, after the write)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp") and os.path.isdir(os.path.join(self.dir, d)):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        # refcount GC of the pool: an object is live iff a kept step
        # manifest references it (orphans of a crash are reclaimed here)
        live = set()
        for d in self._step_dirs():
            trees = store_lib.read_step_manifest(os.path.join(self.dir, d))
            if trees is not None:
                live.update(store_lib.manifest_digests(trees))
        for dig in list(self.store.digests()):
            if dig not in live:
                self.store.delete(dig)

    # ---- restore --------------------------------------------------------
    def restore(self, like_state: Dict[str, Any], device=None):
        """``(state, meta)`` from the newest valid checkpoint, or ``(None,
        None)``.  Each tree of ``like_state`` lands in its like-tree's form
        (see :func:`_put`), on ``device`` when given."""
        m = self.latest()
        if m is None:
            return None, None
        trees = self.step_manifest(m)
        base = os.path.join(self.dir, m["dir"])
        out = {}
        for key, like in like_state.items():
            if trees is not None:
                flat = store_lib.assemble_tree(trees.get(key, {}), self._pools())
            else:
                flat = _read_leaves(os.path.join(base, key), pools=self._pools())
            out[key] = _land_tree(flat, like, device)
        return out, m.get("meta", {})
