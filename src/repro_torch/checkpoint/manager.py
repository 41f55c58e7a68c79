"""Fault-tolerant checkpointing: ``repro/checkpoint/manager.py`` on torch
trees, for one process and for several.

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
* **Coordinated (several processes)**: every process calls ``save`` at the
  same step.  Into a SHARED directory each process writes only its own
  chunks -- as pool objects (v3) or ``shard_<pid>/`` chunk files (v2) --
  all meet at a barrier, and process 0 alone publishes; a crash on any
  process before the barrier leaves the previous checkpoint intact.  A
  replicated leaf (parameters, AdamW moments, the V-cycle stashes) is
  written whole by process 0; a :class:`~repro_torch.distributed.ProcessShard`
  (a leaf split over "model", the int8_ef residuals' rows) is written as a
  chunk at its start by the first of the processes that hold that block
  (its replica 0), so every block is written once and the files hold
  logical arrays.  Coordinated saves are always blocking, with three barriers:
  prepared, written, published.
* **Per-process LOCAL directories** (``local=True``, no shared filesystem):
  each process pools its chunks in its OWN directory, only digests cross
  the network (the group's store, ``distributed/multiprocess.py``), and
  every process publishes the merged manifest into its own directory, so
  any surviving host is self-describing.  ``latest`` is an election over
  every process's directory (it survives a fresh or lost rank-0
  directory); ``restore`` gathers the objects a process needs and lacks
  from the lowest rank holding each, checks each digest before caching it,
  and raises when no rank holds one.  ``peer_dirs`` are other processes'
  recovered directories, read directly (a restore with fewer processes).
  One process with ``local=True`` is plain v3.
* **Async**: ``save(..., blocking=False)`` copies every leaf to host memory
  before it returns -- the training loop updates parameters and moments in
  place right after -- and writes the files on a background thread (one
  process only).
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

Like-leaves that are ``ProcessShard`` objects restore this process's block only,
reading just the chunks it touches (``store.needed_digests``); a
``ProcessShard`` is not fully addressable, so the one-process path
(``save_tree``, a one-process ``save``) refuses it.  ``restore(shardings=)``
makes them from global like-trees and a target layout, so a checkpoint
written on one mesh restores onto another mesh's layout, or onto one
process.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np
import torch

from repro_torch.checkpoint import store as store_lib
from repro_torch.checkpoint.store import ObjectStore
from repro_torch.distributed import multiprocess as mp

# v2 layout marker written into every tree dir: leaf paths are percent-encoded
_LAYOUT_MARKER = "leafenc.json"
_LAYOUT_VERSION = 2
# per-process chunk index of a coordinated (multi-process) v2 save
_SHARD_INDEX = "index.json"

# per-process count of managers: scopes the store keys and barriers, so
# managers never collide.  Every process builds its managers in the same
# order (they run the same program), which keeps the scopes aligned.
_MANAGER_COUNT = 0


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
    if getattr(x, "is_fully_addressable", True) is False:
        raise ValueError(
            "cannot save a leaf that is not fully addressable from this process "
            "(a ProcessShard: a block of an array spread over processes); use "
            "CheckpointManager.save with the process group up -- the coordinated "
            "path writes each process's chunks -- instead of save_tree")
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


def _chunk_of(v):
    """(host array, start, global shape) of this process's chunk of leaf
    ``v``, or None when another process writes it: a ``ProcessShard``'s
    replica 0 writes its block; process 0 writes a replicated leaf whole."""
    if getattr(v, "is_fully_addressable", True) is False:
        if v.replica != 0:
            return None
        return store_lib.as_host_leaf(v.local), list(v.start), list(v.shape)
    if mp.process_index() != 0:
        return None
    data = _host_leaf(v)
    return data, [0] * data.ndim, list(data.shape)


def _write_tree_chunks(tree_dir: str, tree) -> Dict[str, Any]:
    """One process's share of a coordinated v2 save: write the chunks this
    process owns (:func:`_chunk_of`) as ``.npy`` files and return their
    index entries."""
    os.makedirs(tree_dir, exist_ok=True)
    index: Dict[str, Any] = {}
    for k, v in _flatten(tree).items():
        got = _chunk_of(v)
        if got is None:
            continue
        data, start, shape = got
        fn = f"{quote(k, safe='')}.c0.npy"
        np.save(os.path.join(tree_dir, fn), data, allow_pickle=False)
        index[k] = {"shape": shape,
                    "chunks": [{"file": fn, "start": start, "shape": list(data.shape)}]}
    return index


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
    if getattr(like, "is_fully_addressable", True) is False:
        # a ProcessShard: this process's block of the global leaf
        if tuple(host.shape) != like.shape:
            raise ValueError(f"checkpoint leaf of shape {host.shape} is not the global "
                             f"array of shape {like.shape} a block of which lands here")
        return _put(host[like.index], like.local, device)
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
    """Atomic, content-addressed checkpoints of named trees, for one process
    or, coordinated, for several (see the module docstring).

    ``save(step, {"params": ..., "opt": ...}, meta=...)`` publishes a step
    (v3 pool objects + manifest, or v2 whole files / chunk files with
    ``dedup=False``); ``restore(like)`` lands the newest valid step onto
    torch like-trees.  With several processes both are collectives: every
    process calls them at the same point.  ``local=True`` makes
    ``directory`` this process's private root; ``peer_dirs`` are pools of
    other directories read directly.
    """

    def __init__(self, directory: str, keep_last: int = 3, *, dedup: bool = True,
                 local: bool = False, peer_dirs=()):
        global _MANAGER_COUNT
        _MANAGER_COUNT += 1
        self._scope = f"ckptmgr{_MANAGER_COUNT}"
        self.dir = directory
        self.keep_last = keep_last
        self.local = bool(local)
        self.dedup = bool(dedup) or self.local  # local mode is v3 only
        self.store = ObjectStore(directory)
        self.peer_pools = [ObjectStore(d) for d in peer_dirs]
        #: dedup accounting of this process's most recent v3 save:
        #: {bytes,objects}_{written,reused} (reused = content-addressed hits)
        self.last_save_stats: Dict[str, int] = {}
        #: the split of the most recent gather (reference's keys): manifest,
        #: needed, skipped, held, fetched, served digests; a gather over the
        #: store adds the bytes it fetched and its seconds
        self.last_gather_stats: Dict[str, Any] = {}
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._save_seq = 0  # barrier names (the same sequence on every process)
        self._kv_seq = 0  # store keys (ditto)
        self._remote_trees: Dict[str, Any] = {}  # step dir -> manifest from the store

    def _pools(self) -> List[ObjectStore]:
        return [self.store, *self.peer_pools]

    def _coordinated(self) -> bool:
        return mp.process_count() > 1

    # ---- manifest ----------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest valid checkpoint's manifest record, or None.  With local
        directories and several processes this is an election over every
        process's directory, and a collective."""
        if self.local and self._coordinated():
            return self._latest_coordinated()
        return self._latest_uncoordinated()

    def _latest_uncoordinated(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.manifest_path):
            return None
        with open(self.manifest_path) as f:
            m = json.load(f)
        if not os.path.isdir(os.path.join(self.dir, m["dir"])):
            return self._scan_fallback()  # torn manifest
        return m

    def _latest_coordinated(self) -> Optional[Dict[str, Any]]:
        """The newest checkpoint across EVERY process's local directory:
        every rank contributes its candidate and all pick the max (step,
        dir), so a rank 0 restarted on an empty disk does not make the job
        forget a checkpoint a surviving host still holds.  The winner then
        streams its step manifest to the others, who keep it for the
        restore.  Whether the objects are all still held somewhere is
        :meth:`_gather_objects`' concern."""
        pid = mp.process_index()
        self._kv_seq += 1
        tag = f"{self._scope}-latest-{self._kv_seq}"
        cands = mp.kv_json_allgather(f"{tag}-cand", self._latest_uncoordinated())
        ranked = [(c["step"], c["dir"], r) for r, c in enumerate(cands) if c is not None]
        if not ranked:
            return None
        _, d, winner = max(ranked)
        if pid == winner:
            trees = store_lib.read_step_manifest(os.path.join(self.dir, d))
            mp.kv_put_stream(f"{tag}-best", json.dumps(trees).encode())
        else:
            trees = json.loads(mp.kv_fetch_stream(f"{tag}-best"))
        mp.barrier(f"{tag}-done")
        if pid == 0:
            mp.kv_delete_stream(f"{tag}-best")
        if trees is not None:
            self._remote_trees[d] = trees
        return cands[winner]

    def step_manifest(self, m: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The content-addressed (v3) manifest of the step ``m`` (a
        :meth:`latest` result) references: ``{tree_key -> {leaf_path ->
        {shape, dtype, chunks: [{digest, ...}]}}}``, from disk, else from
        the local-dir election's broadcast; None for a step written in the
        v1/v2 layout, which carries no digests to diff."""
        trees = store_lib.read_step_manifest(os.path.join(self.dir, m["dir"]))
        if trees is None:
            trees = self._remote_trees.get(m["dir"])
        return trees

    def assemble_diff(self, trees: Dict[str, Any], key: str,
                      leaves) -> Dict[str, np.ndarray]:
        """Host arrays for exactly ``leaves`` of tree ``key`` -- the
        digest-diff restore behind live weight reload: the caller passes only
        the changed leaf paths, and no other leaf is read.  With local
        directories and several processes the gather is pruned to their
        digests (a collective); ``last_gather_stats`` records the split."""
        entries = {k: trees[key][k] for k in leaves}
        needed = {ch["digest"] for rec in entries.values() for ch in rec["chunks"]}
        if self.local and self._coordinated():
            self._gather_objects(trees, needed=needed)
        else:
            pools = self._pools()
            all_digests = sorted(set(store_lib.manifest_digests(trees)))
            have = [d for d in all_digests if any(p.has(d) for p in pools)]
            self.last_gather_stats = {
                "manifest": len(all_digests), "needed": len(needed),
                "skipped": len(all_digests) - len(needed), "held": len(have),
                "fetched": len(needed - set(have)), "served": 0}
        return store_lib.assemble_tree(entries, self._pools())

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
        One process: every leaf is on the host, in a copy of its own, before
        this returns; with ``blocking=False`` the files are written on a
        background thread (the next ``save`` or ``wait`` joins it).  Several
        processes: every process calls this at the same step, and the save
        is coordinated and blocking whatever ``blocking`` says."""
        self.wait()
        if self._coordinated():
            if self.local:
                self._save_local_coordinated(step, state, meta)
            else:
                self._save_coordinated(step, state, meta)
            return
        host_state = {key: _host_tree(tree) for key, tree in state.items()}

        def _write():
            name = f"step_{step:08d}"
            tmp = self._stage(name)
            if self.dedup:
                before = self.store.stats()
                trees = {key: self._pool_whole_tree(flat)
                         for key, flat in host_state.items()}
                store_lib.write_step_manifest(tmp, trees)
                self._set_save_stats(before)
            else:
                for key, flat in host_state.items():
                    _save_flat(os.path.join(tmp, key), flat)
            self._write_meta(tmp, meta)
            self._publish(name, tmp, step, meta)

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    @staticmethod
    def _write_meta(step_dir: str, meta: Optional[Dict]) -> None:
        with open(os.path.join(step_dir, "meta.json"), "w") as f:
            json.dump(meta or {}, f)

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

    def _pool_chunk_entries(self, tree) -> Dict[str, Any]:
        """One process's share of a coordinated v3 save: pool the chunks this
        process owns (:func:`_chunk_of`) and return the partial manifest
        entries, which the publisher merges across processes."""
        entries: Dict[str, Any] = {}
        for k, v in _flatten(tree).items():
            got = _chunk_of(v)
            if got is None:
                continue
            data, start, shape = got
            dig = store_lib.leaf_digest(data)
            self.store.put(dig, data)
            entries[k] = {"shape": shape, "dtype": store_lib.dtype_name(data.dtype),
                          "chunks": [{"digest": dig, "start": start,
                                      "shape": list(data.shape)}]}
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

    def _stage(self, name: str) -> str:
        tmp = os.path.join(self.dir, name + ".tmp")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def _save_coordinated(self, step: int, state: Dict[str, Any],
                          meta: Optional[Dict]) -> None:
        """A save of several processes into a SHARED directory: each writes
        its own chunks, all meet at a barrier, process 0 alone publishes, and
        nobody returns before the manifest names the new step."""
        pid = mp.process_index()
        self._save_seq += 1
        tag = f"{self._scope}-{self._save_seq}"
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        if pid == 0:
            self._stage(name)
        mp.barrier(f"{tag}-prep")
        if self.dedup:
            before = self.store.stats()
            index = {key: self._pool_chunk_entries(tree) for key, tree in state.items()}
            self._set_save_stats(before)
            with open(os.path.join(tmp, f"index_{pid:03d}.json"), "w") as f:
                json.dump(index, f)
        else:
            shard_dir = os.path.join(tmp, f"shard_{pid:03d}")
            os.makedirs(shard_dir, exist_ok=True)
            index = {key: _write_tree_chunks(os.path.join(shard_dir, key), tree)
                     for key, tree in state.items()}
            with open(os.path.join(shard_dir, _SHARD_INDEX), "w") as f:
                json.dump({"process": pid, "trees": index}, f)
        # every process's chunks are durable before anyone publishes; a crash
        # before this point leaves a .tmp dir and orphan objects only
        mp.barrier(f"{tag}-written")
        if pid == 0:
            if self.dedup:
                parts = []
                for fn in sorted(os.listdir(tmp)):
                    if fn.startswith("index_") and fn.endswith(".json"):
                        with open(os.path.join(tmp, fn)) as f:
                            parts.append(json.load(f))
                        os.remove(os.path.join(tmp, fn))
                store_lib.write_step_manifest(tmp, {
                    key: store_lib.merge_tree_entries([p.get(key, {}) for p in parts])
                    for key in state})
            self._write_meta(tmp, meta)
            self._publish(name, tmp, step, meta)
        mp.barrier(f"{tag}-published")

    def _save_local_coordinated(self, step: int, state: Dict[str, Any],
                                meta: Optional[Dict]) -> None:
        """A save of several processes WITHOUT a shared filesystem: chunks go
        to this process's own pool, only the partial manifests cross the
        store (a rank puts its part after its objects are durable, so the
        all-gather is the write barrier), and every process publishes the
        same merged manifest into its own directory."""
        self._kv_seq += 1
        tag = f"{self._scope}-save-{self._kv_seq}"
        name = f"step_{step:08d}"
        before = self.store.stats()
        index = {key: self._pool_chunk_entries(tree) for key, tree in state.items()}
        self._set_save_stats(before)
        parts = mp.kv_json_allgather(f"{tag}-idx", index)
        tmp = self._stage(name)
        store_lib.write_step_manifest(tmp, {
            key: store_lib.merge_tree_entries([p.get(key, {}) for p in parts])
            for key in state})
        self._write_meta(tmp, meta)
        self._publish(name, tmp, step, meta)
        # nobody returns (and, say, exits on a drain) before every process's
        # directory names the new step
        mp.barrier(f"{tag}-published")

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
        # runs inside a publish, after every process's write)
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
    def restore(self, like_state: Dict[str, Any], device=None, shardings=None, mesh=None):
        """``(state, meta)`` from the newest valid checkpoint, or ``(None,
        None)``.  Each tree of ``like_state`` lands in its like-tree's form
        (see :func:`_put`), on ``device`` when given; a ``ProcessShard``
        like-leaf receives this process's block, and only the chunks the
        blocks touch are read.  ``shardings`` (key -> spec tree, or None)
        lays the GLOBAL like-trees out on ``mesh`` (default: the mesh
        context's) first, as the reference's restore onto target shardings:
        the checkpoint holds logical arrays, so the mesh may differ from the
        one that saved.  With local directories and several processes the
        missing objects are gathered from peers first (a collective)."""
        if shardings is not None:
            from repro_torch.distributed.sharding import current_mesh

            mesh = mesh if mesh is not None else current_mesh()
            like_state = {k: mp.like_shard_tree(v, shardings.get(k), mesh)
                          if shardings.get(k) is not None else v
                          for k, v in like_state.items()}
        m = self.latest()
        if m is None:
            return None, None
        trees = self.step_manifest(m)
        needed = self._needed_digests(trees, like_state)
        if trees is not None and self.local and self._coordinated():
            self._gather_objects(trees, needed=needed)
        base = os.path.join(self.dir, m["dir"])
        out = {}
        for key, like in like_state.items():
            if trees is not None:
                flat = store_lib.assemble_tree(trees.get(key, {}), self._pools(),
                                               needed=needed)
            else:
                flat = _read_leaves(os.path.join(base, key), pools=self._pools())
            out[key] = _land_tree(flat, like, device)
        return out, m.get("meta", {})

    @staticmethod
    def _needed_digests(trees, like_state) -> Optional[set]:
        """The digests this process's restore touches, or None (all): a
        ``ProcessShard`` like-leaf reads only the chunks that intersect its
        block; every other leaf of the restored trees is read whole."""
        if trees is None:
            return None
        shards = {key: {k: v for k, v in _flatten(like).items()
                        if getattr(v, "is_fully_addressable", True) is False}
                  for key, like in like_state.items()}
        if not any(shards.values()):
            return None
        needed: set = set()
        for key in like_state:
            needed |= store_lib.needed_digests(trees.get(key, {}), shards[key])
        return needed

    def _gather_objects(self, trees: Dict[str, Any], needed: Optional[set] = None) -> None:
        """The restore protocol without a shared filesystem: fetch the
        manifest digests this process needs and lacks from whichever peer
        holds them.  Every process publishes its have list (every manifest
        digest it holds) and want list (what it needs -- ``needed`` when
        given -- and lacks); the LOWEST rank holding a wanted digest streams
        it through the store; each wanter checks the bytes against the
        digest before caching them in its own pool (so the next save
        dedups against them).  Raises, on every process together, when a
        wanted digest is held by no process, or arrives corrupt at any."""
        t0 = time.time()
        pid, n = mp.process_index(), mp.process_count()
        self._kv_seq += 1
        tag = f"{self._scope}-gather-{self._kv_seq}"
        pools = self._pools()
        all_digests = sorted(set(store_lib.manifest_digests(trees)))
        have = [d for d in all_digests if any(p.has(d) for p in pools)]
        mine = all_digests if needed is None else sorted(set(all_digests) & set(needed))
        want = sorted(set(mine) - set(have))
        lists = mp.kv_json_allgather(f"{tag}-lists", {"have": have, "want": want})
        haves = [set(lists[r]["have"]) for r in range(n)]
        wanted = sorted(set().union(*[set(lists[r]["want"]) for r in range(n)]))
        served = 0
        for d in wanted:
            owner = next((r for r in range(n) if d in haves[r]), None)
            if owner is None:
                raise FileNotFoundError(
                    f"checkpoint object {d} is referenced by the manifest but held by "
                    f"no process; the checkpoint is incomplete (a writer's local "
                    f"directory is gone?)")
            if owner == pid:
                payload = next(p.get_bytes(d) for p in pools if p.has(d))
                mp.kv_put_stream(f"{tag}-obj-{d}", payload)
                served += 1
        # the manifest knows each digest's dtype (npy stores bf16 as raw
        # 2-byte words, which hash under another name)
        dtype_of = {ch["digest"]: rec.get("dtype") for entries in trees.values()
                    for rec in entries.values() for ch in rec["chunks"]}
        error, fetched = None, 0
        for d in want:
            payload = mp.kv_fetch_stream(f"{tag}-obj-{d}")
            fetched += len(payload)
            # check BEFORE caching: a content-addressed pool that trusts the
            # transfer would make a corrupt object stick (later saves dedup
            # against it)
            got = store_lib.payload_digest(payload, dtype_of.get(d))
            if got != d:
                error = (f"checkpoint object {d} arrived corrupt from its peer "
                         f"(its bytes hash to {got}); refusing to cache it")
                break
            self.store.put_bytes(d, payload)
        # every process publishes its outcome, so a refusal raises on all of
        # them together instead of leaving the peers at a barrier
        errors = mp.kv_json_allgather(f"{tag}-status", error)
        if pid == 0:
            # every fetch is over: reclaim the payloads, the store's big entries
            for d in wanted:
                mp.kv_delete_stream(f"{tag}-obj-{d}")
        bad = [f"process {r}: {e}" for r, e in enumerate(errors) if e]
        if bad:
            raise IOError("; ".join(bad))
        self.last_gather_stats = {
            "manifest": len(all_digests), "needed": len(mine),
            "skipped": len(all_digests) - len(mine), "held": len(have),
            "fetched": len(want), "served": served, "bytes": fetched,
            "seconds": time.time() - t0}
