"""Content-addressed checkpoint object store (layout v3): the port's own copy
of ``repro/checkpoint/store.py``.

Every leaf is serialized once into a shared ``objects/`` pool keyed by a
blake2b digest of its dtype name, shape and raw bytes; a step directory is a
small JSON manifest (``objects.json``) mapping ``tree -> leaf path -> {shape,
dtype, chunks: [{digest, start, shape}]}``.  Consecutive saves rewrite only
the leaves whose content changed, and garbage collection is manifest-driven
refcounting.  The layout and the digests are the reference's byte for byte,
so a pool written by either package deduplicates against the other and a
manifest written by either verifies in the other.

bfloat16 without ``ml_dtypes``: numpy has no bf16 type here, so a host bf16
leaf is a 2-byte void array (``np.dtype("V2")``) over the same bytes.  That is
what ``np.save`` stores for the reference's ``ml_dtypes.bfloat16`` leaves
too, and :func:`dtype_name` names such arrays ``"bfloat16"`` -- in digests
and in manifests -- exactly as the reference's ``str(dtype)`` does.

Writes are atomic (a unique temp file, then ``os.replace``); objects are
written before the manifest that references them is published, so a crash
strands only unreferenced objects, which the next successful save's GC
reclaims.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

# per-step manifest file marking a v3 (content-addressed) step directory
OBJECTS_JSON = "objects.json"
V3_VERSION = 3
BF16 = "bfloat16"
_BF16_HOST = np.dtype("V2")  # the host form of a bf16 leaf (raw 2-byte words)


def dtype_name(dtype: np.dtype) -> str:
    """The dtype's name as the reference writes it (``str(dtype)``), with
    2-byte void arrays -- this package's host bf16 -- named ``bfloat16``."""
    dtype = np.dtype(dtype)
    if dtype.kind == "V" and dtype.itemsize == 2 and dtype.names is None:
        return BF16
    return str(dtype)


def np_dtype(name: Optional[str]) -> np.dtype:
    """np.dtype for a manifest dtype name (``bfloat16`` -> the 2-byte void
    host form)."""
    if name is None:
        return np.dtype(np.float32)
    if name == BF16:
        return _BF16_HOST
    return np.dtype(name)


def as_host_leaf(x) -> np.ndarray:
    """C-contiguous host array of one leaf: numpy arrays, Python scalars or
    torch tensors (copied off the device; bf16 becomes its 2-byte host
    form).  NOT ``np.ascontiguousarray``, which promotes 0-d scalars to 1-d
    and would corrupt their checkpointed shape."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_HOST)
        return t.numpy()
    arr = np.asarray(x)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def leaf_digest(arr) -> str:
    """Content digest of one host array: blake2b-20 over (dtype name,
    ``repr(shape)``, raw bytes), equal to the reference's for equal data.
    The bytes are hashed in place, not copied out first."""
    arr = as_host_leaf(arr)
    h = hashlib.blake2b(digest_size=20)
    h.update(dtype_name(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.reshape(-1).view(np.uint8))
    return h.hexdigest()


def _decode_npy(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


def _restore_dtype(arr: np.ndarray, name: Optional[str]) -> np.ndarray:
    """Undo numpy's round trip of extension dtypes: a bf16 leaf comes back
    from ``np.save`` as raw void bytes, which is already its host form here.
    Any other mismatch between the bytes and the manifest's name raises."""
    if name is None or dtype_name(arr.dtype) == name:
        return arr
    if arr.dtype.kind == "V" and np_dtype(name).itemsize == arr.dtype.itemsize:
        return arr.view(np_dtype(name))
    raise ValueError(f"checkpoint object of dtype {arr.dtype} is recorded as {name!r}")


def payload_digest(payload: bytes, dtype: Optional[str] = None) -> str:
    """Digest of a serialized pool object (``dtype`` = the manifest's dtype
    name, needed because npy stores bf16 as raw void bytes)."""
    return leaf_digest(_restore_dtype(_decode_npy(payload), dtype))


class ObjectStore:
    """One directory's content-addressed pool (``<root>/objects/<dd>/<digest>.npy``).

    Tracks ``bytes_written`` / ``objects_written`` / ``bytes_reused`` /
    ``objects_reused`` so dedup is measured, not assumed.
    """

    def __init__(self, root: str):
        self.root = root
        self.pool = os.path.join(root, "objects")
        self.bytes_written = 0
        self.objects_written = 0
        self.bytes_reused = 0
        self.objects_reused = 0

    def path(self, digest: str) -> str:
        return os.path.join(self.pool, digest[:2], digest + ".npy")

    def has(self, digest: str) -> bool:
        return os.path.exists(self.path(digest))

    def put(self, digest: str, arr: np.ndarray) -> int:
        """Write ``arr`` under ``digest`` unless already present; returns the
        bytes written (0 on a dedup hit, checked before any encoding).  The
        npy image goes straight into the file, the same bytes as
        ``np.save`` into memory."""
        if self.has(digest):
            self.objects_reused += 1
            self.bytes_reused += int(arr.nbytes)
            return 0
        return self._write(digest, lambda f: np.save(f, as_host_leaf(arr), allow_pickle=False))

    def put_bytes(self, digest: str, payload: bytes) -> int:
        if self.has(digest):
            self.objects_reused += 1
            self.bytes_reused += len(payload)
            return 0
        return self._write(digest, lambda f: f.write(payload))

    def _write(self, digest: str, fill) -> int:
        """Atomic write: a unique temp file filled by ``fill(file)``, then
        ``os.replace`` onto the object's name."""
        p = self.path(digest)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            fill(f)
            n = f.tell()
        os.replace(tmp, p)
        self.bytes_written += n
        self.objects_written += 1
        return n

    def get_bytes(self, digest: str) -> bytes:
        with open(self.path(digest), "rb") as f:
            return f.read()

    def get(self, digest: str, dtype: Optional[str] = None) -> np.ndarray:
        """The object as a fresh, writable array, read from its file."""
        return _restore_dtype(np.load(self.path(digest), allow_pickle=False), dtype)

    def delete(self, digest: str) -> None:
        try:
            os.remove(self.path(digest))
        except OSError:
            pass

    def digests(self) -> Iterator[str]:
        if not os.path.isdir(self.pool):
            return
        for sub in os.listdir(self.pool):
            d = os.path.join(self.pool, sub)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if fn.endswith(".npy"):
                    yield fn[:-4]

    def stats(self) -> Dict[str, int]:
        return {"bytes_written": self.bytes_written,
                "objects_written": self.objects_written,
                "bytes_reused": self.bytes_reused,
                "objects_reused": self.objects_reused}


# ---------------------------------------------------------------------------
# v3 step manifests


def whole_leaf_entry(digest: str, arr: np.ndarray) -> Dict[str, Any]:
    """Manifest record for an unsharded leaf: one chunk covering everything."""
    return {"shape": list(arr.shape), "dtype": dtype_name(arr.dtype),
            "chunks": [{"digest": digest, "start": [0] * arr.ndim,
                        "shape": list(arr.shape)}]}


def merge_tree_entries(parts: Iterable[Dict[str, Dict[str, Any]]]
                       ) -> Dict[str, Dict[str, Any]]:
    """Merge partial manifests of ONE tree: chunk lists concatenate, global
    shape/dtype must agree."""
    out: Dict[str, Dict[str, Any]] = {}
    for part in parts:
        for leaf, rec in part.items():
            got = out.get(leaf)
            if got is None:
                out[leaf] = {"shape": rec["shape"], "dtype": rec["dtype"],
                             "chunks": list(rec["chunks"])}
            else:
                if got["shape"] != rec["shape"] or got["dtype"] != rec["dtype"]:
                    raise ValueError(
                        f"coordinated save disagrees on leaf {leaf!r}: "
                        f"{got['shape']}/{got['dtype']} vs "
                        f"{rec['shape']}/{rec['dtype']}")
                got["chunks"].extend(rec["chunks"])
    return out


def write_step_manifest(step_dir: str, trees: Dict[str, Dict[str, Any]]) -> None:
    with open(os.path.join(step_dir, OBJECTS_JSON), "w") as f:
        json.dump({"version": V3_VERSION, "trees": trees}, f)


def read_step_manifest(step_dir: str) -> Optional[Dict[str, Dict[str, Any]]]:
    """The ``trees`` map of a v3 step dir, or None for v1/v2 layouts."""
    p = os.path.join(step_dir, OBJECTS_JSON)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["trees"]


def manifest_digests(trees: Dict[str, Dict[str, Any]]) -> Iterator[str]:
    for entries in trees.values():
        for rec in entries.values():
            for ch in rec["chunks"]:
                yield ch["digest"]


def chunk_intersects(start, shape, indices, global_shape) -> bool:
    """True when the chunk ``[start, start + shape)`` overlaps ANY of the
    index tuples in ``indices`` (tuples of slices into ``global_shape``): a
    process needs only the chunks whose bytes land in a slice it holds.  A
    0-d leaf's empty index tuple always intersects."""
    for idx in indices:
        hit = True
        for sl, st, sz, dim in zip(idx, start, shape, global_shape):
            lo, hi, _ = sl.indices(dim)
            if hi <= st or lo >= st + sz:
                hit = False
                break
        if hit:
            return True
    return False


def needed_digests(entries: Dict[str, Dict[str, Any]], leaf_shardings: Dict[str, Any]) -> set:
    """The digests of the chunks this process's slices touch.
    ``leaf_shardings`` maps a leaf path to anything with the reference's
    ``addressable_devices_indices_map(shape)`` (the port's
    ``distributed.ProcessShard``); a leaf without one, or whose map fails,
    needs every chunk."""
    need: set = set()
    for leaf, rec in entries.items():
        sh = leaf_shardings.get(leaf)
        if sh is None:
            need.update(ch["digest"] for ch in rec["chunks"])
            continue
        shape = tuple(rec["shape"])
        try:
            idxs = list(sh.addressable_devices_indices_map(shape).values())
        except Exception:
            need.update(ch["digest"] for ch in rec["chunks"])
            continue
        for ch in rec["chunks"]:
            if chunk_intersects(ch["start"], ch["shape"], idxs, shape):
                need.add(ch["digest"])
    return need


def fetch_object(digest: str, pools: List[ObjectStore],
                 dtype: Optional[str] = None) -> np.ndarray:
    """Resolve ``digest`` through an ordered pool list."""
    for pool in pools:
        if pool.has(digest):
            return pool.get(digest, dtype)
    raise FileNotFoundError(
        f"checkpoint object {digest} not found in any pool "
        f"({[p.pool for p in pools]}); the object pool and the step manifest "
        "referencing it have diverged")


def assemble_tree(entries: Dict[str, Dict[str, Any]], pools: List[ObjectStore],
                  needed: Optional[set] = None) -> Dict[str, np.ndarray]:
    """Logical host arrays of one tree from its manifest entries and pools
    (the inverse of chunking, whatever process count wrote the chunks).
    Every leaf is a fresh array of its own, also where two leaves share one
    pool object.  With ``needed`` (from :func:`needed_digests`) chunks
    outside the set are never read and their regions stay uninitialized:
    the caller lands only the slices the set was computed from."""
    flat: Dict[str, np.ndarray] = {}
    for leaf, rec in entries.items():
        chunks = rec["chunks"]
        if needed is not None:
            chunks = [ch for ch in chunks if ch["digest"] in needed]
        if not chunks:  # no slice of this leaf is held here
            flat[leaf] = np.empty(tuple(rec["shape"]), dtype=np_dtype(rec.get("dtype")))
            continue
        first = fetch_object(chunks[0]["digest"], pools, rec.get("dtype"))
        if len(chunks) == 1 and list(first.shape) == list(rec["shape"]):
            flat[leaf] = first
            continue
        out = np.empty(tuple(rec["shape"]), dtype=first.dtype)
        for ch in chunks:
            data = fetch_object(ch["digest"], pools, rec.get("dtype"))
            sl = tuple(slice(st, st + sz)
                       for st, sz in zip(ch["start"], ch["shape"]))
            out[sl] = data
        flat[leaf] = out
    return flat
