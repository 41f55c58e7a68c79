"""The store exchanges of ``distributed/multiprocess.py`` and the chunk
geometry of ``checkpoint/store.py``, on the CPU.

* Over 2 spawned gloo ranks on the launcher's ``TCPStore``
  (``init_distributed``), with ``REPRO_KV_CHUNK_BYTES=7`` so every stream has
  several parts: ``kv_put``/``kv_fetch``/``kv_delete``, the streams (an
  empty payload too) and their cleanup, ``kv_allgather`` and
  ``kv_json_allgather`` (rank order, keys deleted by rank 0),
  ``any_process_flag``, and ``barrier`` -- which issues no collective and
  deletes each process's key of the barrier before it.
* With one process: ``barrier`` and ``any_process_flag`` are the identity,
  the exchanges refuse to run without a store, ``batch_like`` gives meta
  tensors.
* ``chunk_intersects``, ``needed_digests`` and ``assemble_tree(needed=)``
  against the reference's on the same seeded inputs, with
  ``ProcessShard`` blocks as the shardings both read.
"""
import types

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore

from repro_torch.checkpoint import store as tstore
from repro_torch.distributed import multiprocess as M
from test_torch_model_parallel import _coordinator
from test_torch_multiprocess import _spawn
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

WORKER_KV = """
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.distributed import multiprocess as M
    init_distributed(os.environ["COORD"], N, RANK, device="cpu")
    store = M._STORE
    assert M._kv_chunk_bytes() == 7
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    dist.barrier = None  # a store barrier never calls it

    M.barrier("b1")
    M.barrier("b2")
    assert calls == []
    # this process's key of b1 went at b2; b2's stays until the next barrier
    assert not store.check([f"repro:barrier/b1/{RANK}"])
    assert store.check([f"repro:barrier/b2/{RANK}"])

    M.kv_put(f"k{RANK}", f"value of {RANK}".encode())
    assert M.kv_fetch(f"k{1 - RANK}") == f"value of {1 - RANK}".encode()
    try:
        M.kv_fetch("never-put", timeout_s=0.2)
        raise AssertionError("a fetch of a missing key returned")
    except Exception as e:
        assert "never-put" in str(e) or "timeout" in str(e).lower() or "wait" in str(e).lower(), e

    payload = bytes(range(256)) * 3 + b"tail"
    if RANK == 0:
        M.kv_put_stream("s", payload)
        M.kv_put_stream("empty", b"")
    else:
        assert M.kv_fetch_stream("s") == payload
        assert M.kv_fetch_stream("empty") == b""
    assert M.kv_fetch("s/meta") == f"n={-(-len(payload) // 7)}".encode()
    M.barrier("b3")
    if RANK == 0:
        M.kv_delete_stream("s")
        assert not store.check(["repro:s/meta"]) and not store.check(["repro:s/part0"])
        M.kv_delete(f"k{RANK}")
    M.barrier("b4")
    assert not store.check(["repro:s/part110"])

    got = M.kv_json_allgather("ag", {"rank": RANK, "xs": [RANK] * 3})
    assert got == [{"rank": r, "xs": [r] * 3} for r in range(N)], got
    raw = M.kv_allgather("ag2", bytes([RANK + 1]) * 9)
    assert raw == [bytes([r + 1]) * 9 for r in range(N)]
    M.barrier("b5")
    assert not store.check(["repro:ag-0"]) and not store.check(["repro:ag2-1"])

    n_before = len(calls)
    assert M.any_process_flag(RANK == 1) is True
    assert M.any_process_flag(False) is False
    assert len(calls) - n_before == 2  # one all-reduce each
    print("KV_OK", flush=True)
    dist.destroy_process_group()
"""


def test_store_exchanges_over_two_ranks(tmp_path):
    outs = _spawn(WORKER_KV, 2, tmp_path, COORD=_coordinator(tmp_path, "kv"),
                  REPRO_KV_CHUNK_BYTES="7")
    assert all("KV_OK" in o for o in outs), outs


def test_single_process_exchanges_and_batch_like():
    assert not torch.distributed.is_initialized()
    M.barrier("alone")  # the identity: no group, no store
    assert M.any_process_flag(True) is True and M.any_process_flag(False) is False
    with pytest.raises(RuntimeError, match="store"):
        M.kv_put("x", b"y")
    batch = {"tokens": torch.zeros(4, 16, dtype=torch.int64), "x": torch.ones(4, 3)}
    like = M.batch_like(lambda step: batch)
    assert {k: (v.device.type, tuple(v.shape), v.dtype) for k, v in like.items()} == \
        {k: ("meta", tuple(v.shape), v.dtype) for k, v in batch.items()}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1),
                                 get_coordinate=lambda: [0, 0])
    gbf = M.GlobalBatchFn(lambda step: batch, mesh)
    assert M.batch_like(gbf) is gbf.like


def _random_case(rng):
    """A global shape, a chunking of it along one axis, and a ProcessShard
    block of it (start and shape drawn at random)."""
    ndim = int(rng.integers(1, 4))
    shape = tuple(int(d) for d in rng.integers(2, 7, size=ndim))
    axis = int(rng.integers(0, ndim))
    cuts = sorted(set([0, shape[axis]] + [int(c) for c in rng.integers(1, shape[axis],
                                                                       size=2)]))
    chunks = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        start = [0] * ndim
        start[axis] = lo
        cs = list(shape)
        cs[axis] = hi - lo
        chunks.append({"digest": f"d{len(chunks)}-{lo}", "start": start, "shape": cs})
    bstart = tuple(int(rng.integers(0, d)) for d in shape)
    bshape = tuple(int(rng.integers(1, d - s + 1)) for d, s in zip(shape, bstart))
    block = M.ProcessShard(torch.zeros(bshape), shape, bstart)
    return shape, chunks, block


def test_chunk_geometry_matches_the_reference():
    rng = np.random.default_rng(0)
    hits = total = 0
    for i in range(200):
        shape, chunks, block = _random_case(rng)
        idxs = list(block.addressable_devices_indices_map(shape).values())
        for ch in chunks:
            got = tstore.chunk_intersects(ch["start"], ch["shape"], idxs, shape)
            assert got == jstore.chunk_intersects(ch["start"], ch["shape"], idxs, shape)
            hits += got
            total += 1
        entries = {"blocked": {"shape": list(shape), "chunks": chunks},
                   "whole": {"shape": list(shape), "chunks": chunks[:1]}}
        want = jstore.needed_digests(entries, {"blocked": block})
        assert tstore.needed_digests(entries, {"blocked": block}) == want, i
        assert chunks[0]["digest"] in want  # "whole" has no sharding: all needed
    assert 0 < hits < total  # some chunks hit, some miss
    # a 0-d leaf's empty index tuple always intersects
    assert tstore.chunk_intersects([], [], [()], ()) and jstore.chunk_intersects([], [], [()], ())


def test_assemble_tree_reads_only_the_needed_chunks(tmp_path):
    rng = np.random.default_rng(1)
    full = rng.standard_normal((4, 6)).astype(np.float32)
    pool = tstore.ObjectStore(str(tmp_path))
    chunks = []
    for r in range(4):
        d = tstore.leaf_digest(full[r:r + 1])
        pool.put(d, full[r:r + 1])
        chunks.append({"digest": d, "start": [r, 0], "shape": [1, 6]})
    entries = {"ef": {"shape": [4, 6], "dtype": "float32", "chunks": chunks}}
    block = M.ProcessShard(torch.zeros(1, 6), (4, 6), (2, 0))
    needed = tstore.needed_digests(entries, {"ef": block})
    assert needed == {chunks[2]["digest"]}
    jpool = jstore.ObjectStore(str(tmp_path))
    got = tstore.assemble_tree(entries, [pool], needed=needed)["ef"]
    want = jstore.assemble_tree(entries, [jpool], needed=needed)["ef"]
    assert np.array_equal(got[block.index], full[2:3])
    assert np.array_equal(got[block.index], want[block.index])
    # a needed set that misses every chunk of a leaf reads nothing of it
    empty = tstore.assemble_tree(entries, [], needed=set())["ef"]
    assert empty.shape == (4, 6) and empty.dtype == np.float32
