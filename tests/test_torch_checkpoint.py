"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU, and the
same checkpoints across the two packages.

* The port's copies of ``tests/test_checkpoint.py`` (all but the mesh
  restore) and of ``tests/test_ckpt_store.py``: atomic save and restore,
  async saves with keep-last GC, literal ``__`` in leaf names, the legacy v1
  layout, the manifest's dir never collected, torn-manifest recovery, a
  train run resumed bit for bit; digests, the pool's measured dedup, chunk
  assembly, bf16 and 0-d leaves, the V-cycle dedup drill, GC under a crash.
* Across packages: the same arrays give the same digests (f32, bf16, int32
  0-d); a tree with f32, bf16 and int32 0-d leaves saved by the reference in
  v3, v2 and v1 restores in the port bit for bit, and the port's v3 and v2
  saves restore in the reference; a pool written by one deduplicates the
  other's save; AdamW's ``count`` crosses as the reference's int32 leaf;
  leaf names are the reference's.
* The in-place AdamW's two hazards: a ``save(blocking=False)`` followed at
  once by in-place updates of every tensor still restores the values from
  before them, and leaves that share one pool object restore as tensors of
  their own.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import leaf_digest as jax_leaf_digest
from repro.checkpoint.manager import _flatten as jax_flatten
from repro.config import TrainConfig as JTrainConfig
from repro.configs.paper_models import gpt_proxy as jax_gpt_proxy
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.bridge import from_reference
from repro_torch.checkpoint import CheckpointManager, ObjectStore, leaf_digest, restore_tree
from repro_torch.checkpoint import store as store_lib
from repro_torch.checkpoint.manager import _flatten
from repro_torch.config import BlockSpec, MultiLevelConfig, TrainConfig, uniform_stages
from repro_torch.configs.paper_models import gpt_proxy
from repro_torch.core.vcycle import VCycleRunner
from repro_torch.models.api import build_model, init_train_state, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.param import tree_map
from test_torch_ssm import one_thread  # noqa: F401 (autouse)


def _zeros_like(tree):
    return tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor)
                    else type(t)(0), tree)


def _leaves(tree):
    return list(_flatten(tree).values())


def _bits(x):
    """A leaf's raw bits as numpy (bf16 through int16), for exact checks."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def make_state():
    return {"params": {"a": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4)}},
            "opt": {"count": 0}}


# ---------------------------------------------------------------------------
# the port's cases of tests/test_checkpoint.py


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = make_state()
    st["opt"]["count"] = 7
    cm.save(5, st, meta={"step": 5, "level": 1})
    out, meta = cm.restore(_zeros_like(st), device="cpu")
    assert meta["level"] == 1
    assert out["opt"]["count"] == 7 and isinstance(out["opt"]["count"], int)
    for a, b in zip(_leaves(out["params"]), _leaves(st["params"])):
        assert torch.equal(a, b)


def test_async_save_and_keep_last(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    st = make_state()
    for s in (1, 2, 3, 4):
        cm.save(s, st, meta={"step": s}, blocking=False)
    cm.wait()
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert cm.latest()["step"] == 4


def test_leaf_names_with_literal_double_underscore(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = {"params": {"w__gate": torch.arange(4.0), "w": {"gate": torch.full((4,), 7.0)}}}
    cm.save(1, st, meta={"step": 1})
    out, _ = cm.restore(_zeros_like(st))
    assert torch.equal(out["params"]["w__gate"], torch.arange(4.0))
    assert torch.equal(out["params"]["w"]["gate"], torch.full((4,), 7.0))


def test_restore_legacy_leaf_layout(tmp_path):
    """Pre-v2 checkpoints ('/' stored as '__', no leafenc marker)."""
    d = tmp_path / "step_00000001" / "params"
    os.makedirs(d)
    np.save(str(d / "a__b.npy"), np.arange(3.0))
    with open(tmp_path / "step_00000001" / "meta.json", "w") as f:
        json.dump({"step": 1}, f)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"dir": "step_00000001", "step": 1, "meta": {"step": 1}}, f)
    out, meta = CheckpointManager(str(tmp_path)).restore(
        {"params": {"a": {"b": torch.zeros(3, dtype=torch.float64)}}})
    assert meta["step"] == 1
    assert torch.equal(out["params"]["a"]["b"], torch.arange(3.0, dtype=torch.float64))


def test_gc_never_removes_manifest_dir(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=1)
    st = make_state()
    cm.save(5, st, meta={"step": 5})
    time.sleep(0.02)  # distinct publish mtimes
    cm.save(3, st, meta={"step": 3})
    m = cm.latest()
    assert m["step"] == 3
    assert os.path.isdir(os.path.join(str(tmp_path), m["dir"]))
    assert not os.path.isdir(os.path.join(str(tmp_path), "step_00000005"))
    _, meta = cm.restore(_zeros_like(st))
    assert meta["step"] == 3


def test_torn_manifest_recovery(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = make_state()
    cm.save(1, st, meta={"step": 1})
    cm.save(2, st, meta={"step": 2})
    with open(cm.manifest_path, "w") as f:
        json.dump({"dir": "step_00000099", "step": 99, "meta": {}}, f)
    assert cm.latest()["step"] == 2


def _proxy(**kw):
    return gpt_proxy(d_model=32, n_layers=2, vocab=128).replace(
        compute_dtype=torch.float32, **kw)


def _lm_batch(cfg, seed=0, batch=2, seq=16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_preemption_resume_continuity(tmp_path):
    """Kill training mid-flight; the restored run continues bit for bit."""
    cfg = _proxy()
    tc = TrainConfig(steps=6, warmup_steps=1, batch_size=2, seq_len=16)
    model = build_model(cfg)
    batch = _lm_batch(cfg)
    step = make_train_step(model, tc)
    gen = lambda: torch.Generator().manual_seed(0)
    p_ref, o_ref = init_train_state(model, tc, gen())
    for _ in range(4):
        p_ref, o_ref, _ = step(p_ref, o_ref, batch)

    cm = CheckpointManager(str(tmp_path))
    p, o = init_train_state(model, tc, gen())
    for _ in range(2):
        p, o, _ = step(p, o, batch)
    cm.save(2, {"params": p, "opt": o}, meta={"step": 2})
    like_p, like_o = init_train_state(model, tc, torch.Generator().manual_seed(9))
    restored, meta = cm.restore({"params": like_p, "opt": like_o})
    p, o = restored["params"], restored["opt"]
    assert meta["step"] == 2 and o["count"] == 2
    for _ in range(2):
        p, o, _ = step(p, o, batch)
    for a, b in zip(_leaves(p), _leaves(p_ref)):
        assert torch.equal(a, b)
    assert o["count"] == o_ref["count"] == 4


# ---------------------------------------------------------------------------
# the port's cases of tests/test_ckpt_store.py


def test_leaf_digest_separates_dtype_and_shape():
    z32 = np.zeros(4, np.float32)
    assert leaf_digest(z32) == leaf_digest(np.zeros(4, np.float32))
    assert leaf_digest(z32) == leaf_digest(torch.zeros(4))
    assert leaf_digest(z32) != leaf_digest(z32.view(np.int32))
    assert leaf_digest(z32) != leaf_digest(z32.reshape(2, 2))
    assert leaf_digest(np.float32(1.0).reshape(())) != leaf_digest(
        np.float32(2.0).reshape(()))
    # bf16 and another 2-byte type over the same bytes must not collide
    bf = torch.arange(4, dtype=torch.bfloat16)
    assert leaf_digest(bf) != leaf_digest(bf.view(torch.int16))
    assert leaf_digest(bf) != leaf_digest(bf.view(torch.float16))


def test_object_store_put_is_idempotent_and_measured(tmp_path):
    store = ObjectStore(str(tmp_path))
    arr = np.arange(32, dtype=np.float32)
    d = leaf_digest(arr)
    n = store.put(d, arr)
    assert n > 0 and store.has(d)
    assert store.put(d, arr) == 0
    s = store.stats()
    assert s["objects_written"] == 1 and s["objects_reused"] == 1
    assert s["bytes_written"] == n and s["bytes_reused"] == arr.nbytes
    np.testing.assert_array_equal(store.get(d), arr)
    assert list(store.digests()) == [d]
    store.delete(d)
    assert not store.has(d)
    store.delete(d)


def test_fetch_object_resolves_through_pool_order(tmp_path):
    own = ObjectStore(str(tmp_path / "own"))
    peer = ObjectStore(str(tmp_path / "peer"))
    arr = np.arange(6, dtype=np.int32)
    d = leaf_digest(arr)
    peer.put(d, arr)
    np.testing.assert_array_equal(store_lib.fetch_object(d, [own, peer]), arr)
    with pytest.raises(FileNotFoundError, match="not found in any pool"):
        store_lib.fetch_object("0" * 40, [own, peer])


def test_payload_digest_detects_corruption(tmp_path):
    store = ObjectStore(str(tmp_path))
    for x, dtype in ((torch.arange(16, dtype=torch.float32), "float32"),
                     (torch.arange(8, dtype=torch.bfloat16), "bfloat16")):
        d = leaf_digest(x)
        store.put(d, store_lib.as_host_leaf(x))
        payload = store.get_bytes(d)
        assert store_lib.payload_digest(payload, dtype) == d
        corrupt = bytearray(payload)
        corrupt[-1] ^= 0xFF
        assert store_lib.payload_digest(bytes(corrupt), dtype) != d


def test_merge_tree_entries_rejects_shape_disagreement():
    a = {"w": {"shape": [4], "dtype": "float32",
               "chunks": [{"digest": "x", "start": [0], "shape": [2]}]}}
    b = {"w": {"shape": [6], "dtype": "float32",
               "chunks": [{"digest": "y", "start": [2], "shape": [2]}]}}
    with pytest.raises(ValueError, match="disagrees"):
        store_lib.merge_tree_entries([a, b])
    merged = store_lib.merge_tree_entries(
        [a, {"w": {"shape": [4], "dtype": "float32",
                   "chunks": [{"digest": "y", "start": [2], "shape": [2]}]}}])
    assert [c["digest"] for c in merged["w"]["chunks"]] == ["x", "y"]


def test_assemble_tree_reassembles_chunks(tmp_path):
    store = ObjectStore(str(tmp_path))
    lo, hi = np.arange(6.0).reshape(2, 3), np.arange(6.0, 12.0).reshape(2, 3)
    dl, dh = leaf_digest(lo), leaf_digest(hi)
    store.put(dl, lo)
    store.put(dh, hi)
    entries = {"w": {"shape": [4, 3], "dtype": "float64",
                     "chunks": [{"digest": dl, "start": [0, 0], "shape": [2, 3]},
                                {"digest": dh, "start": [2, 0], "shape": [2, 3]}]}}
    out = store_lib.assemble_tree(entries, [store])
    np.testing.assert_array_equal(out["w"], np.arange(12.0).reshape(4, 3))


def test_v3_scalar_and_bfloat16_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = {"params": {"s": torch.tensor(4.0),
                     "bf": torch.arange(6).to(torch.bfloat16) * 0.5,
                     "i": torch.zeros((), dtype=torch.int32)}}
    cm.save(1, st, meta={"step": 1})
    out, _ = cm.restore(_zeros_like(st))
    assert out["params"]["bf"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["bf"], st["params"]["bf"])
    assert out["params"]["s"].shape == () and float(out["params"]["s"]) == 4.0
    assert out["params"]["i"].shape == () and out["params"]["i"].dtype == torch.int32
    rec = store_lib.read_step_manifest(os.path.join(str(tmp_path), "step_00000001"))
    assert rec["params"]["bf"]["dtype"] == "bfloat16"
    assert rec["params"]["s"]["shape"] == [] and rec["params"]["i"]["dtype"] == "int32"


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def test_vcycle_dedup_bytes_measured(tmp_path):
    """Three consecutive mid-upward-sweep checkpoints of a 3-level V-cycle
    (both full-size stashes live): after the first, the unchanged stashes
    cost no bytes, and the v3 sequence takes under half the v2 footprint."""
    from repro_torch.launch.train import make_batch_fn, make_vcycle_save_cb

    cfg = _proxy(stages=uniform_stages(4, BlockSpec("attn", "dense")))
    tc = TrainConfig(steps=8, warmup_steps=1, batch_size=2, seq_len=16, log_every=1)
    ml = MultiLevelConfig(n_levels=3, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)
    d3, d2 = str(tmp_path / "v3"), str(tmp_path / "v2")
    cm3 = CheckpointManager(d3, keep_last=100, dedup=True)
    cm2 = CheckpointManager(d2, keep_last=100, dedup=False)
    runner = VCycleRunner(cfg, ml, tc, make_batch_fn(cfg, tc, device="cpu"), device="cpu")
    cb3 = make_vcycle_save_cb(cm3, schedule=runner.plan)
    cb2 = make_vcycle_save_cb(cm2, schedule=runner.plan)
    stats = {}

    class Enough(Exception):
        pass

    def cb(state, p, o):
        if 6 <= state.global_step <= 8:
            assert state.phase == "up" and sorted(state.params_before) == [0, 1]
            cb3(state, p, o, blocking=True)
            cb2(state, p, o, blocking=True)
            stats[state.global_step] = dict(cm3.last_save_stats)
            if state.global_step == 8:
                raise Enough

    with pytest.raises(Enough):
        runner.run(ckpt_cb=cb, ckpt_every=1)
    trees = {g: store_lib.read_step_manifest(os.path.join(d3, f"step_{g:08d}"))
             for g in (6, 7, 8)}
    stash_keys = [k for k in trees[6] if k.startswith("params_before_")]
    assert len(stash_keys) == 2
    stash_bytes = 0
    for key in stash_keys:
        for leaf, rec in trees[6][key].items():
            stash_bytes += int(np.prod(rec["shape"]) or 1) * np.dtype(rec["dtype"]).itemsize
            for g in (7, 8):
                assert trees[g][key][leaf]["chunks"][0]["digest"] == \
                    rec["chunks"][0]["digest"], (key, leaf)
    for g in (7, 8):
        assert stats[g]["bytes_reused"] >= stash_bytes, stats
        assert stats[g]["bytes_written"] < 0.2 * stats[6]["bytes_written"], stats
    assert _du(d3) < 0.5 * _du(d2), (_du(d3), _du(d2))
    like = {"params": _zeros_like(runner.models[2].init(torch.Generator().manual_seed(0)))}
    out3, meta3 = cm3.restore(like)
    out2, meta2 = cm2.restore(like)
    assert meta3["global_step"] == meta2["global_step"] == 8
    for a, b in zip(_leaves(out3), _leaves(out2)):
        assert torch.equal(a, b)


def test_gc_stress_no_live_object_collected_orphans_reclaimed(tmp_path):
    frozen = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    frozen_digest = leaf_digest(frozen)

    def state_at(i: int):
        return {"params": {"frozen": torch.from_numpy(frozen.copy()),
                           "hot": torch.full((32,), float(i))}}

    cm = CheckpointManager(str(tmp_path), keep_last=2)
    like = _zeros_like(state_at(0))

    def check_live_objects_exist():
        for d in cm._step_dirs():
            trees = store_lib.read_step_manifest(os.path.join(str(tmp_path), d))
            assert trees is not None
            for dig in store_lib.manifest_digests(trees):
                assert cm.store.has(dig), (d, dig)

    orphans = set()
    last_published = 0
    for step in range(1, 11):
        if step == 4:
            # a crash between object write and publish
            before = set(cm.store.digests())
            real_publish = cm._publish
            cm._publish = lambda *a, **k: (_ for _ in ()).throw(
                RuntimeError("simulated crash"))
            with pytest.raises(RuntimeError, match="simulated crash"):
                cm.save(step, state_at(step), meta={"step": step})
            cm._publish = real_publish
            orphans = set(cm.store.digests()) - before
            assert orphans
            _, meta = cm.restore(like)
            assert meta["step"] == last_published
            continue
        cm.save(step, state_at(step), meta={"step": step}, blocking=(step % 2 == 0))
        cm.wait()
        last_published = step
        check_live_objects_exist()
        assert cm.store.has(frozen_digest)
        if step % 3 == 0:
            out, meta = cm.restore(like)
            assert meta["step"] == step
            assert torch.equal(out["params"]["hot"], torch.full((32,), float(step)))
            np.testing.assert_array_equal(out["params"]["frozen"].numpy(), frozen)
    dirs = cm._step_dirs()
    assert dirs == ["step_00000009", "step_00000010"]
    live = set()
    for d in dirs:
        live.update(store_lib.manifest_digests(
            store_lib.read_step_manifest(os.path.join(str(tmp_path), d))))
    assert set(cm.store.digests()) == live
    for dig in orphans - live:
        assert not cm.store.has(dig)
    assert not [d for d in os.listdir(str(tmp_path)) if d.endswith(".tmp")]


def test_v2_dirs_in_v3_root_stay_readable_and_unswept(tmp_path):
    st = {"params": {"w": torch.arange(4.0)}}
    CheckpointManager(str(tmp_path), keep_last=5, dedup=False).save(1, st, meta={"step": 1})
    cm_new = CheckpointManager(str(tmp_path), keep_last=5, dedup=True)
    out, meta = cm_new.restore(_zeros_like(st))
    assert meta["step"] == 1 and torch.equal(out["params"]["w"], torch.arange(4.0))
    cm_new.save(2, st, meta={"step": 2})
    out, meta = cm_new.restore(_zeros_like(st))
    assert meta["step"] == 2
    assert os.path.isdir(tmp_path / "step_00000001")
    old = restore_tree(str(tmp_path / "step_00000001" / "params"), {"w": torch.zeros(4)})
    assert torch.equal(old["w"], torch.arange(4.0))


# ---------------------------------------------------------------------------
# the in-place AdamW's hazards


def test_async_save_snapshots_before_it_returns(tmp_path):
    """Every tensor is updated in place right after ``save(blocking=False)``
    returns; the checkpoint still holds the values from before."""
    cfg = _proxy()
    tc = TrainConfig(steps=4, warmup_steps=1, batch_size=2, seq_len=16)
    model = build_model(cfg)
    params, opt = init_train_state(model, tc, torch.Generator().manual_seed(0))
    params, opt, _ = make_train_step(model, tc)(params, opt, _lm_batch(cfg))
    want = {k: v.clone() for k, v in _flatten({"params": params, "opt": opt}).items()
            if isinstance(v, torch.Tensor)}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": params, "opt": opt}, meta={"step": 1}, blocking=False)
    with torch.no_grad():
        for t in _leaves({"params": params, "opt": opt}):
            if isinstance(t, torch.Tensor):
                t.mul_(-3.0).add_(1.0)
    cm.wait()
    out, _ = cm.restore({"params": params, "opt": opt})
    got = _flatten(out)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_restored_leaves_sharing_an_object_are_separate_tensors(tmp_path):
    """``m`` and ``v`` are equal at step 0 and a stash equal to the params:
    dedup stores each content once, and every restored leaf must still be a
    tensor of its own, or an in-place update would write two leaves."""
    cfg = _proxy()
    tc = TrainConfig(steps=4)
    params, opt = init_train_state(build_model(cfg), tc, torch.Generator().manual_seed(0))
    stash = tree_map(lambda t: t.clone(), params)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": params, "opt": opt, "params_before_0": stash}, meta={"step": 1})
    like = {"params": _zeros_like(params), "opt": _zeros_like(opt),
            "params_before_0": _zeros_like(params)}
    out, _ = cm.restore(like)
    flat = {k: v for k, v in _flatten(out).items() if isinstance(v, torch.Tensor)}
    ptrs = [t.untyped_storage().data_ptr() for t in flat.values()]
    assert len(set(ptrs)) == len(ptrs)
    with torch.no_grad():
        out["opt"]["m"]["embed"]["tok"].add_(1.0)
        out["params"]["embed"]["tok"].add_(1.0)
    assert not out["opt"]["v"]["embed"]["tok"].any()
    assert torch.equal(out["params_before_0"]["embed"]["tok"], params["embed"]["tok"])


# ---------------------------------------------------------------------------
# across the two packages


def _jax_state():
    """A tree with f32, bf16 and int32 0-d leaves, on the reference side."""
    return {"params": {"w": jnp.arange(12.0, dtype=jnp.float32).reshape(3, 4) / 7.0,
                       "n": {"bf": (jnp.arange(6) * 0.37 - 1.0).astype(jnp.bfloat16),
                             "s": jnp.float32(2.5)},
                       "w__x": jnp.linspace(-1.0, 1.0, 5, dtype=jnp.float32)},
            "opt": {"count": jnp.asarray(7, jnp.int32),
                    "m": {"w": jnp.full((3, 4), 0.25, jnp.float32)}}}


def _port_like():
    return {"params": {"w": torch.zeros(3, 4), "n": {"bf": torch.zeros(6, dtype=torch.bfloat16),
                                                     "s": torch.zeros(())},
                       "w__x": torch.zeros(5)},
            "opt": {"count": 0, "m": {"w": torch.zeros(3, 4)}}}


def _port_state():
    st = _jax_state()
    conv = lambda a: (torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)
                      if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)))
    return {"params": tree_map(conv, st["params"]),
            "opt": {"count": 7, "m": tree_map(conv, st["opt"]["m"])}}


@pytest.mark.parametrize("x", [
    np.arange(12, dtype=np.float32).reshape(3, 4), np.float32(3.5).reshape(()),
    np.asarray(7, np.int32), np.arange(5, dtype=np.int64),
    np.linspace(-2, 2, 9).astype(ml_dtypes.bfloat16)],
    ids=["f32", "f32-0d", "int32-0d", "int64", "bf16"])
def test_digests_equal_across_packages(x):
    port = (torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
            if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(x)))
    assert leaf_digest(port) == jax_leaf_digest(x)
    assert leaf_digest(store_lib.as_host_leaf(port)) == jax_leaf_digest(x)
    assert leaf_digest(x) == jax_leaf_digest(x)


def _check_port_restore(out):
    want = _jax_state()
    assert out["opt"]["count"] == 7 and isinstance(out["opt"]["count"], int)
    assert out["params"]["n"]["bf"].dtype == torch.bfloat16
    assert out["params"]["n"]["s"].shape == ()
    got, ref = _flatten(out), jax_flatten(want)
    assert set(got) == set(ref)
    for k in ref:
        if k != "opt/count":
            np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)


def _to_legacy_v1(root):
    """Rewrite a v2 checkpoint into the legacy v1 layout ('/' as '__', no
    marker), as older reference versions wrote it."""
    from urllib.parse import unquote

    step = json.load(open(os.path.join(root, "manifest.json")))["dir"]
    for key in ("params", "opt"):
        d = os.path.join(root, step, key)
        os.remove(os.path.join(d, "leafenc.json"))
        for fn in os.listdir(d):
            os.rename(os.path.join(d, fn), os.path.join(d, unquote(fn[:-4]).replace("/", "__")
                                                        + ".npy"))


@pytest.mark.parametrize("layout", ["v3", "v2", "v1"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, layout):
    legacy_safe = _jax_state()
    if layout == "v1":  # the legacy scheme cannot hold a literal "__"
        del legacy_safe["params"]["w__x"]
    JaxCheckpointManager(str(tmp_path), dedup=layout == "v3").save(
        3, legacy_safe if layout == "v1" else _jax_state(), meta={"step": 3})
    if layout == "v1":
        _to_legacy_v1(str(tmp_path))
    like = _port_like()
    if layout == "v1":
        del like["params"]["w__x"]
    out, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta == {"step": 3}
    if layout == "v1":
        out["params"]["w__x"] = torch.from_numpy(np.array(_jax_state()["params"]["w__x"]))
    _check_port_restore(out)


@pytest.mark.parametrize("dedup", [True, False], ids=["v3", "v2"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dedup):
    cm = CheckpointManager(str(tmp_path), dedup=dedup)
    cm.save(3, _port_state(), meta={"step": 3})
    like = jax.tree.map(jnp.zeros_like, _jax_state())
    out, meta = JaxCheckpointManager(str(tmp_path)).restore(like)
    assert meta == {"step": 3}
    assert out["opt"]["count"].dtype == jnp.int32 and out["opt"]["count"].shape == ()
    assert out["params"]["n"]["bf"].dtype == jnp.bfloat16
    got, want = jax_flatten(out), jax_flatten(_jax_state())
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    if dedup:  # the same manifest records as the reference's own save
        JaxCheckpointManager(str(tmp_path / "ref")).save(3, _jax_state(), meta={"step": 3})
        ours = store_lib.read_step_manifest(os.path.join(str(tmp_path), "step_00000003"))
        theirs = store_lib.read_step_manifest(str(tmp_path / "ref" / "step_00000003"))
        assert ours == theirs


def test_pools_deduplicate_across_packages(tmp_path):
    """The reference saves a tree; the port saves the same values into the
    same directory and writes no object, and the reverse."""
    JaxCheckpointManager(str(tmp_path / "a")).save(1, _jax_state(), meta={"step": 1})
    cm = CheckpointManager(str(tmp_path / "a"))
    cm.save(2, _port_state(), meta={"step": 2})
    assert cm.last_save_stats["objects_written"] == 0
    assert cm.last_save_stats["objects_reused"] == len(jax_flatten(_jax_state()))
    CheckpointManager(str(tmp_path / "b")).save(1, _port_state(), meta={"step": 1})
    jm = JaxCheckpointManager(str(tmp_path / "b"))
    jm.save(2, _jax_state(), meta={"step": 2})
    assert jm.last_save_stats["objects_written"] == 0


def test_reference_coordinated_v2_shards_restore_in_the_port(tmp_path):
    """A coordinated multi-process v2 save (``shard_<pid>/`` chunk files and
    their index) reassembles into the logical leaf."""
    step = tmp_path / "step_00000004"
    w = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    for pid, rows in ((0, slice(0, 2)), (1, slice(2, 4))):
        d = step / f"shard_{pid:03d}" / "params"
        os.makedirs(d)
        np.save(str(d / "w.c0.npy"), w[rows])
        with open(step / f"shard_{pid:03d}" / "index.json", "w") as f:
            json.dump({"process": pid, "trees": {"params": {"w": {
                "shape": [4, 6], "chunks": [{"file": "w.c0.npy", "start": [2 * pid, 0],
                                             "shape": [2, 6]}]}}}}, f)
    with open(step / "meta.json", "w") as f:
        json.dump({"step": 4}, f)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"dir": "step_00000004", "step": 4, "meta": {"step": 4}}, f)
    out, _ = CheckpointManager(str(tmp_path)).restore({"params": {"w": torch.zeros(4, 6)}})
    np.testing.assert_array_equal(out["params"]["w"].numpy(), w)


def test_leaf_names_equal_the_reference():
    """One train state (parameters and AdamW state) of ``gpt_proxy``: the
    port's checkpoint leaf names and shapes are the reference's."""
    jcfg = jax_gpt_proxy(d_model=32, n_layers=2, vocab=128)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jtree = {"params": jparams, "opt": jax_adamw_init(jparams, JTrainConfig())}
    params = from_reference(jax.tree.map(np.asarray, jparams), _proxy())
    tree = {"params": params, "opt": adamw_init(params, TrainConfig())}
    want = {k: np.shape(v) for k, v in jax_flatten(jtree).items()}
    got = {k: tuple(np.shape(v)) for k, v in _flatten(tree).items()}
    assert got == want
