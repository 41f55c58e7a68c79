"""Coordinated checkpoints across spawned gloo processes on the CPU: the
port's counterparts of ``tests/test_multiprocess.py`` and
``tests/test_ckpt_localdir.py``, held against the port's own 1-process runs
(the reference's multi-process tests fail under jax 0.9.0).

The problem is ``test_torch_multiprocess.py``'s (``helpers.mp_arena``: tiny
dense, f32, batch 4, 12 steps, the V-cycle 3 + 6 + 12 steps), on a
``--mesh 2x1``; three spawns of two ranks, each under its own timeout:

* saves: a V-cycle killed after the save at global step 6 (the upward sweep,
  the stash live) into a shared v3 dir, a shared v2 dir (``meta.json`` for
  the scan fallback, ``shard_<pid>/`` chunks) and a local dir per rank,
  dense and int8_ef.  The int8_ef rows restore on two processes bit for bit
  from both layouts and the resumed run equals the uninterrupted one; one
  process refuses them.  One process restores the dense trees bit-equal
  from all three layouts and the reference's ``CheckpointManager`` reads
  the v3 dir bit for bit; ``peer_dirs`` supply rank 1's rows; the 2 -> 1
  resume lands within ``GAP`` of the uninterrupted 1-process run.  A drain
  flag raised on rank 1 stops both ranks after the same step, with the
  same all-reduces per step as a run without it.
* resumes: a 1-process save resumes on two processes from a shared dir and
  from local dirs where rank 1 starts empty and gathers over the store
  (both within ``GAP``, and bit-equal to each other); ``latest`` elects
  rank 1's dir when rank 0's is fresh; a corrupt transfer is refused before
  it is cached; a digest no rank holds raises on every rank.
* the launcher: ``--mesh 2x1 --ckpt-dir`` with SIGTERM on rank 1 alone in
  the upward sweep: both ranks checkpoint at one global step and exit 0;
  one process resumes the directory to the end.
"""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from helpers import mp_arena
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.config import TrainConfig as JTC
from repro.core import vcycle as jvc
from repro.launch.train import restore_vcycle_state as jax_restore_vcycle_state

import repro_torch.launch.train as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import save_tree
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.core.vcycle import VCycleRunner
from repro_torch.distributed import ProcessShard
from repro_torch.launch.mesh import make_cli_mesh
from repro_torch.param import flatten, unflatten
from test_torch_distributed import MLKW, _port_cfg
from test_torch_launch import _cli, _env, _main, _manifest
from test_torch_model_parallel import _coordinator
from test_torch_multiprocess import _spawn
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

TC = dict(steps=12, warmup_steps=1, peak_lr=3e-4, batch_size=4, seq_len=16, log_every=2)
# the largest loss and parameter gaps allowed between a resume across process
# counts and the uninterrupted 1-process run: test_torch_multiprocess.py's
# bound for a whole 2-process dense run, whose measured gaps (4.77e-7 and
# 2.76e-6) bound a run that is 2-process for only part of its steps
GAP = 1e-5

ARENA = """
    import dataclasses, json
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.store import ObjectStore
    from repro_torch.config import (BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig,
                                    uniform_stages)
    from repro_torch.core.vcycle import VCycleRunner
    from repro_torch.distributed import multiprocess as M
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.models.api import zero_train_state
    from repro_torch.param import flatten
    init_distributed(os.environ["COORD"], N, RANK, device="cpu")
    mesh = make_cli_mesh(f"{N}x1", num_processes=N, device="cpu")
    cfg = ModelConfig(name="t-dense", family="dense", d_model=32, n_heads=4, n_kv_heads=2,
                      d_ff=64, vocab_size=128,
                      stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                      remat="none", attn_impl="plain", compute_dtype=torch.float32)
    tc = TrainConfig(**json.loads(os.environ["TC"]))
    ml = MultiLevelConfig(**json.loads(os.environ["ML"]))

    def runner_for(comp, **kw):
        t = dataclasses.replace(tc, grad_compression=comp)
        bf = T.make_driver_batch_fn(cfg, t, mesh, device="cpu")
        return VCycleRunner(cfg, ml, t, bf, seed=0, device="cpu", mesh=mesh, **kw), t

    class Preempted(RuntimeError):
        pass

    def kill_at(step, cbs):
        def cb(state, p, o):
            for c in cbs:
                c(state, p, o)
            if state.global_step == step:
                raise Preempted
        return cb

    def flat(tree):
        return {k: v.detach().clone() for k, v in flatten(tree).items()}

    def same(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
"""

WORKER_SAVES = ARENA + """
    rec = {}
    for comp in ("dense", "int8_ef"):
        runner, t = runner_for(comp)
        mgrs = [CheckpointManager(f"{OUT}/{comp}-shared"),
                CheckpointManager(f"{OUT}/{comp}-local{RANK}", local=True)]
        if comp == "dense":
            mgrs.append(CheckpointManager(f"{OUT}/dense-v2", dedup=False))
        cbs = [T.make_vcycle_save_cb(m, schedule=runner.plan, runner=runner) for m in mgrs]
        try:
            runner.run(ckpt_cb=kill_at(6, cbs), ckpt_every=2)
            raise AssertionError("the run was not killed")
        except Preempted:
            pass
    # int8_ef: this rank's row as saved, then restored on two processes from
    # both layouts, and the resumed run against the uninterrupted one
    saved = flat(runner.state.ef)
    torch.save(saved, f"{OUT}/ef-saved{RANK}.pt")
    for path, local in ((f"{OUT}/int8_ef-shared", False), (f"{OUT}/int8_ef-local{RANK}", True)):
        resumed, t = runner_for("int8_ef")
        st, p, o = T.restore_vcycle_state(CheckpointManager(path, local=local), resumed, t)
        assert (st.phase, st.level, st.global_step) == ("up", 1, 6), st
        assert same(flat(st.ef), saved), path
    out = resumed.run(state=st, params=p, opt_state=o)
    full = runner_for("int8_ef")[0].run()
    rec["ef_resume_equal"] = (same(flat(out.params), flat(full.params))
                              and out.history.to_dict() == full.history.to_dict())
    # the drain flag: raised on rank 1 after global step 3, seen by both after
    # step 4, with the all-reduces a step of a run without it
    real = dist.all_reduce
    calls = []
    dist.all_reduce = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    per_step = {}

    def counting(tag, guard=None):
        def on_step(st, p, o, stopping, dt):
            per_step.setdefault(tag, []).append(len(calls))
            if guard is None:
                if st.global_step == 5:
                    raise Preempted
                return
            if RANK == 1 and st.global_step == 3:
                guard.triggered = True
            if guard.should_stop() and not stopping:
                rec["drain_at"] = st.global_step
                raise Preempted
        return on_step

    for tag in ("plain", "fused"):
        guard = T.PreemptionGuard() if tag == "fused" else None
        kw = {"drain_flag": guard.attach(M.FusedDrainFlag())} if guard else {}
        calls.clear()
        try:
            runner_for("dense", **kw)[0].run(on_step=counting(tag, guard))
        except Preempted:
            pass
    dist.all_reduce = real
    rec["per_step"] = per_step
    # train_plain: an int8_ef run killed after its cadence save (the save
    # after step index 3, named 3, its meta step 4), resumed, against the
    # uninterrupted run
    t = dataclasses.replace(tc, steps=6, grad_compression="int8_ef")

    class Killing(CheckpointManager):
        def save(self, step, state, meta=None, blocking=True):
            super().save(step, state, meta, blocking)
            if step == 3:
                raise Preempted

    full = T.train_plain(cfg, t, ckpt=None, ckpt_every=0, verbose=False, device="cpu",
                         mesh=mesh)
    try:
        T.train_plain(cfg, t, ckpt=Killing(f"{OUT}/plain"), ckpt_every=3, verbose=False,
                      device="cpu", mesh=mesh)
        raise AssertionError("the plain run was not killed")
    except Preempted:
        pass
    rec["plain_meta"] = CheckpointManager(f"{OUT}/plain").latest()["meta"]
    out = T.train_plain(cfg, t, ckpt=CheckpointManager(f"{OUT}/plain"), ckpt_every=3,
                        verbose=False, device="cpu", mesh=mesh)
    rec["plain_resume_equal"] = same(flat(out), flat(full))
    with open(f"{OUT}/saves{RANK}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
"""

WORKER_RESUMES = ARENA + """
    rec = {}
    # 1 -> 2 from the shared dir
    r, t = runner_for("dense")
    st, p, o = T.restore_vcycle_state(CheckpointManager(f"{OUT}/one-shared"), r, t)
    assert (st.phase, st.level, st.global_step) == ("up", 1, 6), st
    restored = flat(p)
    out = r.run(state=st, params=p, opt_state=o)
    shared = flat(out.params)
    # 1 -> 2 from local dirs: rank 1 starts empty and gathers over the store;
    # the resumed run saves every 4 steps into both dirs
    cm = CheckpointManager(f"{OUT}/one-l0" if RANK == 0 else f"{OUT}/fresh1", local=True)
    r, t = runner_for("dense")
    st, p, o = T.restore_vcycle_state(cm, r, t)
    rec["gather"] = dict(cm.last_gather_stats)
    assert same(flat(p), restored) and st.global_step == 6
    out = r.run(state=st, params=p, opt_state=o, ckpt_every=4,
                ckpt_cb=T.make_vcycle_save_cb(cm, schedule=r.plan, runner=r))
    rec["local_equals_shared"] = same(flat(out.params), shared)
    rec["latest_after"] = cm.latest()["step"]
    whole = flat(M.gather_global_tree(out.params, r.level_shardings(0)[0], mesh))
    if RANK == 0:
        torch.save({"params": whole, "loss": out.history.loss}, f"{OUT}/resumed.pt")
    # latest survives a fresh rank-0 dir: rank 1's is elected, rank 0 gathers
    cm = CheckpointManager(f"{OUT}/fresh0" if RANK == 0 else f"{OUT}/one-r1", local=True)
    assert cm.latest()["step"] == 6
    r, t = runner_for("dense")
    st, p, o = T.restore_vcycle_state(cm, r, t)
    rec["fresh_rank0"] = same(flat(p), restored)
    rec["fresh_rank0_gather"] = dict(cm.last_gather_stats)
    like = {"params": zero_train_state(r.models[1], t, device="cpu")[0]}
    # a corrupt transfer: rank 0 serves flipped bytes, rank 1 refuses them,
    # and both raise together
    cm = CheckpointManager(f"{OUT}/one-c0" if RANK == 0 else f"{OUT}/fresh-c1", local=True)
    real_get = ObjectStore.get_bytes

    def corrupt(self, d):
        b = real_get(self, d)
        return b[:-1] + bytes([b[-1] ^ 1])

    if RANK == 0:
        ObjectStore.get_bytes = corrupt
    try:
        cm.restore(like)
        raise AssertionError("a corrupt object was accepted")
    except IOError as e:
        rec["corrupt"] = str(e)
    finally:
        ObjectStore.get_bytes = real_get
    rec["cached_after_corrupt"] = len(list(cm.store.digests()))
    # a digest no rank holds
    cm = CheckpointManager(f"{OUT}/one-m0" if RANK == 0 else f"{OUT}/fresh-m1", local=True)
    try:
        cm.restore(like)
        raise AssertionError("a missing object went unnoticed")
    except FileNotFoundError as e:
        rec["missing"] = str(e)
    with open(f"{OUT}/resumes{RANK}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
"""


def _env_arena():
    return {"TC": json.dumps(TC), "ML": json.dumps(MLKW)}


def _arena(comp="none"):
    cfg, tc = _port_cfg(), TrainConfig(**TC, grad_compression=comp)
    return cfg, MultiLevelConfig(**MLKW), tc, T.make_batch_fn(cfg, tc, 0, device="cpu")


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's 1-process run of the arena, the runs across process
    counts' yardstick."""
    cfg, ml, tc, bf = _arena()
    return VCycleRunner(cfg, ml, tc, bf, seed=0, device="cpu").run()


def _gaps(params, loss, ref):
    want = flatten(ref.params)
    assert params.keys() == want.keys()
    return (float(np.abs(np.asarray(loss) - np.asarray(ref.history.loss)).max()),
            max((params[k] - v).abs().max().item() for k, v in want.items()))


# ---------------------------------------------------------------------------
# 2-process saves


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    out = tmp_path_factory.mktemp("saves")
    _spawn(WORKER_SAVES, 2, out, COORD=_coordinator(out, "saves"), **_env_arena())
    recs = []
    for r in range(2):
        with open(out / f"saves{r}.json") as f:
            recs.append(json.load(f))
    return out, recs


def _restore_one(ckpt):
    cfg, ml, tc, bf = _arena()
    runner = VCycleRunner(cfg, ml, tc, bf, seed=0, device="cpu")
    return runner, T.restore_vcycle_state(ckpt, runner, tc)


def _trees(restored):
    st, p, o = restored
    return {"params": flatten(p), "m": flatten(o["m"]), "v": flatten(o["v"]),
            "stash": flatten(st.params_before[0])}, o["count"]


def test_two_process_save_layouts_restore_alike_on_one_process(saves):
    out, _ = saves
    m = _manifest(str(out / "dense-shared"))
    assert (m["step"], m["meta"]["phase"], m["meta"]["stashed_levels"]) == (6, "up", [0])
    step = out / "dense-shared" / "step_00000006"
    assert sorted(os.listdir(step)) == ["meta.json", "objects.json"]  # partial indexes merged
    v2 = out / "dense-v2" / "step_00000006"
    assert (v2 / "meta.json").exists()
    assert sorted(d for d in os.listdir(v2) if d.startswith("shard_")) == ["shard_000",
                                                                           "shard_001"]
    for r in range(2):  # every rank's local dir publishes the merged manifest
        assert _manifest(str(out / f"dense-local{r}"))["step"] == 6
    base = _trees(_restore_one(CheckpointManager(str(out / "dense-shared")))[1])
    for ck in (CheckpointManager(str(out / "dense-v2")),
               CheckpointManager(str(out / "dense-local0"), local=True,
                                 peer_dirs=[str(out / "dense-local1")])):
        got = _trees(_restore_one(ck)[1])
        assert got[1] == base[1]
        for tree in base[0]:
            for k, v in base[0][tree].items():
                assert torch.equal(got[0][tree][k], v), (ck.dir, tree, k)
    # a torn manifest falls back to the newest step dir and its meta.json
    with open(out / "dense-v2" / "manifest.json", "w") as f:
        json.dump({"dir": "step_00000099", "step": 99, "meta": {}}, f)
    m = CheckpointManager(str(out / "dense-v2")).latest()
    assert (m["step"], m["meta"]["phase"]) == (6, "up")


def test_watcher_reads_the_fsdp_local_dirs_with_their_peer_dir(saves):
    """The serving side of the same checkpoint: each rank's local dir holds
    its FSDP blocks, so a watcher on rank 0's dir alone refuses, naming
    the peer dirs, and with rank 1's dir as ``peer_dirs`` lands the shared
    dir's parameters bit for bit."""
    from repro_torch.launch.serve import ManifestWatcher

    out, _ = saves
    want = _trees(_restore_one(CheckpointManager(str(out / "dense-shared")))[1])[0]["params"]
    like = unflatten({k: torch.zeros_like(v) for k, v in want.items()})
    alone = ManifestWatcher(CheckpointManager(str(out / "dense-local0"), local=True), like=like)
    with pytest.raises(FileNotFoundError, match="peer_dirs"):
        alone.poll()
    w = ManifestWatcher(CheckpointManager(str(out / "dense-local0"), local=True,
                                          peer_dirs=[str(out / "dense-local1")]), like=like)
    step, got = w.poll()
    got = flatten(got)
    assert step == 6 and got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_two_process_save_resumes_on_one_process(saves, uninterrupted):
    out, _ = saves
    runner, (st, p, o) = _restore_one(CheckpointManager(str(out / "dense-shared")))
    assert (st.phase, st.level, st.global_step, st.seg_step) == ("up", 1, 6, 3)
    res = runner.run(state=st, params=p, opt_state=o)
    assert res.history.step == uninterrupted.history.step
    loss_gap, param_gap = _gaps(flatten(res.params), res.history.loss, uninterrupted)
    print(f"[2 -> 1] loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
    assert loss_gap <= GAP and param_gap <= GAP


def test_reference_reads_the_coordinated_v3_dir_bit_for_bit(saves):
    out, _ = saves
    want, count = _trees(_restore_one(CheckpointManager(str(out / "dense-shared")))[1])
    jcfg, _, _ = mp_arena()
    jtc = JTC(**TC)
    jrunner = jvc.VCycleRunner(jcfg, jvc.MultiLevelConfig(**MLKW), jtc, lambda g: None, seed=0)
    jst, jp, jo = jax_restore_vcycle_state(JaxCheckpointManager(str(out / "dense-shared")),
                                           jrunner, jtc)
    assert (jst.phase, jst.global_step) == ("up", 6)
    got = {"params": flatten(jax.tree.map(np.asarray, jp)),
           "m": flatten(jax.tree.map(np.asarray, jo["m"])),
           "v": flatten(jax.tree.map(np.asarray, jo["v"])),
           "stash": flatten(jax.tree.map(np.asarray, jst.params_before[0]))}
    assert int(jo["count"]) == count
    for tree in want:
        assert got[tree].keys() == want[tree].keys()
        for k, v in want[tree].items():
            assert np.array_equal(got[tree][k], v.numpy()), (tree, k)


def test_ef_rows_round_trip_and_refuse_another_mesh(saves):
    out, recs = saves
    assert all(r["ef_resume_equal"] for r in recs)
    rows = [torch.load(out / f"ef-saved{r}.pt") for r in range(2)]
    meta = _manifest(str(out / "int8_ef-shared"))["meta"]
    assert meta["has_ef"] and meta["ef_rows"] == 2
    like = {k: torch.zeros((2,) + tuple(v.shape[1:])) for k, v in rows[0].items()}
    shared, _ = CheckpointManager(str(out / "int8_ef-shared")).restore({"ef": like})
    # each rank pooled its own row in its own dir: rank 1's comes from peer_dirs
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(out / "int8_ef-local0"), local=True).restore({"ef": like})
    local, _ = CheckpointManager(str(out / "int8_ef-local0"), local=True,
                                 peer_dirs=[str(out / "int8_ef-local1")]).restore({"ef": like})
    for k in like:
        for r in range(2):
            assert torch.equal(shared["ef"][k][r:r + 1], rows[r][k]), (k, r)
        assert torch.equal(local["ef"][k], shared["ef"][k]), k
    # one process cannot take two rows: refused without a stateful reduction,
    # and on a 1x1 mesh, whose slow axis has one rank
    cfg, ml, tc, bf = _arena("int8_ef")
    with pytest.raises(ValueError, match="same mesh shape"):
        T.restore_vcycle_state(CheckpointManager(str(out / "int8_ef-shared")),
                               VCycleRunner(cfg, ml, tc, bf, device="cpu"), tc)
    mesh = make_cli_mesh("1x1", num_processes=1, device="cpu")
    try:
        with pytest.raises(ValueError, match="2 rows"):
            T.restore_vcycle_state(CheckpointManager(str(out / "int8_ef-shared")),
                                   VCycleRunner(cfg, ml, tc, bf, device="cpu", mesh=mesh), tc)
    finally:
        torch.distributed.destroy_process_group()


def test_train_plain_resumes_its_ef_rows_on_two_processes(saves):
    out, recs = saves
    # the cadence save after step index 3 (meta step 4 of 6), with two EF rows
    assert [r["plain_meta"] for r in recs] == [{"step": 4, "has_ef": True, "ef_rows": 2}] * 2
    assert all(r["plain_resume_equal"] for r in recs)
    assert _manifest(str(out / "plain"))["meta"]["step"] == 6


def test_one_process_refuses_to_save_a_process_shard(tmp_path):
    shard = ProcessShard(torch.zeros(1, 3), (2, 3), (1, 0))
    with pytest.raises(ValueError, match="not fully addressable"):
        save_tree(str(tmp_path / "t"), {"ef": shard})
    cm = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="not fully addressable"):
        cm.save(1, {"ef": {"w": shard}})
    assert cm.latest() is None


def test_drain_flag_stops_both_ranks_at_one_step_with_no_extra_collective(saves):
    _, recs = saves
    assert [r["drain_at"] for r in recs] == [4, 4]
    for r in recs:
        plain, fused = r["per_step"]["plain"], r["per_step"]["fused"]
        # all-reduces before each of the first steps: the gradient buffer and
        # the metrics vector, with the flag inside the latter
        assert fused == plain[:len(fused)] == [2 * (i + 1) for i in range(len(fused))], r


# ---------------------------------------------------------------------------
# 1-process saves resumed on two processes


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    out = tmp_path_factory.mktemp("resumes")
    cfg, ml, tc, bf = _arena()
    runner = VCycleRunner(cfg, ml, tc, bf, seed=0, device="cpu")
    one = CheckpointManager(str(out / "one-shared"))
    save_cb = T.make_vcycle_save_cb(one, schedule=runner.plan)

    def kill_cb(state, p, o):
        save_cb(state, p, o, blocking=True)
        if state.global_step == 6:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        runner.run(ckpt_cb=kill_cb, ckpt_every=2)
    for name in ("one-l0", "one-r1", "one-c0", "one-m0"):
        shutil.copytree(out / "one-shared", out / name)
    victim = next(CheckpointManager(str(out / "one-m0")).store.digests())
    CheckpointManager(str(out / "one-m0")).store.delete(victim)
    _spawn(WORKER_RESUMES, 2, out, COORD=_coordinator(out, "resumes"), **_env_arena())
    recs = []
    for r in range(2):
        with open(out / f"resumes{r}.json") as f:
            recs.append(json.load(f))
    return out, recs, victim


def test_one_process_save_resumes_on_two_processes(resumes, uninterrupted):
    out, recs, _ = resumes
    got = torch.load(out / "resumed.pt")
    loss_gap, param_gap = _gaps(got["params"], got["loss"], uninterrupted)
    print(f"[1 -> 2] loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
    assert loss_gap <= GAP and param_gap <= GAP
    assert all(r["local_equals_shared"] for r in recs)
    # rank 1 fetched every object of the manifest, rank 0 served them
    g0, g1 = recs[0]["gather"], recs[1]["gather"]
    assert g1["held"] == 0 and g1["fetched"] == g1["manifest"] == g0["served"] > 0
    assert g0["fetched"] == 0 and g0["held"] == g0["manifest"]
    # the resumed run's local saves landed in both dirs
    assert [r["latest_after"] for r in recs] == [20, 20]
    for d in ("one-l0", "fresh1"):
        assert _manifest(str(out / d))["step"] == 20


def test_latest_survives_a_fresh_rank0_dir(resumes):
    _, recs, _ = resumes
    assert all(r["fresh_rank0"] for r in recs)
    g0, g1 = recs[0]["fresh_rank0_gather"], recs[1]["fresh_rank0_gather"]
    assert g0["held"] == 0 and g0["fetched"] == g1["served"] == g0["manifest"]


def test_gather_refuses_corrupt_and_missing_objects(resumes):
    _, recs, victim = resumes
    for r in recs:
        assert "process 1:" in r["corrupt"] and "arrived corrupt" in r["corrupt"]
    assert recs[1]["cached_after_corrupt"] == 0
    for r in recs:
        assert victim in r["missing"] and "held by no process" in r["missing"]


# ---------------------------------------------------------------------------
# the launcher


def test_sigterm_on_one_rank_drains_both_and_resumes_on_one(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    # 60 steps: 2 + 30 + 60, so the upward sweep lasts 30 steps
    args = ["--arch", "gpt-proxy", "--vcycle", "--steps", "60", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "1000"]
    coord = _coordinator(tmp_path, "launcher")
    logs = [str(tmp_path / f"rank{r}.log") for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as lf:
                procs.append(subprocess.Popen(
                    _cli(args + ["--mesh", "2x1", "--num-processes", "2", "--process-id",
                                 str(r), "--coordinator", coord]),
                    env=_env(), cwd=os.path.join(os.path.dirname(__file__), ".."),
                    stdout=lf, stderr=subprocess.STDOUT))
        deadline = time.time() + 120
        up = False
        while time.time() < deadline and procs[0].poll() is None and not up:
            with open(logs[0]) as f:
                up = "coalescing" in f.read()  # rank 0 starts the upward sweep
            time.sleep(0.01)
        assert up, open(logs[0]).read()[-2000:]
        procs[1].send_signal(signal.SIGTERM)  # rank 1 alone
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(lg).read() for lg in logs]
    assert codes == [0, 0], outs
    steps = []
    for out in outs:
        line = [ln for ln in out.splitlines() if "[preempt] SIGTERM: blocking" in ln]
        assert len(line) == 1, out[-2000:]
        steps.append(int(line[0].split("global_step ")[1].split(";")[0]))
    assert "caught signal" in outs[1] and "caught signal" not in outs[0]
    meta = _manifest(ck)["meta"]
    assert steps[0] == steps[1] == meta["global_step"] and meta["phase"] == "up", (steps, meta)
    restart = _main(args, capsys)
    assert f"global_step={steps[0]}" in restart, restart[-1500:]
    done = _manifest(ck)["meta"]
    assert done["phase"] == "done" and done["global_step"] == 92
