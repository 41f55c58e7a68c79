"""Live weight reload in the port's paged server, on the CPU: the paged, GQA
cases of ``tests/test_reload.py`` and the hand-off across the packages.

* Engine side (``EngineCore.request_reload`` / ``maybe_swap``): a staged swap
  waits for a drained tick boundary; in-flight requests finish token for
  token under the weights they started on, admissions after the swap stream
  what a fresh server on the new weights streams, admission is gated while
  a swap is staged, and nothing is dropped.  ``set_params`` calls the
  policy's ``on_params`` hook.
* Watcher side (``ManifestWatcher``): steps land by per-leaf digest diff --
  unchanged leaves keep their landed tensors (object identity) and read no
  byte; coalesced mid-V-cycle shapes are skipped and remembered; a v2
  layout fails loudly; a step whose objects vanish under the trainer's GC
  counts a poll error and the next publish lands.
* Across packages: a checkpoint the reference writes lands in the port's
  server, whose streams then equal the reference server's on the same
  weights, token for token (f32).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.config import MultiLevelConfig
from repro_torch.configs import get_config
from repro_torch.core import operators as ops
from repro_torch.launch.serve import GreedyPolicy, ManifestWatcher, Request, make_server
from repro_torch.models.api import build_model
from repro_torch.param import tree_map
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

KW = dict(engine="paged", batch=2, max_seq=48, page_size=8, device="cpu")


def _cfg():
    return get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=torch.float32)


def _init(cfg, seed):
    return build_model(cfg).init(torch.Generator().manual_seed(seed))


def _reqs(cfg, rids, seed, max_new=4):
    rng = np.random.default_rng(seed)
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(5, 12))),
                    max_new=max_new) for r in rids]


def _stream(srv, reqs):
    return {r.rid: r.out for r in srv.run(reqs)}


def _fresh(cfg, params, **kw):
    srv = make_server(cfg, **dict(KW, **kw))
    srv.set_params(params)
    return srv


# ---------------------------------------------------------------------------
# engine side


def test_reload_equivalence():
    cfg = _cfg()
    p_new = _init(cfg, 42)
    old_oracle = _stream(make_server(cfg, **KW), _reqs(cfg, [0, 1], seed=7))
    new_oracle = _stream(_fresh(cfg, p_new), _reqs(cfg, [10, 11], seed=8))

    srv = make_server(cfg, **KW)
    for r in _reqs(cfg, [0, 1], seed=7):
        assert srv.admit(r)
    srv.step()  # both rows mid-flight
    assert not srv.request_reload(p_new)  # rows active: staged, not swapped
    assert srv.reload_pending()
    assert not srv.admit(_reqs(cfg, [50], seed=9)[0])  # gated
    while any(r is not None for r in srv.active):
        srv.step()
    assert srv.reloads == 0
    srv.step()  # the first drained tick boundary lands the swap
    assert srv.reloads == 1 and not srv.reload_pending()
    assert srv.alloc.invalidations_total == 1  # old-weight prefixes gone
    assert {r.rid: r.out for r in srv.done} == old_oracle
    done = _stream(srv, _reqs(cfg, [10, 11], seed=8))
    assert {k: v for k, v in done.items() if k >= 10} == new_oracle


def test_reload_immediate_when_drained():
    cfg = _cfg()
    srv = make_server(cfg, **dict(KW, max_seq=32))
    p_new = _init(cfg, 1)
    assert srv.request_reload(p_new)
    assert srv.reloads == 1 and not srv.reload_pending()
    assert _stream(srv, _reqs(cfg, [0, 1], seed=3)) == \
        _stream(_fresh(cfg, p_new, max_seq=32), _reqs(cfg, [0, 1], seed=3))


def test_reload_restaging_keeps_newest():
    cfg = _cfg()
    srv = make_server(cfg, **dict(KW, max_seq=32))
    p1, p2 = _init(cfg, 1), _init(cfg, 2)
    assert srv.admit(_reqs(cfg, [0], seed=4)[0])
    assert not srv.request_reload(p1)
    assert not srv.request_reload(p2)  # supersedes p1 while still staged
    srv.run([])  # drain; the trailing maybe_swap lands the staged tree
    assert srv.reloads == 1
    assert torch.equal(srv.params["embed"]["tok"], p2["embed"]["tok"])


def test_set_params_calls_the_policy_hook():
    class Counting(GreedyPolicy):
        calls = 0

        def on_params(self, eng):
            Counting.calls += 1

    cfg = _cfg()
    srv = make_server(cfg, **dict(KW, policy=Counting()))
    srv.request_reload(_init(cfg, 3))
    assert Counting.calls == 1


# ---------------------------------------------------------------------------
# watcher side


def _params_and_watcher(tmp_path, cfg):
    p = _init(cfg, 0)
    mgr = CheckpointManager(str(tmp_path))
    like = tree_map(torch.zeros_like, p)
    return p, mgr, ManifestWatcher(mgr, like=like)


def test_watcher_diff_ships_zero_bytes_for_unchanged_leaves(tmp_path):
    cfg = _cfg()
    p1, mgr, w = _params_and_watcher(tmp_path, cfg)
    mgr.save(1, {"params": p1}, meta={"step": 1})
    step, landed1 = w.poll()
    assert step == 1 and w.last_step == 1
    flat1 = _flatten(landed1)
    st1 = w.last_reload_stats
    assert st1["changed"] == len(flat1) and st1["reused"] == 0
    for k, v in _flatten(p1).items():
        assert torch.equal(flat1[k], v)

    p2 = tree_map(lambda t: t.clone(), p1)
    p2["embed"]["tok"] = p2["embed"]["tok"] * 2.0 + 1.0
    mgr.save(2, {"params": p2}, meta={"step": 2})
    assert w.poll()[0] == 2
    st2 = w.last_reload_stats
    assert st2["changed"] == 1 and st2["reused"] == len(flat1) - 1
    assert st2["gather_needed"] < st2["gather_manifest"]
    assert st2["gather_skipped"] > 0
    same = sum(1 for k in flat1 if w._landed[k] is flat1[k])
    assert same == st2["reused"]  # unchanged leaves: identical objects
    assert torch.equal(w._landed["embed/tok"], p2["embed"]["tok"])
    assert w.steps_seen == [1, 2] and w.steps_skipped == []


def test_watcher_stale_and_missing_manifest(tmp_path):
    cfg = _cfg()
    p1, mgr, w = _params_and_watcher(tmp_path, cfg)
    assert w.poll() is None and w.poll_errors == 0
    mgr.save(1, {"params": p1}, meta={"step": 1})
    assert w.poll() is not None
    assert w.poll() is None
    assert w.steps_seen == [1]


def test_watcher_skips_coalesced_checkpoints(tmp_path):
    cfg = _cfg()
    p1, mgr, w = _params_and_watcher(tmp_path, cfg)
    mgr.save(1, {"params": p1}, meta={"step": 1})
    assert w.poll()[0] == 1
    small_cfg = ops.coalesce_config(cfg, MultiLevelConfig(), width=True, depth=True)
    mgr.save(2, {"params": _init(small_cfg, 1)}, meta={"step": 2})
    assert w.poll() is None
    assert w.steps_skipped == [2] and w.last_step == 1
    assert w.poll() is None  # remembered, not re-examined
    mgr.save(3, {"params": p1}, meta={"step": 3})
    assert w.poll()[0] == 3
    assert w.steps_seen == [1, 3]


def test_watcher_rejects_non_v3_layout(tmp_path):
    cfg = _cfg()
    p = _init(cfg, 0)
    CheckpointManager(str(tmp_path), dedup=False).save(1, {"params": p}, meta={"step": 1})
    w = ManifestWatcher(CheckpointManager(str(tmp_path), dedup=False),
                        like=tree_map(torch.zeros_like, p))
    with pytest.raises(ValueError, match="content-addressed"):
        w.poll()


def test_watcher_counts_a_step_lost_to_gc_and_lands_the_next(tmp_path):
    cfg = _cfg()
    p1, mgr, w = _params_and_watcher(tmp_path, cfg)
    mgr.save(1, {"params": p1}, meta={"step": 1})
    shutil.rmtree(os.path.join(str(tmp_path), "objects"))  # collected after the publish
    assert w.poll() is None and w.poll_errors == 1 and w.steps_seen == []
    mgr.save(2, {"params": p1}, meta={"step": 2})
    assert w.poll()[0] == 2 and w.steps_seen == [2]


def test_attached_watcher_swaps_during_run(tmp_path):
    cfg = _cfg()
    p1, mgr, w = _params_and_watcher(tmp_path, cfg)
    mgr.save(1, {"params": p1}, meta={"step": 1})
    oracle = _stream(_fresh(cfg, p1), _reqs(cfg, [0, 1, 2], seed=5))
    srv = make_server(cfg, **KW)
    srv.attach_watcher(w)
    assert _stream(srv, _reqs(cfg, [0, 1, 2], seed=5)) == oracle
    assert srv.reloads == 1 and srv.rejected == []
    assert w.steps_seen == [1]


# ---------------------------------------------------------------------------
# across the packages


def test_reference_checkpoint_lands_in_the_port_server(tmp_path):
    jcfg = jax_get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=jnp.float32)
    cfg = _cfg()
    ref = jax_make_server(jcfg, engine="paged", batch=2, max_seq=48, page_size=8)
    p_ref = ref.model.init(jax.random.PRNGKey(5))
    JaxCheckpointManager(str(tmp_path)).save(3, {"params": p_ref}, meta={"step": 3})
    ref.set_params(p_ref)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 14)]
    want = {r.rid: r.out for r in ref.run([JaxRequest(i, p, 6) for i, p in enumerate(prompts)])}

    srv = make_server(cfg, **KW)
    w = ManifestWatcher(CheckpointManager(str(tmp_path)), like=srv.params)
    srv.attach_watcher(w)
    got = {r.rid: r.out for r in srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])}
    assert w.steps_seen == [3] and srv.reloads == 1
    assert got == want


def test_serve_cli_reloads_from_a_checkpoint_dir(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve

    cfg = get_config("tinyllama-1.1b", smoke=True)
    CheckpointManager(str(tmp_path)).save(4, {"params": _init(cfg, 6)}, meta={"step": 4})
    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", "--requests", "2",
                                     "--max-new", "2", "--reload-from", str(tmp_path),
                                     "--poll-every", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "reloads=1 steps_seen=[4] steps_skipped=[]" in out, out


def test_serve_cli_reads_a_local_checkpoint_spread_over_dirs(tmp_path, monkeypatch, capsys):
    """A checkpoint written into per-host local dirs by several processes
    keeps each rank's FSDP blocks in its own dir (half of the objects here,
    moved to a second dir): ``--reload-local`` alone refuses it, naming
    ``--reload-peer-dirs``, and with the other dir there it lands whole."""
    from repro_torch.launch import serve

    cfg = get_config("tinyllama-1.1b", smoke=True)
    mine, peer = tmp_path / "rank0", tmp_path / "rank1"
    CheckpointManager(str(mine)).save(4, {"params": _init(cfg, 6)}, meta={"step": 4})
    objs = sorted((mine / "objects").rglob("*.npy"))
    assert len(objs) > 1
    for f in objs[::2]:
        dst = peer / "objects" / f.parent.name / f.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(f), str(dst))
    argv = ["serve", "--device", "cpu", "--requests", "2", "--max-new", "2",
            "--reload-from", str(mine), "--reload-local"]
    monkeypatch.setattr("sys.argv", argv)
    with pytest.raises(FileNotFoundError, match="--reload-peer-dirs"):
        serve.main()
    monkeypatch.setattr("sys.argv", argv + ["--reload-peer-dirs", str(peer)])
    srv, watcher, _ = serve.main()
    assert "reloads=1 steps_seen=[4] steps_skipped=[]" in capsys.readouterr().out
    want = _flatten(_init(cfg, 6))
    got = _flatten(srv.params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
