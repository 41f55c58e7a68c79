"""The port's data-parallel pieces in one process, against the reference, on
the CPU.

* ``distributed/sharding.py``: ``logical_spec`` equals the reference's for
  every leaf of every registered config's parameter specs and dense decode
  caches, at the meshes (1,1), (2,1), (4,2), (16,16) and (2,16,16), under
  ``RULES`` and under ``RULES`` + ``SERVE_RULES`` (meshes as plain axis/shape
  objects: the rules need no devices).
* ``distributed/compression.py``: the pure cases of
  ``tests/test_compression.py`` and ``tests/test_gradreduce.py``
  (quantization bounds, exact EF conservation, wire bytes), and
  ``quantize_int8`` / ``ef_compress`` equal to the reference's on seeded
  inputs; ``make_grad_reduce`` ("none" names no strategy, as the
  reference's), the EF layout and ``parse_mesh_arg``; ``GlobalBatchFn``'s rows per mesh coordinate.
* At world 1 (gloo, an in-process store): the dense 4-ary step equals the
  plain step bit for bit, and both follow the reference's ``shard_map``
  step on a (1, 1) mesh at f32 (1e-5; Adam's eps 1e-4 as in
  ``tests/test_torch_train.py``); the int8_ef step stays within the
  reference test's 1e-2 of dense.
* An int8_ef V-cycle on a 1x1 mesh, killed in its upward sweep and resumed,
  gives the EF state and parameters of an uninterrupted run bit for bit; its
  checkpoint restores in the reference, and the reference's save of that
  state resumes in the port.
* The refusals: the slots engine on a mesh, and the training launcher's
  "model" axis larger than 1, ``--no-ckpt-dedup``
  with ``--ckpt-local-dir`` (several processes checkpoint, coordinated);
  ``init_distributed`` and ``make_cli_mesh`` run on the
  card unless given a device, so with none they raise.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import mp_arena
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.config import TrainConfig as JTC
from repro.configs import ASSIGNED
from repro.configs import PAPER_CONFIGS as J_PAPER
from repro.configs import get_config as jax_get_config
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.distributed.reduce import make_grad_reduce as jax_make_grad_reduce
from repro.launch.train import make_vcycle_save_cb as jax_make_vcycle_save_cb
from repro.launch.train import restore_vcycle_state as jax_restore_vcycle_state
from repro.models.api import build_model as jax_build_model
from repro.models.api import init_train_state as jax_init_train_state
from repro.models.api import make_train_step as jax_make_train_step

from repro_torch.bridge import (from_reference, opt_state_from_reference, to_reference)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig
from repro_torch.config import uniform_stages
from repro_torch.configs import get_config
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.data import MarkovLM, lm_batch
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.reduce import HierarchicalInt8EF, make_grad_reduce
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import make_server
from repro_torch.models.api import build_model, make_train_step, zero_train_state
from repro_torch.param import flatten

ARCHS = list(ASSIGNED) + list(J_PAPER)
MESHES = [(1, 1), (2, 1), (4, 2), (16, 16), (2, 16, 16)]


def _ns_mesh(dims):
    axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny models' ops are too small to share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh11():
    """A (1, 1) ("data", "model") DeviceMesh over a one-rank gloo group."""
    mesh = tmesh.make_cli_mesh("1x1", num_processes=1, device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# sharding rules


def _leaves(tree, is_leaf):
    out = {}

    def rec(t, path):
        if is_leaf(t):
            out[path] = t
        else:
            for k, v in t.items():
                rec(v, f"{path}/{k}")

    rec(tree, "")
    return out


@pytest.mark.parametrize("rules", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_spec_matches_the_reference(arch, rules):
    jr = None if rules == "train" else dict(jsh.RULES, **jsh.SERVE_RULES)
    tr = None if rules == "train" else dict(tsh.RULES, **tsh.SERVE_RULES)
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(get_config(arch))
    trees = [(jm.specs(), tm.specs())]
    if get_config(arch).family not in ("vit", "encoder"):
        trees.append((jm.cache_specs(4, 256), tm.cache_specs(4, 256)))
    from repro.param import is_spec as j_is_spec
    from repro_torch.param import is_spec as t_is_spec

    n = 0
    for jt, tt in trees:
        jl, tl = _leaves(jt, j_is_spec), _leaves(tt, t_is_spec)
        assert jl.keys() == tl.keys()
        for dims in MESHES:
            mesh = _ns_mesh(dims)
            for k, s in tl.items():
                want = tuple(jsh.logical_spec(jl[k].shape, jl[k].axes, mesh, jr))
                assert tsh.logical_spec(s.shape, s.axes, mesh, tr) == want, (dims, k)
                n += 1
    assert n > 0


def test_rule_tables_and_batch_specs_match_the_reference():
    assert tsh.RULES.keys() == jsh.RULES.keys()
    assert tsh.SERVE_RULES.keys() == jsh.SERVE_RULES.keys()
    for dims in MESHES:
        mesh = _ns_mesh(dims)
        for b in (1, 2, 4, 32, 512):
            x = np.zeros((b, 16), np.int32)
            want = tuple(jsh.logical_spec(x.shape, ("batch", "seq"), mesh))
            got = tsh.batch_shardings({"tokens": torch.zeros(b, 16)}, mesh)["tokens"]
            assert got == want, (dims, b)


# ---------------------------------------------------------------------------
# compression (pure)


@pytest.mark.parametrize("mag", [1e-8, 1e-3, 1.0, 1e3, 1e6])
def test_quantization_error_bound_across_magnitudes(mag):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(256).astype(np.float32)
                         * mag)
    q, s = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, s) - x).abs().max().item()
    bound = x.abs().max().item() / 254.0
    assert err <= bound * (1 + 1e-5)
    assert s.item() == pytest.approx(bound * 2, rel=1e-6)


def test_quantization_payload_zeros_and_reference_equality():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(128).astype(np.float32) * 9.0
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    assert q.min() >= -127 and q.max() <= 127 and (q.max() == 127 or q.min() == -127)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and s.item() == float(js)
    qz, sz = tcomp.quantize_int8(torch.zeros(32))
    assert not qz.any() and not tcomp.dequantize_int8(qz, sz).any() and sz.item() > 0
    e = rng.standard_normal(128).astype(np.float32) * 0.01
    got = tcomp.ef_compress(torch.from_numpy(x), torch.from_numpy(e))
    want = jcomp.ef_compress(jnp.asarray(x), jnp.asarray(e))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ef_conserves_the_signal_and_stays_unbiased():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(128).astype(np.float32) * 0.3)
    ef = torch.from_numpy(rng.standard_normal(128).astype(np.float32) * 0.01)
    q, s, new_ef = tcomp.ef_compress(x, ef)
    torch.testing.assert_close(tcomp.dequantize_int8(q, s) + new_ef, x + ef, atol=1e-6, rtol=0)
    assert new_ef.abs().max().item() <= s.item() / 2 + 1e-6
    xs = torch.from_numpy(rng.standard_normal((50, 256)).astype(np.float32) * 0.01)
    ef, sent = torch.zeros(256), torch.zeros(256)
    for i in range(50):
        q, s, ef = tcomp.ef_compress(xs[i], ef)
        sent = sent + tcomp.dequantize_int8(q, s)
    torch.testing.assert_close(sent + ef, xs.sum(0), atol=1e-4, rtol=0)


def test_packed_psum_at_world_one(mesh11):
    """One rank: the packed path agrees leaf for leaf with ``ef_compress``,
    conserves the signal, and makes exactly two collectives."""
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32) * 0.3),
             "b": {"c": torch.from_numpy(rng.standard_normal(32).astype(np.float32) * 2)}}
    ef = {"a": grads["a"].abs() * 0.01, "b": {"c": grads["b"]["c"].abs() * 0.01}}
    calls = []
    real = torch.distributed.all_reduce

    def counting(t, *a, **k):
        calls.append(t.dtype)
        return real(t, *a, **k)

    tcomp.reset_ef_psum_probe()
    torch.distributed.all_reduce = counting
    try:
        out, new_ef = tcomp.ef_int8_psum(grads, ef, None)
    finally:
        torch.distributed.all_reduce = real
    assert calls == [torch.float32, torch.int32] and tcomp.ef_psum_calls() == 1
    for k in ("a", "b/c"):
        g, e = flatten(grads)[k], flatten(ef)[k]
        q, s, ref_ef = tcomp.ef_compress(g, e)
        torch.testing.assert_close(flatten(out)[k], q.float() * s, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(flatten(new_ef)[k], ref_ef, atol=1e-6, rtol=0)
        torch.testing.assert_close(flatten(out)[k] + flatten(new_ef)[k], g + e, atol=1e-5,
                                   rtol=0)


def test_wire_bytes_factory_layout_and_mesh_arg():
    grads = {"emb": torch.zeros(128, 32), "w": torch.zeros(32, 64), "b": torch.zeros(64)}
    jgrads = {k: jnp.zeros(tuple(v.shape)) for k, v in grads.items()}
    assert tcomp.dense_wire_bytes(grads) == jcomp.dense_wire_bytes(jgrads)
    assert tcomp.int8_wire_bytes(grads) == jcomp.int8_wire_bytes(jgrads)
    assert tcomp.dense_wire_bytes(grads) / tcomp.int8_wire_bytes(grads) >= 3.0
    for k, v in flatten(tcomp.init_ef_state(grads)).items():
        assert v.shape == grads[k].shape and v.dtype == torch.float32 and not v.any()
    m2, m3 = _ns_mesh((1, 1)), _ns_mesh((2, 2, 1))
    for name in ("none", "", None):  # no strategy, as the reference's: the FSDP step
        assert make_grad_reduce(name, None) is None
        assert make_grad_reduce(name, m3) is None is jax_make_grad_reduce(name, m3)
    for name, mesh in (("dense", m3), ("int8_ef", m3), ("int8_ef", m2), ("dense", m2)):
        got, want = make_grad_reduce(name, mesh), jax_make_grad_reduce(
            name, types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape))
        assert (type(got).__name__, got.data_axes, got.stateful) == (
            type(want).__name__, want.data_axes, want.stateful)
        if got.stateful:
            assert (got.dcn_axis, got.ici_axes, got.dcn_size) == (
                want.dcn_axis, want.ici_axes, want.dcn_size)
    with pytest.raises(ValueError, match="unknown grad_compression"):
        make_grad_reduce("fp8", m2)
    with pytest.raises(ValueError, match="no data-like axis"):
        make_grad_reduce("dense", types.SimpleNamespace(axis_names=("model",),
                                                        shape={"model": 1}))
    gr = HierarchicalInt8EF(data_axes=("pod", "data"), dcn_axis="pod", ici_axes=("data",),
                            dcn_size=2)
    params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    # this process's row of the reference's [dcn_size, *shape] tree
    jgr = jax_make_grad_reduce("int8_ef", types.SimpleNamespace(
        axis_names=("pod", "data", "model"), shape={"pod": 2, "data": 1, "model": 1}))
    want = jgr.init_state({k: jnp.zeros(tuple(v.shape)) for k, v in params.items()})
    for k, v in gr.init_state(params).items():
        assert v.shape == (1,) + want[k].shape[1:] and want[k].shape[0] == 2
        assert v.dtype == torch.float32 and not v.any()
    assert tmesh.parse_mesh_arg("2x4") == (2, 4)
    assert tmesh.parse_mesh_arg("2x2x1") == (2, 2, 1)
    for bad in ("2", "2x2x2x2", "0x1", "axb"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_arg(bad)


def test_global_batch_fn_takes_this_processes_rows():
    """Each mesh coordinate takes its block of the canonical batch's rows
    (pod-major over ("pod", "data")); the blocks in coordinate order make the
    whole batch; a leading dim the data axes do not divide stays whole."""
    from repro_torch.distributed.multiprocess import GlobalBatchFn

    def canonical(step):
        return {"tokens": torch.arange(8 * 4).reshape(8, 4) + 100 * step,
                "odd": torch.arange(6).reshape(3, 2)}

    for dims, axes in (((2, 1), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))):
        coords = [c for c in np.ndindex(*dims)]
        got = []
        for c in coords:
            mesh = types.SimpleNamespace(mesh_dim_names=axes, shape=dims,
                                         get_coordinate=lambda c=c: list(c))
            b = GlobalBatchFn(canonical, mesh)(3)
            assert torch.equal(b["odd"], canonical(3)["odd"])
            got.append(b["tokens"])
        assert all(g.shape == (8 // len(coords), 4) for g in got)
        assert torch.equal(torch.cat(got), canonical(3)["tokens"]), dims


def test_model_axis_and_multiprocess_checkpoints_are_refused():
    # the server takes a "model" axis on its paged engine only
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="paged engine"):
        make_server(get_config("tinyllama-1.1b", smoke=True), engine="slots", mesh=mesh,
                    device="cpu")
    # per-process local dirs exchange digests: the v2 layout is refused
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gpt-proxy", "--device", "cpu", "--mesh", "2x1",
                      "--num-processes", "2", "--ckpt-local-dir", "/nonexistent",
                      "--no-ckpt-dedup"])
    with pytest.raises(SystemExit):  # --grad-compression needs --mesh
        tlaunch.main(["--arch", "gpt-proxy", "--device", "cpu",
                      "--grad-compression", "dense"])
    assert tmesh.backend_for("cpu", 2) == "gloo"


def test_mesh_entry_points_run_on_the_card_unless_given_a_device(monkeypatch):
    """With no card and no ``device``, ``init_distributed`` and
    ``make_cli_mesh`` raise before joining any group (no silent CPU mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_cli_mesh("1x1")
    assert tmesh.backend_for("cpu", 1) == "gloo"


# ---------------------------------------------------------------------------
# the 4-ary step at world 1


def _port_cfg():
    """``helpers.tiny_dense(d_model=32, d_ff=64, vocab_size=128)`` at f32."""
    return ModelConfig(name="t-dense", family="dense", d_model=32, n_heads=4, n_kv_heads=2,
                       d_ff=64, vocab_size=128,
                       stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                       remat="none", attn_impl="plain", compute_dtype=torch.float32)


STEP_TC = dict(steps=4, warmup_steps=1, peak_lr=1e-3, batch_size=4, seq_len=16, eps=1e-4)


def test_dense_step_equals_the_plain_step_and_follows_the_reference(mesh11):
    jcfg, _, _ = mp_arena()
    jmodel = jax_build_model(jcfg)
    jtc = JTC(**STEP_TC)
    batch = jax.tree.map(np.asarray, jax_lm_batch(JMarkovLM(128), 0, 0, 4, 16))
    jb = jax.tree.map(jnp.asarray, batch)
    jp, jo = jax_init_train_state(jmodel, jtc, jax.random.PRNGKey(0))
    init_p, init_o = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jo)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep = jax.jit(jax_make_train_step(jmodel, jtc,
                                        grad_reduce=jax_make_grad_reduce("dense", jmesh),
                                        mesh=jmesh))
    for _ in range(3):
        jp, jo, _, jm = jstep(jp, jo, None, jb)

    cfg, tc = _port_cfg(), TrainConfig(**STEP_TC)
    model = build_model(cfg)
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    runs = {}
    for name in ("plain", "dense", "int8_ef"):
        p = from_reference(init_p, cfg)
        o = opt_state_from_reference(init_o, cfg)
        if name == "plain":
            step = make_train_step(model, tc)
            for _ in range(3):
                p, o, m = step(p, o, tb)
        else:
            gr = make_grad_reduce(name, mesh11)
            step, ef = make_train_step(model, tc, grad_reduce=gr, mesh=mesh11), None
            ef = gr.init_state(p)
            for _ in range(3):
                p, o, ef, m = step(p, o, ef, tb)
            assert (ef is None) == (name == "dense")
        runs[name] = (flatten(p), m)
    (pp, pm), (dp, dm) = runs["plain"], runs["dense"]
    assert pp.keys() == dp.keys()
    for k in pp:
        assert torch.equal(pp[k], dp[k]), k
    assert torch.equal(pm["loss"], dm["loss"])
    want = flatten(jax.tree.map(np.asarray, jp))
    for k in pp:
        np.testing.assert_allclose(pp[k].detach().numpy(), want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    ip, _ = runs["int8_ef"]
    for k in pp:
        np.testing.assert_allclose(ip[k].detach().numpy(), pp[k].detach().numpy(), atol=1e-2,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# an int8_ef V-cycle: kill, resume, and its checkpoint across the packages

TCKW = dict(steps=12, warmup_steps=1, peak_lr=3e-4, batch_size=4, seq_len=16,
            log_every=2, grad_compression="int8_ef")
MLKW = dict(n_levels=2, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)


class Preempted(RuntimeError):
    pass


def _arena():
    tc = TrainConfig(**TCKW)
    chain = MarkovLM(128)
    bf = lambda step: lm_batch(chain, 0, step, tc.batch_size, tc.seq_len, device="cpu")
    return _port_cfg(), MultiLevelConfig(**MLKW), tc, bf


def _ef_trace(trace):
    def on_step(state, p, o, stopping, dt):
        trace[state.global_step] = {k: v.clone() for k, v in flatten(state.ef).items()}

    return on_step


def test_int8ef_vcycle_kill_resume_and_checkpoint_across_packages(tmp_path, mesh11):
    cfg, ml, tc, bf = _arena()
    ref_trace = {}
    ref = VCycleRunner(cfg, ml, tc, bf, device="cpu", mesh=mesh11).run(
        on_step=_ef_trace(ref_trace))
    assert sorted(ref_trace) == list(range(1, 22))
    assert any(v.abs().max() > 0 for v in ref_trace[6].values())

    cm = CheckpointManager(str(tmp_path / "port"))
    runner = VCycleRunner(cfg, ml, tc, bf, device="cpu", mesh=mesh11)
    save_cb = tlaunch.make_vcycle_save_cb(cm, schedule=runner.plan)

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state, blocking=True)
        if state.global_step == 6:  # mid-upward-sweep: the stash and the EF live
            raise Preempted

    with pytest.raises(Preempted):
        runner.run(ckpt_cb=killing_cb, ckpt_every=2)
    assert cm.latest()["meta"]["has_ef"] is True
    with pytest.raises(ValueError, match="carries grad-reduction"):
        tlaunch.restore_vcycle_state(cm, VCycleRunner(cfg, ml, tc, bf, device="cpu"), tc)

    resumed = VCycleRunner(cfg, ml, tc, bf, device="cpu", mesh=mesh11)
    state, params, opt = tlaunch.restore_vcycle_state(cm, resumed, tc)
    assert (state.phase, state.global_step) == ("up", 6)
    want_ef = {k: v.clone() for k, v in flatten(state.ef).items()}
    for k, v in want_ef.items():
        assert torch.equal(v, ref_trace[6][k]), k
    trace = {}
    out = resumed.run(state=state, params=params, opt_state=opt, on_step=_ef_trace(trace))
    assert sorted(trace) == list(range(7, 22))
    for g in trace:
        for k, v in trace[g].items():
            assert torch.equal(v, ref_trace[g][k]), (g, k)
    for k, v in flatten(ref.params).items():
        assert torch.equal(flatten(out.params)[k], v), k
    assert out.history.to_dict() == ref.history.to_dict()

    # the port's checkpoint restores in the reference (its (1, 1) mesh runner)
    jcfg, _, _ = mp_arena()
    jtc = JTC(**{k: v for k, v in TCKW.items()})
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jrunner = jvc.VCycleRunner(jcfg, jvc.MultiLevelConfig(**MLKW), jtc, lambda g: None,
                               seed=0, mesh=jmesh)
    jstate, jparams, jopt = jax_restore_vcycle_state(
        JaxCheckpointManager(str(tmp_path / "port")), jrunner, jtc)
    assert (jstate.phase, jstate.global_step, jstate.seg_step) == ("up", 6, 3)
    got_ef = flatten(jax.tree.map(np.asarray, jstate.ef))
    assert got_ef.keys() == want_ef.keys()
    for k in want_ef:
        assert np.array_equal(got_ef[k], want_ef[k].numpy()), k
    # ... and the reference's save of that state resumes in the port
    jcm = JaxCheckpointManager(str(tmp_path / "ref"))
    jax_make_vcycle_save_cb(jcm, schedule=jrunner.plan)(jstate, jparams, jopt)
    jcm.wait()
    again = VCycleRunner(cfg, ml, tc, bf, device="cpu", mesh=mesh11)
    st2, p2, o2 = tlaunch.restore_vcycle_state(CheckpointManager(str(tmp_path / "ref")),
                                               again, tc)
    for k in want_ef:
        assert torch.equal(flatten(st2.ef)[k], want_ef[k]), k
    out2 = again.run(state=st2, params=p2, opt_state=o2)
    for k, v in flatten(ref.params).items():
        assert torch.equal(flatten(out2.params)[k], v), k
