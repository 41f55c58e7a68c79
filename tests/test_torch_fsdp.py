"""FSDP in training: the train state split over the data axes
(``distributed/fsdp.py``), on meshes of spawned gloo processes on the CPU,
held to the reference's UNSHARDED step and ``History`` at f32 (the
reference's own mesh tests fail under its installed jax: ROADMAP, "Oracles
on a mesh").

* Spawn P, two ranks on ``--mesh 2x1``: one FSDP step (``grad_compression``
  "none", per-layer gathers) of ``tiny_dense``, ``tiny_moe``, ``tiny_mla``
  with the MTP head and a tiny BERT (MLM) from the port's init on a seeded
  batch; the dense case also under ``remat="full"``, with
  ``pregather_params``, and through the explicit ``dense`` and ``int8_ef``
  reductions on the FSDP layout; then ``test_torch_resume.py``'s 2-level
  V-cycle uninterrupted, and again saved coordinated every 2 steps and
  killed at global step 6 in its upward sweep.
* Spawns Q and R, four ranks on ``--mesh 2x2`` and on ``--mesh 2x1x2``
  (data and model split together; a "pod" axis): the four step cases.
* Spawn T, four ranks on ``--mesh 2x2x1``: the ``dense`` and ``int8_ef``
  steps, whose residual rows split over the fast "data" axis.
* Spawn S, two ranks on ``--mesh 1x2`` after P: P's save resumed to the
  end.  Here: the same save resumed on one process.

Each step's parameters, AdamW moments, loss and grad norm are held within
``STEP_TOL`` of the reference's ``make_train_step`` (``int8_ef`` within
``INT8_TOL``): the MoE and BERT cases need the FSDP step's global-batch
statistics (the MLM label count differs between the ranks' rows, and so do
the MoE routing fractions).  Each rank's blocks are ``1/D`` of every leaf
whose ``embed`` dim divides D; the collectives a step are pinned: one
gather a layer and one for the leaves outside the stacks in the forward,
one more a layer under remat, one reduce-scatter for each of those; one of
each a step under ``pregather_params``; one gather (the train state at
entry) and no reduce-scatter under an explicit reduction; and the
statistics' all-reduces (``_batch_means``).  The V-cycle and both resumes
follow the reference's ``History`` within ``VC_TOL``.  The reverse ways
are tested elsewhere: a one-process save resumes on ``--mesh 2x1``
(``test_torch_ckpt_coordinated.py``) and a 1x2 save on 2x1
(``test_torch_model_parallel.py``), both on the FSDP layout now.
"""
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.core import vcycle as jvc
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.bridge import to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.core.vcycle import VCycleRunner
from repro_torch.distributed.sharding import split_factors
from repro_torch.launch.train import restore_vcycle_state
from repro_torch.models.api import build_model, train_state_shardings
from repro_torch.param import flatten
from test_torch_model_parallel import (CASES_SRC, INT8_TOL, STEP_TC, STEP_TOL, VC_TOL,
                                       _case_batch, _finish, _follows, _jax_case_cfg,
                                       _ns_mesh, _port_case_cfg)
from test_torch_model_parallel import _start as _mp_start
from test_torch_resume import MLKW, TCKW, jax_cfg, port_cfg
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

KILL_AT = 6
CASES = ("dense", "moe", "mla", "bert")
MESHES = ("2x1", "2x2", "2x1x2")
VARIANTS = ("full", "pregather", "dense", "int8_ef")

WORKER = CASES_SRC + textwrap.dedent("""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import fsdp
    from repro_torch.launch.train import make_vcycle_save_cb
    from repro_torch.models.api import build_model, make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    def step_case(name, tag, comp="none", remat=None, **kw):
        cfg = _port_case_cfg(name)
        if remat is not None:
            cfg = cfg.replace(remat=remat)
        model = build_model(cfg)
        tc = TrainConfig(**dict(STEP_TC, **kw))
        w = np.load(f"{OUT}/{name}_case.npz")
        params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
        batch = {k[2:]: torch.from_numpy(w[k]) for k in w.files if k[:2] == "b/"}
        psh, osh = train_state_shardings(model, tc, mesh)
        local = put_global_tree(params, psh, mesh)
        opt = adamw_init(local, tc)
        rows = as_global_batch_fn(lambda g: batch, mesh)(0)
        gr = make_grad_reduce(comp, mesh)
        fsdp.reset_counts()
        if gr is None:
            local, opt, m = make_train_step(model, tc, mesh=mesh)(local, opt, rows)
        else:
            ef = gr.init_state(local, psh) if gr.stateful else None
            step = make_train_step(model, tc, grad_reduce=gr, mesh=mesh)
            local, opt, ef, m = step(local, opt, ef, rows)
            assert (ef is None) != gr.stateful
            if ef is not None:  # the residual rows: [1, block] of the layout
                want = flatten(gr.init_state(local, psh))
                assert all(v.shape == want[k].shape for k, v in flatten(ef).items())
        torch.save({
            "counts": fsdp.counts(),
            "local_shapes": {k: tuple(v.shape) for k, v in flatten(local).items()},
            "moment_shapes": {k: tuple(v.shape) for k, v in flatten(opt["m"]).items()},
            "params": {k: v.detach() for k, v in
                       flatten(gather_global_tree(local, psh, mesh)).items()},
            "m": flatten(gather_global_tree(opt["m"], osh["m"], mesh)),
            "v": flatten(gather_global_tree(opt["v"], osh["v"], mesh)),
            "metrics": {k: float(v) for k, v in m.items()}}, f"{OUT}/{tag}_rank{RANK}.pt")

    for job in filter(None, os.environ["JOBS"].split(";")):
        name, tag, comp, extra = job.split(",")
        kw = {"remat": "full"} if extra == "full" else (
            {"pregather_params": True} if extra == "pregather" else {})
        step_case(name, tag, comp, **kw)
""")

VCYCLE = textwrap.dedent("""
    record("vc21", *run_vcycle("none"))

    class Preempted(RuntimeError):
        pass

    tc = TrainConfig(**TCKW)
    runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, batch_fn, device="cpu",
                          mesh=mesh)
    save_cb = make_vcycle_save_cb(CheckpointManager(f"{OUT}/ck21"), schedule=runner.plan,
                                  runner=runner)

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state)
        if state.global_step == KILL_AT:
            raise Preempted

    try:
        runner.run(state=VCycleState(), params=put_global_tree(
            from_reference(INIT, port_cfg()), runner.level_shardings(0)[0], mesh),
            ckpt_cb=killing_cb, ckpt_every=2)
        raise AssertionError("not killed")
    except Preempted:
        pass
""")

RESUME = textwrap.dedent("""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import restore_vcycle_state
    tc = TrainConfig(**TCKW)
    runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, batch_fn, device="cpu",
                          mesh=mesh)
    state, params, opt = restore_vcycle_state(CheckpointManager(f"{OUT}/ck21"), runner, tc)
    assert (state.phase, state.level, state.global_step) == ("up", 1, KILL_AT), state
    record("resume12", runner, runner.run(state=state, params=params, opt_state=opt))
""")

END = "\ndist.destroy_process_group()\n"


def _jobs(spec):
    return ";".join(",".join(j) for j in spec)


def _start(body, n, mesh, out, jobs=()):
    return _mp_start(WORKER + body + END, n, mesh, out, JOBS=_jobs(jobs) or "")


def _layers(cfg) -> int:
    return sum(st.repeats * len(st.pattern) for st in cfg.stages) + cfg.n_encoder_layers


def _batch_means(cfg) -> int:
    """The FSDP step's global-batch statistics without remat: the label
    count of each cross-entropy (MTP's too), and each MoE layer's routing
    statistics forward and their gradient backward."""
    moe = sum(st.repeats * sum(b.ffn == "moe" for b in st.pattern) for st in cfg.stages)
    return 1 + bool(cfg.mtp_depth) + 2 * moe


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the arena and each case's weights and batch, start spawns P, Q
    and R, compute the reference's steps and V-cycle meanwhile, then T and
    S once P is done, and resume P's save on one process here."""
    out = tmp_path_factory.mktemp("fsdp")
    chain = JMarkovLM(128)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, 4, 16))
    batches = [jax.tree.map(np.asarray, sample(g)) for g in range(21)]
    init = jax.tree.map(np.asarray, jax_build_model(jax_cfg()).init(jax.random.PRNGKey(0)))
    np.savez(out / "arena.npz", **{f"init/{k}": v for k, v in flatten(init).items()},
             **{f"b{g}/{k}": v for g, b in enumerate(batches) for k, v in b.items()})
    cases = {}
    for name in CASES:
        c, tcfg = _jax_case_cfg(name), _port_case_cfg(name)
        p = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(1)), tcfg)
        b = _case_batch(name, c)
        np.savez(out / f"{name}_case.npz", **{f"p/{k}": v for k, v in flatten(p).items()},
                 **{f"b/{k}": v for k, v in b.items()})
        cases[name] = (c, p, b)
    steps = lambda mesh: [(n, f"{mesh}_{n}", "none", "") for n in CASES]
    variants = [("dense", "var_full", "none", "full"),
                ("dense", "var_pregather", "none", "pregather"),
                ("dense", "var_dense", "dense", ""), ("dense", "var_int8_ef", "int8_ef", "")]
    procs = {"P": _start(VCYCLE, 2, "2x1", out, steps("2x1") + variants),
             "Q": _start("", 4, "2x2", out, steps("2x2")),
             "R": _start("", 4, "2x1x2", out, steps("2x1x2"))}
    try:
        want = {}
        for name, (c, p, b) in cases.items():
            jm, jtc = jax_build_model(c), JTC(**STEP_TC)
            jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b)
            p1, o1, m1 = jax.jit(jax_make_train_step(jm, jtc))(jp, jax_adamw_init(jp, jtc), jb)
            want[name] = {"params": flatten(jax.tree.map(np.asarray, p1)),
                          "m": flatten(jax.tree.map(np.asarray, o1["m"])),
                          "v": flatten(jax.tree.map(np.asarray, o1["v"])),
                          "metrics": {k: float(v) for k, v in m1.items()}}
        jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
        ref = jvc.VCycleRunner(jax_cfg(), JML(**MLKW), JTC(**TCKW), jbf, seed=0).run(
            state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
        want["vcycle"] = {"loss": ref.history.loss, "step": ref.history.step,
                          "level": ref.history.level, "flops": ref.history.flops,
                          "params": flatten(jax.tree.map(np.asarray, ref.params))}
        _finish(procs.pop("P"), "spawn P (2x1)")
        procs["S"] = _start(RESUME, 2, "1x2", out)
        tc = TrainConfig(**TCKW)
        runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, None, device="cpu")
        runner.batch_fn = lambda g: {k: torch.from_numpy(v.astype(np.int64))
                                     for k, v in batches[g].items()}
        state, params, opt = restore_vcycle_state(CheckpointManager(str(out / "ck21")),
                                                  runner, tc)
        assert (state.phase, state.level, state.global_step) == ("up", 1, KILL_AT)
        one = runner.run(state=state, params=params, opt_state=opt)
        one_rec = {"loss": one.history.loss, "step": one.history.step,
                   "level": one.history.level, "flops": one.history.flops,
                   "params": {k: v.detach() for k, v in flatten(one.params).items()}}
        for key in ("Q", "R"):
            _finish(procs.pop(key), f"spawn {key}")
        procs["T"] = _start("", 4, "2x2x1", out, [("dense", "2x2x1_dense", "dense", ""),
                                                   ("dense", "2x2x1_int8_ef", "int8_ef", "")])
        for key in ("S", "T"):
            _finish(procs.pop(key), f"spawn {key}")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    got = lambda tag, n=2: [torch.load(out / f"{tag}_rank{r}.pt", weights_only=False)
                            for r in range(n)]
    return {"want": want, "got": got, "one": one_rec, "out": out}


def _gap_share(got, want, tol) -> float:
    want = np.asarray(want, np.float64)
    gap = float(np.abs(np.asarray(got, np.float64) - want).max())
    return gap / (tol * max(1.0, float(np.abs(want).max())))


def _check_step(recs, want, tol=STEP_TOL, tag=""):
    """Every rank's gathered parameters and moments, loss and grad norm
    within ``tol`` of the reference's; every rank the same numbers."""
    worst = 0.0
    for r, rec in enumerate(recs):
        for what in ("params", "m", "v"):
            assert rec[what].keys() == want[what].keys(), what
            for k, v in rec[what].items():
                share = _gap_share(v.numpy(), want[what][k], tol)
                worst = max(worst, share)
                assert share <= 1.0, (tag, r, what, k, share)
        for k in ("loss", "grad_norm"):
            assert _gap_share(rec["metrics"][k], want["metrics"][k], tol) <= 1.0, (tag, k)
        assert rec["metrics"] == recs[0]["metrics"], (tag, r)
    print(f"[{tag}] largest gap {worst:.3e} of its tolerance")


def _check_blocks(rec, name, mesh):
    """Each rank's parameter and moment blocks are exactly its blocks of
    the layout: ``1/D`` of a leaf on its ``embed`` dim (where D divides
    it), and ``1/M`` on a "model"-split dim besides.  Returns the count of
    leaves split over data."""
    dims = tuple(int(x) for x in mesh.split("x"))
    ns = _ns_mesh(dims)
    psh = flatten(train_state_shardings(build_model(_port_case_cfg(name)), TrainConfig(),
                                        ns)[0])
    n_data = 0
    for k, v in rec["params"].items():
        f = split_factors(psh[k], ns)
        assert rec["local_shapes"][k] == tuple(d // x for d, x in zip(v.shape, f)), k
        assert rec["moment_shapes"][k] == rec["local_shapes"][k], k
        n_data += any(a in ("pod", "data") for e in psh[k] if e is not None
                      for a in ((e,) if isinstance(e, str) else e))
    return n_data


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CASES)
def test_fsdp_step_matches_the_reference_unsharded_step(runs, name, mesh):
    n = 2 if mesh == "2x1" else 4
    recs = runs["got"](f"{mesh}_{name}", n)
    _check_step(recs, runs["want"][name], tag=f"{mesh} {name}")
    cfg = _port_case_cfg(name)
    L = _layers(cfg)
    for rec in recs:
        # per layer: one gather forward and one reduce-scatter backward, and
        # one of each for the leaves outside the stacks
        assert rec["counts"] == {"all_gather": L + 1, "reduce_scatter": L + 1,
                                 "batch_mean": _batch_means(cfg)}, rec["counts"]
        assert _check_blocks(rec, name, mesh) > 0


def test_each_rank_holds_half_of_every_embed_leaf_on_2x1(runs):
    """On 2x1 every leaf of the dense case with an ``embed`` dim (d_model
    64 divides 2) is held as half of it, parameters and moments alike; the
    others (``q_norm``, ``k_norm``: head_dim wide) whole."""
    specs = flatten(build_model(_port_case_cfg("dense")).specs())
    for rec in runs["got"]("2x1_dense"):
        halves = 0
        for k, v in rec["params"].items():
            ratio = int(np.prod(v.shape)) // int(np.prod(rec["local_shapes"][k]))
            assert ratio == (2 if "embed" in specs[k].axes else 1), k
            assert rec["moment_shapes"][k] == rec["local_shapes"][k], k
            halves += ratio == 2
        assert halves == sum("embed" in s.axes for s in specs.values()) >= len(specs) - 6


@pytest.mark.parametrize("variant", VARIANTS)
def test_fsdp_variants_on_2x1(runs, variant):
    """remat "full" re-gathers each layer in the backward; pregather_params
    gathers the whole tree once and reduce-scatters once; the explicit
    reductions gather the train state once at entry and reduce as before."""
    recs = runs["got"](f"var_{variant}")
    L = _layers(_port_case_cfg("dense"))
    want = {"full": {"all_gather": 2 * L + 1, "reduce_scatter": L + 1, "batch_mean": 1},
            "pregather": {"all_gather": 1, "reduce_scatter": 1, "batch_mean": 1},
            # the reference's explicit step: each process's own loss
            "dense": {"all_gather": 1, "reduce_scatter": 0, "batch_mean": 0},
            "int8_ef": {"all_gather": 1, "reduce_scatter": 0, "batch_mean": 0}}[variant]
    for rec in recs:
        assert rec["counts"] == want, (variant, rec["counts"])
        _check_blocks(rec, "dense", "2x1")
    _check_step(recs, runs["want"]["dense"], INT8_TOL if variant == "int8_ef" else STEP_TOL,
                f"2x1 {variant}")


@pytest.mark.parametrize("comp", ["dense", "int8_ef"])
def test_explicit_reductions_on_2x2x1_split_the_residual_rows(runs, comp):
    """On a "pod" axis the residual rows split over the fast "data" axis:
    the step gathers them around the reduction (a second gather) and cuts
    them back."""
    recs = runs["got"](f"2x2x1_{comp}", 4)
    n_gathers = 2 if comp == "int8_ef" else 1
    for rec in recs:
        assert rec["counts"] == {"all_gather": n_gathers, "reduce_scatter": 0, "batch_mean": 0}
        _check_blocks(rec, "dense", "2x2x1")
    _check_step(recs, runs["want"]["dense"], INT8_TOL if comp == "int8_ef" else STEP_TOL,
                f"2x2x1 {comp}")


def test_fsdp_vcycle_on_2x1_follows_the_reference_unsharded_history(runs):
    recs = runs["got"]("vc21")
    for r, rec in enumerate(recs):
        _follows(rec, runs["want"]["vcycle"], VC_TOL, f"2x1 FSDP rank {r}")
        assert rec["n_compiles"] == 2
        specs = flatten(build_model(port_cfg()).specs())
        for k, v in rec["local"].items():  # the blocks, level 0's layout
            ratio = 2 if "embed" in specs[k].axes else 1
            assert ratio * v.numel() == rec["params"][k].numel(), k
    assert recs[0]["loss"] == recs[1]["loss"]


def test_fsdp_save_mid_upward_sweep_resumes_on_one_process_and_on_1x2(runs):
    want = runs["want"]["vcycle"]
    _follows(runs["one"], want, VC_TOL, "2x1 -> one process")
    for r, rec in enumerate(runs["got"]("resume12")):
        _follows(rec, want, VC_TOL, f"2x1 -> 1x2 rank {r}")
    meta = CheckpointManager(str(runs["out"] / "ck21")).latest()["meta"]
    assert (meta["phase"], meta["global_step"], meta["stashed_levels"]) == ("up", KILL_AT, [0])
    assert os.path.isdir(runs["out"] / "ck21")
