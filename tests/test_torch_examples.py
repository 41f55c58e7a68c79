"""The reference's last surface on the port: ``core/plans.py::
normalize_overrides``, ``core/operators.py::build_level_maps``,
``Model.projection_plan`` and the four examples as
``repro_torch.examples.*``.

* For each of ``vcycle_pretrain``'s five ``--config`` families and its
  ``--full-100m`` config (the reference's ``examples/vcycle_pretrain.py``
  loaded from its file): the configs field for field; ``normalize_overrides``
  of the plan's overrides dict, of ``coalesce_experts`` and of None;
  ``build_level_maps(...).as_torch()`` against the reference's ``as_jnp()``
  maps, and ``Model.projection_plan(ml).describe()`` character for
  character, for width and depth, width only and depth only.
* ``quickstart``'s ``run`` (``run_scratch``, ``run_vcycle`` to the smoothed
  target, ``saving_vs_baseline``) against the reference's at f32 and a cut
  step count, on the reference's batches through numpy (``MarkovLM.sample``
  cannot be reproduced bit for bit) and from the reference's init.
* Each example's ``main`` end to end with ``--device cpu`` at a few steps;
  ``serve_decode`` on the paged engine greedy, speculative and reloading a
  ``vcycle_pretrain`` checkpoint, on the slots engine, and on ``--mesh 1x2``
  (two processes, the streams of one); ``elastic_restart``'s three acts,
  act 3 on two CPU processes: both exit 0, both drain at one global step,
  one process resumes to ``done``.  Act 3 has no oracle in the reference
  (its multi-process tests fail in this container), so it is held to the
  port's own invariants.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import BlockSpec as JBlockSpec
from repro.config import ModelConfig as JModelConfig
from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.config import uniform_stages as j_uniform_stages
from repro.core import plans as jplans
from repro.core import vcycle as jvc
from repro.core.operators import build_level_maps as jax_build_level_maps
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.api import build_model as jax_build_model

import repro_torch.core as tcore
from repro_torch.bridge import from_reference
from repro_torch.config import MultiLevelConfig
from repro_torch.core import plans as tplans
from repro_torch.examples import elastic_restart, quickstart, serve_decode, vcycle_pretrain
from repro_torch.models import api as tapi
from test_torch_model_parallel import _coordinator
from test_torch_operators import _same_cfg
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = list(vcycle_pretrain.FAMILIES) + ["full-100m"]
DIRECTIONS = [(True, True), (True, False), (False, True)]
ML = dict(n_levels=2, alpha=0.25, e_a_frac=0.05, e_small_frac=0.5)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_PRETRAIN = _reference_example("vcycle_pretrain")


def _pair(name):
    if name == "full-100m":
        return REF_PRETRAIN.gpt_100m(), vcycle_pretrain.example_config(full_100m=True)
    return REF_PRETRAIN.family_config(name), vcycle_pretrain.example_config(name)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_example_configs_equal_the_reference(name):
    jcfg, tcfg = _pair(name)
    _same_cfg(tcfg, jcfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_normalize_overrides_equals_the_reference(name):
    jcfg, tcfg = _pair(name)
    plan = tplans.build_plan(tcfg, MultiLevelConfig(**ML))
    for arg in (plan.role_overrides, dict(plan.role_overrides), tcfg.coalesce_experts,
                not tcfg.coalesce_experts, None, {}, {"experts": "out"}):
        got, want = tplans.normalize_overrides(arg), jplans.normalize_overrides(arg)
        assert got == want and type(got) is type(want), (arg, got, want)
        if isinstance(arg, dict):
            assert got is arg  # a dict passes through, as the reference's
    assert tplans.normalize_overrides(True) == {"experts": "out"}


@pytest.mark.parametrize("direction", DIRECTIONS, ids=["both", "width", "depth"])
@pytest.mark.parametrize("name", CONFIGS)
def test_build_level_maps_and_projection_plan_equal_the_reference(name, direction):
    jcfg, tcfg = _pair(name)
    width, depth = direction
    got = tapi.build_model(tcfg).projection_plan(MultiLevelConfig(**ML), width=width,
                                                 depth=depth).describe()
    want = jax_build_model(jcfg).projection_plan(JML(**ML), width=width,
                                                 depth=depth).describe()
    assert got == want
    tm = tcore.build_level_maps(tcfg, MultiLevelConfig(**ML), width=width,
                                depth=depth).as_torch()
    jm = jax_build_level_maps(jcfg, JML(**ML), width=width, depth=depth).as_jnp()
    assert set(tm.width) == set(jm.width) and set(tm.depth) == set(jm.depth)
    for ax in jm.width:
        assert tm.width[ax].variant == jm.width[ax].variant
        for f in ("F_out", "F_in", "T_out", "T_in"):
            t, j = getattr(tm.width[ax], f), np.asarray(getattr(jm.width[ax], f))
            assert t.dtype == torch.float32 and j.dtype == np.float32
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{ax}.{f}")
    for g in jm.depth:
        np.testing.assert_array_equal(tm.depth[g].R.numpy(), np.asarray(jm.depth[g].R))
        np.testing.assert_array_equal(tm.depth[g].G.numpy(), np.asarray(jm.depth[g].G))


def test_the_package_exports_build_level_maps_as_the_reference():
    import repro.core as jcore

    assert tcore.build_level_maps is tcore.operators.build_level_maps
    names = {n for n in dir(jcore) if not n.startswith("_")
             and callable(getattr(jcore, n)) and not isinstance(getattr(jcore, n), type(jcore))}
    assert names <= set(dir(tcore)), sorted(names - set(dir(tcore)))


# ---------------------------------------------------------------------------
# quickstart against the reference

QS_STEPS = 20


def _reference_quickstart_cfg():
    """The reference example's config, which its ``main`` builds inline."""
    return JModelConfig(
        name="quickstart-gpt", family="dense", d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, stages=j_uniform_stages(4, JBlockSpec("attn", "dense")),
        remat="none", attn_impl="plain")


def test_quickstart_follows_the_reference(monkeypatch):
    jcfg = _reference_quickstart_cfg().replace(compute_dtype=jnp.float32)
    tcfg = quickstart.quickstart_config().replace(compute_dtype=torch.float32)
    _same_cfg(tcfg, jcfg)
    tc = quickstart.quickstart_train_config(QS_STEPS)
    assert dataclasses.asdict(quickstart.quickstart_train_config()) == dict(
        dataclasses.asdict(tc), steps=120)
    jtc = JTC(steps=QS_STEPS, warmup_steps=10, peak_lr=3e-3, batch_size=16, seq_len=32,
              log_every=5)
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, tc.batch_size, tc.seq_len))
    batches = [jax.tree.map(np.asarray, sample(g)) for g in range(2 * QS_STEPS)]
    jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
    tbf = lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tapi.Model, "init", lambda self, gen: from_reference(init, self.cfg))

    _, jbase = jvc.run_scratch(jcfg, jtc, jbf, seed=0)
    target = float(jbase.smoothed(5)[1][-1])
    jout = jvc.run_vcycle(jcfg, JML(**ML), jtc, jbf, seed=0, target_loss=target)
    want = jvc.saving_vs_baseline(jbase, jout.history)
    got = quickstart.run(tcfg, tc, tbf, chain.entropy(), device="cpu")
    for g, w in ((got["base"], jbase), (got["vcycle"].history, jout.history)):
        assert g.step == w.step and g.level == w.level
        np.testing.assert_allclose(g.flops, w.flops, rtol=1e-12)
        np.testing.assert_allclose(g.loss, w.loss, atol=1e-5, rtol=0)
    assert got["saving"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got["saving"][k], v, rtol=1e-5, equal_nan=True)
    assert len(set(got["vcycle"].history.level)) == 2
    assert got["lines"][0] == f"== from-scratch baseline ({QS_STEPS} steps) =="
    assert re.fullmatch(r"V-cycle reached loss \d+\.\d{3} with -?\d+\.\d% fewer training "
                        r"FLOPs \(.+ vs .+\)", got["lines"][-1])


# ---------------------------------------------------------------------------
# each example end to end on the CPU


def test_quickstart_main_on_the_cpu(monkeypatch):
    full = quickstart.quickstart_train_config
    monkeypatch.setattr(quickstart, "quickstart_train_config", lambda: full(QS_STEPS))
    out = quickstart.main(["--device", "cpu"])
    assert out["base"].step[-1] == QS_STEPS and np.isfinite(out["base"].loss).all()
    assert out["lines"][1].startswith("final loss ")
    assert "fewer training FLOPs" in out["lines"][-1]


@pytest.mark.parametrize("config", vcycle_pretrain.FAMILIES)
def test_vcycle_pretrain_main_on_the_cpu(tmp_path, config):
    out = vcycle_pretrain.main(["--config", config, "--steps", "4", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    cfg = vcycle_pretrain.example_config(config)
    assert out["lines"][0].startswith(f"model {cfg.name}: ")
    assert out["lines"][1] == out["plan"] == tapi.build_model(cfg).projection_plan(
        vcycle_pretrain.ML).describe()
    assert np.isfinite(out["final_loss"]) and len(out["output"].history.loss) > 4
    assert out["lines"][-1] == (f"done; final loss {out['final_loss']:.4f}; "
                                f"checkpoint in {tmp_path / 'ck'}")
    from repro_torch.checkpoint import CheckpointManager

    assert CheckpointManager(str(tmp_path / "ck")).latest()["meta"]["phase"] == "done"


@pytest.fixture(scope="module")
def pretrain_ckpt(tmp_path_factory):
    """A dense V-cycle checkpoint of TinyLlama's smoke widths for the reload
    test: the launcher's, as a trainer would leave it."""
    from repro_torch.launch import train as launch_train

    ck = tmp_path_factory.mktemp("serve_ck") / "ck"
    launch_train.main(["--arch", "tinyllama-1.1b", "--smoke", "--vcycle", "--steps", "4",
                       "--batch", "2", "--seq", "16", "--ckpt-dir", str(ck), "--ckpt-every",
                       "2", "--device", "cpu"])
    return str(ck)


SERVE_CASES = {"greedy": [], "speculative": ["--policy", "speculative"],
               "slots": ["--engine", "slots"], "reload": None}


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_decode_main_on_the_cpu(request, case):
    args = SERVE_CASES[case]
    if args is None:
        args = ["--reload-from", request.getfixturevalue("pretrain_ckpt")]
    out = serve_decode.main(args + ["--device", "cpu"])
    assert out["served"] == 10 and out["tokens"] == 10 * 12
    assert out["lines"][0].startswith("serving tinyllama-1.1b (smoke config), engine=")
    assert out["lines"][1].startswith("10/10 requests served, 120 tokens, ")
    assert out["lines"][1].endswith(" tok/s on CPU")
    if case == "speculative":
        assert out["stats"]["drafted_tokens"] > 0
        assert any(ln.startswith("  speculative: accept=") for ln in out["lines"])
    if case == "reload":
        assert out["reloads"] >= 1
        assert any(ln.startswith("  reloads: ") for ln in out["lines"])


def test_serve_decode_on_a_1x2_mesh_of_two_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.examples.serve_decode", "--device", "cpu",
           "--mesh", "1x2", "--num-processes", "2", "--coordinator",
           _coordinator(tmp_path, "serve_decode")]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in (0, 1)]
    try:
        outs, errs = zip(*[p.communicate(timeout=240) for p in procs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    one = serve_decode.main(["--device", "cpu"])
    lines = outs[0].splitlines()
    assert lines[0] == one["lines"][0] + ", mesh=1x2"
    # every request served, the page counts of one process, four streams;
    # rank 1 prints nothing.  (The smoke config decodes in bf16, where the
    # split sums may flip a near-tie argmax: the f32 streams are held to one
    # process's in tests/test_torch_tensor_parallel.py.)
    assert lines[1].startswith("10/10 requests served, 120 tokens, ")
    assert lines[2] == one["lines"][2] and lines[2].startswith("  pages: ")
    assert [ln.split(" -> ")[0] for ln in lines[3:]] == \
        [ln.split(" -> ")[0] for ln in one["lines"][3:]]
    assert outs[1].strip() == ""


def test_elastic_restart_main_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = elastic_restart.main(["--device", "cpu"])
    assert out["plain"]["resumed_from"] == 6 and np.isfinite(out["plain"]["loss"])
    v = out["vcycle"]
    assert v["killed_at"] is not None and np.isfinite(v["final_loss"])
    assert any(ln == f"== preempted at global step {v['killed_at']}; restarting fresh =="
               for ln in out["lines"])
    mp = out["multiprocess"]
    assert mp["exit_codes"] == [0, 0], mp["resume_output"]
    steps = {re.search(r"global_step (\d+)", d).group(1) for d in mp["drains"] if d}
    assert len(mp["drains"]) == 2 and all(mp["drains"]) and len(steps) == 1, mp["drains"]
    assert mp["resume_rc"] == 0, mp["resume_output"]
    assert any(ln.startswith("[vcycle] resumed at phase=") for ln in mp["resumed"])
    assert any("total training FLOPs" in ln for ln in mp["resumed"])
    assert mp["final_phase"] == "done"
    for k, d in elastic_restart.ckpt_dirs().items():
        assert d.startswith(str(tmp_path))
