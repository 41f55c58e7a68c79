"""The xLSTM-125m family and the Mamba hybrid on the port's serving and
V-cycle paths, on the CPU, against the reference (the model- and
layer-level parity is in ``tests/test_torch_ssm.py``, whose helpers this
file shares).

- Slots streams of the xLSTM-125m smoke config and ``tests/helpers.py``'s
  ``tiny_hybrid`` equal to the reference's slots engine on the same weights
  (f32); both packages' paged engines refuse recurrent blocks.
- The port's copies of ``tests/test_plans.py:34, 46, 59, 74, 90`` for both
  configs, the transitions leaf for leaf against the reference's.
- The 2-level V-cycle of ``tests/test_plans.py``'s "ssm" case (xLSTM-125m
  smoke, 24 steps) against the reference's ``History``.  From the level-0
  segment after the up-transition on, an f32 xLSTM trace is chaotic: the
  reference started from weights 1 ulp away parts from itself by up to
  0.05 in loss, and so does the port.  The port's losses are held within
  1e-5 plus four times its own distance from a run started 1 ulp away,
  taken as a running maximum over the steps so far, and within 1e-4
  through the level-1 segment and at the first level-0 step after the
  up-transition.  Its parameters straight out of the up-transition and at
  the end are held leaf by leaf within 1e-5 plus four times that leaf's
  distance from the run started 1 ulp away.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.core import operators as jops
from repro.core import plans as jplans
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference, to_reference
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.launch.serve import Request, make_server
from repro_torch.models.api import build_model
from repro_torch.param import flatten
from test_torch_speculative import _np, _request_mix, _run
from test_torch_ssm import _cfgs, _close, _init, _tb, one_thread  # noqa: F401 (autouse)

ML = MultiLevelConfig(n_levels=2)
JML2 = JML(n_levels=2)


# ---------------------------------------------------------------------------
# serving: the slots engine; the paged engine refuses recurrent blocks

SERVE_KW = dict(batch=3, max_seq=48)


@pytest.mark.parametrize("name", ["xlstm-125m", "tiny_hybrid"])
def test_slots_streams_match_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    reqs = _request_mix(jcfg.vocab_size)
    ref = jax_make_server(jcfg, engine="slots", **SERVE_KW)
    want = _run(ref, reqs, JaxRequest)
    srv = make_server(tcfg, engine="slots", device="cpu", **SERVE_KW)
    srv.set_params(from_reference(_np(ref.params), tcfg))
    assert _run(srv, reqs, Request) == want
    assert sorted(r.rid for r in srv.rejected) == sorted(r.rid for r in ref.rejected) == [99]
    for pkg_make in (jax_make_server, lambda c, **kw: make_server(c, device="cpu", **kw)):
        with pytest.raises(NotImplementedError, match="use --engine slots"):
            pkg_make(jcfg if pkg_make is jax_make_server else tcfg, engine="paged",
                     **SERVE_KW)


# ---------------------------------------------------------------------------
# the plan: the port's copies of tests/test_plans.py for these families

PLAN_CASES = ["xlstm-125m", "tiny_hybrid"]


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_small_cfg_matches_operator_path(name):
    jcfg, cfg = _cfgs(name)
    plan = plans_lib.build_plan(cfg, ML)
    assert plan.small_cfg == ops.coalesce_config(cfg, ML)
    for ax, n in plan.width_axes.items():
        assert n % 2 == 0 and n >= 2
        assert ax not in plan.protected_axes
    jp = jplans.build_plan(jcfg, JML2)
    assert plan.describe() == jp.describe()
    assert (plan.hooks, plan.width_axes, plan.protected_axes, plan.role_overrides,
            plan.depth_groups, plan.carried) == \
        (jp.hooks, jp.width_axes, jp.protected_axes, jp.role_overrides, jp.depth_groups,
         jp.carried)
    if name == "xlstm-125m":  # whole heads merge; the per-head memories are protected
        assert plan.small_cfg.n_heads == cfg.n_heads // 2
        assert {"xlstm_head", "slstm_head"} <= set(plan.protected_axes)
    else:
        assert {"mamba_inner", "dt_rank"} <= set(plan.width_axes)
        assert {"conv_k", "mamba_state"} <= set(plan.protected_axes)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_coalesce_shapes_match_small_model(name):
    jcfg, cfg = _cfgs(name)
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML)
    small = build_model(plan.small_cfg)
    jp, tp = _init(jcfg, cfg, seed=0)
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(tp)
    want = {k: tuple(s.shape) for k, s in flatten(small.specs()).items()}
    assert {k: tuple(v.shape) for k, v in flatten(co).items()} == want
    jco = jax.jit(jops.make_coalesce_fn(jax_build_model(jcfg).specs(), jcfg, JML2))(jp)
    ref = flatten(_np(jco))
    for k, v in flatten(co).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_cd_identity(name):
    """C(D(w_small)) == w_small under the plan's maps (paper Eq. 13), and
    D(w_small) equals the reference's leaf for leaf."""
    jcfg, cfg = _cfgs(name)
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML)
    jsmall = jops.coalesce_config(jcfg, JML2)
    js, ts = _init(jsmall, plan.small_cfg, seed=1)
    de = ops.make_decoalesce_fn(model.specs(), cfg, ML, plan=plan)(ts)
    rt = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(de)
    for key, b in flatten(ts).items():
        _close(flatten(rt)[key].numpy(), b.numpy(), 1e-5)
    jde = jax.jit(jops.make_decoalesce_fn(jax_build_model(jcfg).specs(), jcfg, JML2))(js)
    ref = flatten(_np(jde))
    for k, v in flatten(de).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_width_maps_are_one_sided_inverses(name):
    """T_out F_out = I and F_in T_in = I for every planned width axis."""
    _, cfg = _cfgs(name)
    maps = plans_lib.build_plan(cfg, ML).build_maps()
    assert maps.width
    for ax, m in maps.width.items():
        n2 = m.F_out.shape[1]
        np.testing.assert_allclose(m.T_out @ m.F_out, np.eye(n2), atol=1e-12, err_msg=ax)
        np.testing.assert_allclose(m.F_in @ m.T_in, np.eye(n2), atol=1e-12, err_msg=ax)
    for gname, d in maps.depth.items():
        np.testing.assert_allclose(d.G @ d.R, np.eye(d.R.shape[1]), atol=1e-12, err_msg=gname)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_protected_axes_keep_size_and_values(name):
    """Protected axes never shrink; leaves with only protected or free axes
    are bit-identical through width-only coalescing."""
    jcfg, cfg = _cfgs(name)
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML, depth=False)
    _, params = _init(jcfg, cfg, seed=2)
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, depth=False, plan=plan)(params)
    flat_p, flat_c = flatten(params), flatten(co)
    for key, s in flatten(model.specs()).items():
        p, c = flat_p[key], flat_c[key]
        for i, ax in enumerate(s.axes):
            if ax in plan.protected_axes:
                assert c.shape[i] == p.shape[i], (key, ax)
        if not any(ax in plan.width_axes for ax in s.axes):
            assert torch.equal(p, c), key


# ---------------------------------------------------------------------------
# the V-cycle (tests/test_plans.py's "ssm" case)

VC_TC = dict(steps=24, warmup_steps=3, peak_lr=3e-3, batch_size=4, seq_len=16,
             log_every=1, eps=1e-4)


def test_two_level_vcycle_follows_the_reference_history():
    jcfg, cfg = _cfgs("xlstm-125m")
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, 4, 16))
    batches = [_np(sample(g)) for g in range(40)]
    init = to_reference(build_model(cfg).init(torch.Generator().manual_seed(0)), cfg)
    ups = {"ref": [], "port": []}  # each run's tree straight out of the up-transition

    class RefRunner(jvc.VCycleRunner):
        def _transition(self, state, plan, params):
            out = super()._transition(state, plan, params)
            if plan.phase == "up":
                ups["ref"].append(flatten(from_reference(jax.tree.map(np.asarray, out), cfg)))
            return out

    class PortRunner(VCycleRunner):
        def _transition(self, state, plan, params):
            out = super()._transition(state, plan, params)
            if plan.phase == "up":
                ups["port"].append({k: v.detach().clone() for k, v in flatten(out).items()})
            return out

    ref = RefRunner(jcfg, JML2, JTC(**VC_TC),
                    lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0).run(
        state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))

    def port(params):
        runner = PortRunner(cfg, ML, TrainConfig(**VC_TC), lambda g: _tb(batches[g]),
                            device="cpu")
        return runner.run(state=VCycleState(), params=from_reference(params, cfg))

    out = port(init)
    # the trace's own sensitivity: every matrix one ulp up
    nudged = port(jax.tree.map(
        lambda a: np.nextafter(a, np.float32(np.inf)) if a.ndim >= 2 else a, init))
    h, w = out.history, ref.history
    assert h.level == w.level and h.step == w.step
    assert 1 in h.level and h.level[0] == 0 and h.level[-1] == 0
    np.testing.assert_allclose(h.flops, w.flops, rtol=1e-12)
    assert out.total_flops == ref.total_flops
    assert [c.n_heads for c in out.configs] == [4, 2]
    band = np.maximum.accumulate(np.abs(np.asarray(nudged.history.loss) - np.asarray(h.loss)))
    gap = np.abs(np.asarray(h.loss) - np.asarray(w.loss))
    assert (gap <= 1e-5 + 4 * band).all(), (gap, band)
    first, up = h.level.index(1), h.level.index(1) + h.level.count(1)
    assert gap[first:up].max() <= 1e-4  # the level-1 segment
    assert gap[up] <= 1e-4  # the first level-0 step after the up-transition
    # leaf by leaf, straight out of the up-transition and at the end: within
    # 1e-5 + 4x the port's own distance from the nudged run in that leaf
    (got, moved), (want,) = ups["port"], ups["ref"]  # the port: its run, the nudged one
    final = flatten(from_reference(jax.tree.map(np.asarray, ref.params), cfg))
    for a, b, c in ((got, want, moved), (flatten(out.params), final, flatten(nudged.params))):
        assert a.keys() == b.keys()
        for k, v in a.items():
            tol = 1e-5 + 4 * (v - c[k]).abs().max().item()
            assert (v - b[k]).abs().max().item() <= tol, k
    assert np.isfinite(h.loss).all() and np.mean(h.loss[-3:]) < np.mean(h.loss[:3])
