"""The port's Mixture-of-Experts family, on the CPU, against the reference.

Phi-3.5-MoE's smoke config (d 64, 4 experts top-2, expert width 96, 2
layers) at f32 on both sides: the same weights cross with
``repro_torch.bridge`` and the same seeded numpy inputs go through both
packages.

- ``moe_apply``: output, aux loss, and the gradients of ``mean(y * r) +
  aux`` with respect to x and every leaf; with a shared expert, with a
  capacity factor at which tokens drop, and with a zeroed router (all
  probabilities equal: the reference's ``top_k`` routes every token to
  experts 0..k-1, and so must the port).
- The whole model: logits, ``lm_loss`` with ``moe_aux``, gradients under
  both remat settings, and one AdamW step.
- The port's copies of ``tests/test_plans.py``'s plan invariants for the
  config and its ``+experts`` (``coalesce_experts``) variant, the router
  pin and the carried scalars, plus the transitions leaf for leaf against
  the reference's.
- The 2-level V-cycle of ``tests/test_plans.py``'s ``"moe"`` case against
  the reference's ``History``.
- Paged greedy, slots and speculative streams (draft with
  ``coalesce_experts``) equal to the reference's, warm-prefix requests
  through the padded extend step included; the speculative ``stats()``
  equal but for the two host-time fields.
- A mid-V-cycle checkpoint of a Phi smoke V-cycle written by either package
  resumes in the other on the reference's trace.

Tolerances (those of ``tests/test_torch_train.py``): losses within 1e-5,
gradients within atol 2e-6, parameters and moments after a step within
1e-5, logits within 1e-4; Adam's ``eps`` is 1e-4 in every stepped case (at
1e-8 a gradient element that is zero up to rounding moves its weight by up
to ``lr`` either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.core import operators as jops
from repro.core import plans as jplans
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.launch.train import make_vcycle_save_cb as jax_make_vcycle_save_cb
from repro.launch.train import restore_vcycle_state as jax_restore_vcycle_state
from repro.layers import ffn as jffn
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch.bridge import from_reference, opt_state_to_reference, to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.launch.serve import Request, make_server
from repro_torch.launch.train import make_vcycle_save_cb, restore_vcycle_state
from repro_torch.layers import ffn as tffn
from repro_torch.layers.ffn import moe_capacity
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten, tree_map
from test_torch_speculative import TIMES, _np, _request_mix, _run
from test_torch_speculative import one_thread  # noqa: F401 (autouse)

NAME = "phi3.5-moe-42b-a6.6b"
ML = MultiLevelConfig(n_levels=2)
JML2 = JML(n_levels=2)


def _cfgs(**kw):
    """The Phi smoke config at f32 in both packages."""
    j = jax_get_config(NAME, smoke=True).replace(compute_dtype=jnp.float32, **kw)
    t = get_config(NAME, smoke=True).replace(compute_dtype=torch.float32, **kw)
    return j, t


def _init(jcfg, tcfg, seed=0):
    """Reference init with the norm scales perturbed; (reference, port)."""
    rng = np.random.default_rng(seed)
    tree = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k == "scale" else v for k, v in t.items()}

    tree = perturb(tree)
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the layer

LAYER_CASES = {
    "phi-smoke": (dict(), None),
    "shared-expert": (dict(n_shared_experts=1), None),
    "dropping": (dict(capacity_factor=0.5), None),
    "zero-router": (dict(), "zero-router"),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_apply_matches_the_reference(case):
    kw, special = LAYER_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    B, S = 2, 40
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     _np(jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
                     ["stages"]["stage_0"]["b0"]["ffn"])
    if special == "zero-router":
        p["router"] = np.zeros_like(p["router"])
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jffn.moe_apply(p, x, jcfg)
        return jnp.mean(y * r) + aux, (y, aux)

    (jl, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    with tffn.count_dropped() as tally:
        ty, taux = tffn.moe_apply(tp, tx, tcfg)
    tl = (ty * torch.from_numpy(r)).mean() + taux
    leaves = list(flatten(tp).values())
    grads = torch.autograd.grad(tl, [tx] + leaves)
    _close(ty.detach().numpy(), jy, 1e-5)
    _close(taux.item(), jaux, 1e-5)
    _close(tl.item(), jl, 1e-5)
    _close(grads[0].numpy(), jgx, 2e-6)
    want = flatten(_np(jgp))
    assert list(want) == list(flatten(tp))
    for (key, w), g in zip(want.items(), grads[1:]):
        _close(g.numpy(), w, 2e-6)
    C = moe_capacity(tcfg, S)
    dropped, routed = tally.counts()["step"]
    assert routed == B * S * tcfg.moe_top_k
    if special == "zero-router":
        # every token to experts 0 and 1: each keeps C of S tokens per row
        assert taux.item() == pytest.approx(1.0)
        assert dropped == B * tcfg.moe_top_k * (S - C)
        assert np.abs(jgp["router"]).max() > 0  # the tie still routes gradient
    elif case == "dropping":
        assert C == 10 and dropped > 0
    else:
        assert C == 25


def test_moe_capacity_matches_the_reference():
    jcfg, tcfg = _cfgs()
    for S in (1, 7, 16, 40, 64, 1024):
        for cf in (0.5, 1.0, 1.25, 2.0):
            assert moe_capacity(tcfg.replace(capacity_factor=cf), S) == \
                jffn.moe_capacity(jcfg.replace(capacity_factor=cf), S)
    assert moe_capacity(tcfg, 1) == 4  # a decode row: C = 4 >= k


# ---------------------------------------------------------------------------
# the model

SEQ, BATCH = 32, 2


def _batches(n, vocab=512):
    chain = JMarkovLM(vocab)
    return [_np(jax_lm_batch(chain, 0, g, BATCH, SEQ)) for g in range(n)]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_aux_and_every_gradient_match_the_reference(remat):
    jcfg, tcfg = _cfgs()
    tcfg = tcfg.replace(remat=remat)
    jp, tp = _init(jcfg, tcfg)
    batch = _batches(1)[0]
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = tmodel.loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert set(tm) == set(jm) == {"ce", "moe_aux", "loss"}
    for k in jm:
        _close(tm[k].item(), jm[k], 1e-5)
    assert tm["loss"].item() == pytest.approx(
        tm["ce"].item() + tcfg.router_aux_coef * tm["moe_aux"].item(), abs=1e-6)
    want = flatten(_np(jg))
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6)


def test_logits_match_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _init(jcfg, tcfg, seed=1)
    toks = _batches(1)[0]["tokens"]
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    for mode in ("train", "prefill"):
        want = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, mode=mode))(jp, jnp.asarray(toks))
        with torch.no_grad():
            got = tlm.lm_forward(tp, torch.from_numpy(toks.astype(np.int64)), tcfg, mode=mode)
        _close(got["logits"].numpy(), want["logits"], 1e-4)
        _close(got["aux"].item(), want["aux"], 1e-5)


def test_adamw_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _init(jcfg, tcfg, seed=2)
    kw = dict(steps=6, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
              weight_decay=0.1, eps=1e-4)
    jtc, ttc = JTC(**kw), TrainConfig(**kw)
    batch = _batches(1)[0]
    jp, jopt, jm = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), jax.tree.map(jnp.asarray, batch))
    tp, topt, tm = make_train_step(build_model(tcfg), ttc)(tp, tadamw.adamw_init(tp, ttc),
                                                           _tb(batch))
    for k in ("loss", "moe_aux", "grad_norm"):
        _close(tm[k].item(), jm[k], 1e-5)
    got = flatten(to_reference(tp, tcfg))
    for key, want in flatten(_np(jp)).items():
        _close(got[key], want, 1e-5)
    opt = opt_state_to_reference(topt, tcfg)
    for part in ("m", "v"):
        got = flatten(opt[part])
        for key, want in flatten(_np(jopt[part])).items():
            _close(got[key], want, 1e-5)


# ---------------------------------------------------------------------------
# the plan: the port's copies of tests/test_plans.py for this family

PLAN_CASES = {NAME: {}, NAME + "+experts": dict(coalesce_experts=True)}


def _plan_pair(name, **kw):
    return _cfgs(**PLAN_CASES[name], **kw)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_small_cfg_matches_operator_path(name):
    jcfg, cfg = _plan_pair(name)
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


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_coalesce_shapes_match_small_model(name):
    jcfg, cfg = _plan_pair(name)
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML)
    small = build_model(plan.small_cfg)
    jp, tp = _init(jcfg, cfg, seed=0)
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(tp)
    want = {k: tuple(s.shape) for k, s in flatten(small.specs()).items()}
    assert {k: tuple(v.shape) for k, v in flatten(co).items()} == want
    # the transition itself, leaf for leaf against the reference's
    jco = jax.jit(jops.make_coalesce_fn(jax_build_model(jcfg).specs(), jcfg, JML2))(jp)
    ref = flatten(_np(jco))
    for k, v in flatten(co).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_cd_identity(name):
    """C(D(w_small)) == w_small under the plan's maps (paper Eq. 13), and
    D(w_small) equals the reference's leaf for leaf."""
    jcfg, cfg = _plan_pair(name)
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


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_width_maps_are_one_sided_inverses(name):
    """T_out F_out = I and F_in T_in = I for every planned width axis."""
    _, cfg = _plan_pair(name)
    maps = plans_lib.build_plan(cfg, ML).build_maps()
    assert maps.width
    if cfg.coalesce_experts:
        assert "experts" in maps.width
    for ax, m in maps.width.items():
        n2 = m.F_out.shape[1]
        np.testing.assert_allclose(m.T_out @ m.F_out, np.eye(n2), atol=1e-12, err_msg=ax)
        np.testing.assert_allclose(m.F_in @ m.T_in, np.eye(n2), atol=1e-12, err_msg=ax)
    for gname, d in maps.depth.items():
        np.testing.assert_allclose(d.G @ d.R, np.eye(d.R.shape[1]), atol=1e-12, err_msg=gname)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_protected_axes_keep_size_and_values(name):
    """Protected axes never shrink; leaves with only protected or free axes
    are bit-identical through width-only coalescing."""
    jcfg, cfg = _plan_pair(name)
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
    # without coalesce_experts the expert count is protected
    assert ("experts" in plan.protected_axes) == (not cfg.coalesce_experts)


def test_expert_merge_router_pin():
    """With coalesce_experts, the merged router column j is the pair-average
    of columns (j, j + X/2) after the embed rows pair-sum ("stack" maps)."""
    jcfg, cfg = _plan_pair(NAME + "+experts")
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML, depth=False)
    assert plan.role_overrides.get("experts") == "out"
    _, params = _init(jcfg, cfg, seed=3)
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, depth=False, plan=plan)(params)
    w = params["stages"]["stage_0"]["b0"]["ffn"]["router"].numpy()
    w2 = co["stages"]["stage_0"]["b0"]["ffn"]["router"].numpy()
    E, X = w.shape[-2], w.shape[-1]
    a = w[..., : E // 2, :] + w[..., E // 2:, :]
    want = 0.5 * (a[..., :, : X // 2] + a[..., :, X // 2:])
    np.testing.assert_allclose(w2, want, atol=1e-5)


def test_expert_merge_carries_router_scalars():
    """capacity_factor / router_aux_coef carry unchanged and total capacity
    slots are preserved across the expert merge."""
    _, cfg = _plan_pair(NAME + "+experts")
    plan = plans_lib.build_plan(cfg, ML)
    small = plan.small_cfg
    assert plan.carried == {"capacity_factor": cfg.capacity_factor,
                            "router_aux_coef": cfg.router_aux_coef}
    assert small.capacity_factor == cfg.capacity_factor
    assert small.router_aux_coef == cfg.router_aux_coef
    assert small.n_experts == cfg.n_experts // 2
    assert small.moe_top_k == min(cfg.moe_top_k, small.n_experts)
    if small.moe_top_k == cfg.moe_top_k:
        seq = 64
        assert moe_capacity(small, seq) * small.n_experts == \
            moe_capacity(cfg, seq) * cfg.n_experts


# ---------------------------------------------------------------------------
# the V-cycle (tests/test_plans.py's "moe" case)

VC_TC = dict(steps=24, warmup_steps=3, peak_lr=3e-3, batch_size=4, seq_len=16,
             log_every=1, eps=1e-4)


@pytest.fixture(scope="module")
def reference_vcycle():
    """``tests/test_plans.py``'s "moe" case (the ``+experts`` config, 2
    levels, 24 steps) run by the reference on its own batches: (reference
    config, port config, batches, initial weights, the reference's
    ``VCycleOutput``); the checkpoint tests resume against it too."""
    jcfg, cfg = _plan_pair(NAME + "+experts")
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, 4, 16))
    batches = [_np(sample(g)) for g in range(40)]
    init = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    ref = jvc.VCycleRunner(jcfg, JML2, JTC(**VC_TC),
                           lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0).run(
        state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
    return jcfg, cfg, batches, init, ref


def _follows(out, ref, final):
    """``out``'s History and final parameters (numpy) are the reference's."""
    h, w = out.history, ref.history
    assert h.level == w.level and h.step == w.step
    np.testing.assert_allclose(h.flops, w.flops, rtol=1e-12)
    np.testing.assert_allclose(h.loss, w.loss, atol=1e-5, rtol=0)
    assert out.total_flops == ref.total_flops
    want, got = flatten(_np(ref.params)), flatten(final)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_two_level_vcycle_follows_the_reference_history(reference_vcycle):
    jcfg, cfg, batches, init, ref = reference_vcycle
    runner = VCycleRunner(cfg, ML, TrainConfig(**VC_TC), lambda g: _tb(batches[g]),
                          device="cpu")
    got = runner.run(state=VCycleState(), params=from_reference(init, cfg))
    _follows(got, ref, to_reference(got.params, cfg))
    h = got.history
    assert 1 in h.level and h.level[0] == 0 and h.level[-1] == 0
    assert [c.n_experts for c in got.configs] == [4, 2]
    assert np.mean(h.loss[-3:]) < np.mean(h.loss[:3])


# ---------------------------------------------------------------------------
# serving: paged greedy, slots and speculative streams against the reference

SERVE_KW = dict(batch=3, max_seq=48, page_size=8)


@pytest.fixture(scope="module")
def reference_paged():
    """The reference's paged greedy streams on the request mix (prefix reuse
    on: the shared-prefix cohort runs the padded extend step), its weights."""
    jcfg, _ = _cfgs()
    ref = jax_make_server(jcfg, engine="paged", **SERVE_KW)
    streams = _run(ref, _request_mix(jcfg.vocab_size), JaxRequest)
    assert ref.prefill_tokens_saved > 0
    return _np(ref.params), streams, [r.rid for r in ref.rejected]


@pytest.mark.parametrize("engine", ["paged", "slots"])
def test_greedy_streams_match_the_reference(engine, reference_paged):
    weights, want, rejected = reference_paged
    _, tcfg = _cfgs()
    srv = make_server(tcfg, engine=engine, device="cpu", **SERVE_KW)
    srv.set_params(from_reference(weights, tcfg))
    with tffn.count_dropped() as tally:
        assert _run(srv, _request_mix(tcfg.vocab_size), Request) == want
    assert sorted(r.rid for r in srv.rejected) == rejected == [99]
    if engine == "paged":
        # the extend step's left padding (token 0 at position -1) is routed
        # and takes capacity, as in the reference
        assert srv.prefill_tokens_saved > 0
    assert set(tally.counts()) == {"step"}


def test_speculative_streams_and_stats_match_the_reference(reference_paged):
    """Draft: the level-1 coalescing with ``coalesce_experts`` (2 experts,
    top-2, half width and depth); streams equal greedy's and the
    reference's speculative server's, stats too but the host times."""
    weights, greedy, _ = reference_paged
    jcfg, tcfg = _cfgs(coalesce_experts=True)
    reqs = _request_mix(jcfg.vocab_size)
    ref = jax_make_server(jcfg, engine="paged", policy="speculative", draft_k=3, **SERVE_KW)
    ref.set_params(jax.tree.map(jnp.asarray, weights))
    want = _run(ref, reqs, JaxRequest)
    assert want == greedy
    srv = make_server(tcfg, engine="paged", policy="speculative", draft_k=3, device="cpu",
                      **SERVE_KW)
    srv.set_params(from_reference(weights, tcfg))
    assert srv.policy.draft_cfg.n_experts == 2
    assert _run(srv, reqs, Request) == want
    st, rst = srv.stats(), ref.stats()
    drop = lambda s: {k: v for k, v in s.items() if k not in TIMES}
    assert drop(st) == drop(rst) and set(TIMES) <= set(st)
    assert st["drafted_tokens"] > 0


# ---------------------------------------------------------------------------
# a Phi smoke V-cycle checkpoint crossing both packages


class Preempted(RuntimeError):
    pass


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_vcycle_checkpoint_crosses_the_packages(tmp_path, writer, reference_vcycle):
    """Killed after the save at global step 6 (the upward sweep, level 1)
    by one package, resumed by the other: the ``History`` and the final
    parameters follow the reference's uninterrupted run."""
    jcfg, cfg, batches, init, ref = reference_vcycle
    jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
    jtc, tc = JTC(**VC_TC), TrainConfig(**VC_TC)
    jrunner = jvc.VCycleRunner(jcfg, JML2, jtc, jbf, seed=0)
    runner = VCycleRunner(cfg, ML, tc, lambda g: _tb(batches[g]), device="cpu")
    if writer == "reference":
        cm = JaxCheckpointManager(str(tmp_path))
        save_cb = jax_make_vcycle_save_cb(cm, schedule=jrunner.plan)
        kill, start = jrunner, dict(state=jvc.VCycleState(),
                                    params=jax.tree.map(jnp.asarray, init))
    else:
        cm = CheckpointManager(str(tmp_path))
        save_cb = make_vcycle_save_cb(cm, schedule=runner.plan)
        kill, start = runner, dict(state=VCycleState(), params=from_reference(init, cfg))

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state)
        if state.global_step == 6:
            raise Preempted

    with pytest.raises(Preempted):
        kill.run(ckpt_cb=killing_cb, ckpt_every=2, **start)
    cm.wait()
    if writer == "reference":
        state, params, opt = restore_vcycle_state(CheckpointManager(str(tmp_path)), runner, tc)
        resumer = runner
    else:
        state, params, opt = jax_restore_vcycle_state(JaxCheckpointManager(str(tmp_path)),
                                                      jrunner, jtc)
        resumer = jrunner
    # E_a = 1 step at level 0, so step 6 is the fifth of level 1's twelve
    assert (state.phase, state.level, state.global_step, state.seg_step) == ("up", 1, 6, 5)
    assert list(state.params_before) == [0] and int(opt["count"]) == 5
    out = resumer.run(state=state, params=params, opt_state=opt)
    _follows(out, ref, to_reference(out.params, cfg) if writer == "reference"
             else _np(out.params))
