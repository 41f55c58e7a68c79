"""The port's Jamba-1.5-Large (Mamba and attention mixers, dense and MoE
FFNs in one stack), on the CPU, against the reference.

Jamba's smoke config (``_PATTERN[:4]`` twice: Mamba+dense, Mamba+MoE,
Mamba+dense, attention+MoE; d 64, 4 experts top-2) at f32 on both sides:
the port's init (the reference's ``mamba_A`` is 1 ulp off the correctly
rounded log at some entries, ``tests/test_torch_ssm.py``) crosses with
``repro_torch.bridge`` and the same seeded numpy inputs go through both
packages.

- Logits and ``moe_aux`` in train and prefill mode; the loss with
  ``moe_aux`` and every gradient under both remat settings; one AdamW step.
- Prefill, then decode token by token from the self K/V and the Mamba state
  against the forward's logits (the capacity factor raised so that no
  expert drops a routing at any length: the forward and the decode steps
  then route alike).
- Slots streams against the reference's ``Server``; the paged engine's
  refusal in both packages.
- The port's copies of ``tests/test_plans.py``'s ``jamba-1.5-large-398b``
  cases (``:24``, ``:149``, ``:177``), with and without
  ``coalesce_experts``: plans, transitions leaf for leaf against the
  reference's, the expert merge's carried scalars, and the "hybrid" 2-level
  V-cycle against the reference's ``History``.
- ``test_flops_match_reference`` and the full config's parameter count.

Tolerances (those of ``tests/test_torch_train.py``): losses within 1e-5,
parameters and moments after a step within 1e-5, logits within 1e-4;
Adam's ``eps`` is 1e-4 in every stepped case.  Gradients within atol 2e-6
plus ``GRAD_REL`` of the leaf's largest |value|, and metrics within 1e-5 of
max(1, |value|): eight Mamba and MoE layers make the sums larger than in
the dense models.  Measured against a float64 evaluation of the port, the
embedding's gradient (largest value 2.28) sits 7.2e-6 off in the reference
and 9.2e-6 in the port, so the two packages part by 8.1e-6 there; the grad
norm of the stepped case (35.15) parts at 4e-7 of its value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.core import flops as jflops
from repro.core import operators as jops
from repro.core import plans as jplans
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch.bridge import from_reference, opt_state_to_reference, to_reference
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import flops as tflops
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.launch.serve import Request, make_server
from repro_torch.layers.ffn import moe_capacity
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten, tree_map, zeros_tree
from test_torch_speculative import _np, _request_mix, _run

NAME = "jamba-1.5-large-398b"
ML = MultiLevelConfig(n_levels=2)
JML2 = JML(n_levels=2)
SEQ, BATCH = 32, 2
GRAD_REL = 1e-5  # of a leaf's largest |gradient| (module docstring)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the Mamba loop issues many tiny ops, which a
    thread pool per test worker only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """Jamba's smoke config at f32 in both packages."""
    j = jax_get_config(NAME, smoke=True).replace(compute_dtype=jnp.float32, **kw)
    t = get_config(NAME, smoke=True).replace(compute_dtype=torch.float32, **kw)
    return j, t


def _init(tcfg, seed=0):
    """The port's init with the norm scales perturbed: (reference tree,
    port tree)."""
    rng = np.random.default_rng(seed)
    tree = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(seed)), tcfg)

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k == "scale" else v for k, v in t.items()}

    tree = perturb(tree)
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _close_scaled(got, want, atol):
    """Within ``atol * max(1, |want|)`` (scalar metrics)."""
    _close(got, want, atol * max(1.0, abs(float(want))))


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in b.items()}


def _batches(n, batch=BATCH, seq=SEQ):
    chain = JMarkovLM(512)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, batch, seq))
    return [_np(sample(g)) for g in range(n)]


# ---------------------------------------------------------------------------
# the model


def test_logits_and_aux_match_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _init(tcfg, seed=1)
    toks = _batches(1)[0]["tokens"]
    for mode in ("train", "prefill"):
        want = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, mode=mode))(jp, jnp.asarray(toks))
        with torch.no_grad():
            got = tlm.lm_forward(tp, torch.from_numpy(toks.astype(np.int64)), tcfg, mode=mode)
        _close(got["logits"].numpy(), want["logits"], 1e-4)
        _close(got["aux"].item(), want["aux"], 1e-5)
        if mode == "prefill":  # the Mamba state and the attention layer's K/V
            for key, w in flatten(_np(want["caches"])).items():
                _close(flatten(got["caches"])[key].numpy(), w, 1e-5)


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's loss, metrics and gradients on one seeded batch."""
    jcfg, tcfg = _cfgs()
    jp, tp = _init(tcfg)
    batch = _batches(1)[0]
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_build_model(jcfg).loss(p, b), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    return to_reference(tp, tcfg), batch, _np(jm), flatten(_np(jg))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_aux_and_every_gradient_match_the_reference(remat, reference_grads):
    weights, batch, jm, want = reference_grads
    _, tcfg = _cfgs(remat=remat)
    tp = from_reference(weights, tcfg)
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = build_model(tcfg).loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert set(tm) == set(jm) == {"ce", "moe_aux", "loss"}
    for k in jm:
        _close(tm[k].item(), jm[k], 1e-5)
    assert tm["moe_aux"].item() > 0
    assert set(want) == set(flatten(tp))
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6 + GRAD_REL * np.abs(want[key]).max())
    # every block kind's gradient is non-zero: the Mamba mixers, the
    # attention layer and both FFN kinds (routers included)
    for part in ("b0/mixer/A_log", "b1/ffn/router", "b2/ffn/w_up", "b3/mixer/wq"):
        assert np.abs(want[f"stages/stage_0/{part}"]).max() > 0, part


def test_adamw_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _init(tcfg, seed=2)
    kw = dict(steps=6, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
              weight_decay=0.1, eps=1e-4)
    jtc, ttc = JTC(**kw), TrainConfig(**kw)
    batch = _batches(1)[0]
    jp, jopt, jm = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), jax.tree.map(jnp.asarray, batch))
    tp, topt, tm = make_train_step(build_model(tcfg), ttc)(tp, tadamw.adamw_init(tp, ttc),
                                                           _tb(batch))
    for k in ("loss", "moe_aux", "grad_norm"):
        _close_scaled(tm[k].item(), jm[k], 1e-5)
    got = flatten(to_reference(tp, tcfg))
    for key, want in flatten(_np(jp)).items():
        _close(got[key], want, 1e-5)
    opt = opt_state_to_reference(topt, tcfg)
    for part in ("m", "v"):
        got = flatten(opt[part])
        for key, want in flatten(_np(jopt[part])).items():
            _close(got[key], want, 1e-5)


def test_decode_after_prefill_matches_the_forward():
    """Prefill 14 tokens, then decode 6 one at a time from the dense
    caches (the attention layer's K/V, the Mamba layers' conv window and
    state): every step's logits are the reference forward's at that
    position.  The capacity factor is n_experts / top_k, so no routing is
    dropped at any length."""
    jcfg, tcfg = _cfgs(capacity_factor=2.0)
    jp, tp = _init(tcfg, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 20))
    want = np.asarray(jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, mode="train")["logits"])(
        jp, jnp.asarray(toks)))
    t = torch.from_numpy(toks.astype(np.int64))
    P0 = 14
    with torch.inference_mode():
        pre = tlm.lm_forward(tp, t[:, :P0], tcfg, mode="prefill")
        caches = zeros_tree(tlm.cache_specs(tcfg, 2, 24), torch.float32, "cpu")

        def put(c, p):  # K/V rows up to P0; the Mamba state whole
            (c if c.shape == p.shape else c[:, :, :P0]).copy_(p)

        tree_map(put, caches, pre["caches"])
        for i in range(P0, 20):
            out = tlm.lm_forward(tp, t[:, i:i + 1], tcfg, positions=torch.full((2, 1), i),
                                 mode="decode", caches=caches)
            _close(out["logits"][:, 0].numpy(), want[:, i], 1e-4)


# ---------------------------------------------------------------------------
# serving: the slots engine; the paged engine refuses Mamba blocks

SERVE_KW = dict(batch=3, max_seq=48)


def test_slots_streams_match_the_reference():
    jcfg, tcfg = _cfgs()
    reqs = _request_mix(jcfg.vocab_size)
    ref = jax_make_server(jcfg, engine="slots", **SERVE_KW)
    want = _run(ref, reqs, JaxRequest)
    srv = make_server(tcfg, engine="slots", device="cpu", **SERVE_KW)
    srv.set_params(from_reference(_np(ref.params), tcfg))
    assert _run(srv, reqs, Request) == want
    assert sorted(r.rid for r in srv.rejected) == sorted(r.rid for r in ref.rejected) == [99]
    with pytest.raises(NotImplementedError, match="use --engine slots"):
        jax_make_server(jcfg, engine="paged", **SERVE_KW)
    with pytest.raises(NotImplementedError, match="use --engine slots"):
        make_server(tcfg, engine="paged", device="cpu", **SERVE_KW)


# ---------------------------------------------------------------------------
# the plan: tests/test_plans.py's jamba-1.5-large-398b cases

PLAN_CASES = {NAME: {}, NAME + "+experts": dict(coalesce_experts=True)}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_small_cfg_matches_operator_path(name):
    jcfg, cfg = _cfgs(**PLAN_CASES[name])
    plan = plans_lib.build_plan(cfg, ML)
    assert plan.small_cfg == ops.coalesce_config(cfg, ML)
    for ax, n in plan.width_axes.items():
        assert n % 2 == 0 and n >= 2
        assert ax not in plan.protected_axes
    assert plan.hooks == ("dense", "moe", "mamba")
    jp = jplans.build_plan(jcfg, JML2)
    assert plan.describe() == jp.describe()
    assert (plan.hooks, plan.width_axes, plan.protected_axes, plan.role_overrides,
            plan.depth_groups, plan.carried) == \
        (jp.hooks, jp.width_axes, jp.protected_axes, jp.role_overrides, jp.depth_groups,
         jp.carried)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_transitions_match_the_reference(name):
    """C(w) has the small model's shapes and equals the reference's leaf for
    leaf; D(w_small) equals the reference's and C(D(w_small)) == w_small
    (paper Eq. 13); T_out F_out = I and F_in T_in = I for every planned
    width axis; protected axes (conv taps, the Mamba state) keep their
    size, and leaves with no planned axis keep their values."""
    jcfg, cfg = _cfgs(**PLAN_CASES[name])
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML)
    jp, tp = _init(cfg, seed=0)
    jspecs = jax_build_model(jcfg).specs()
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(tp)
    want = {k: tuple(s.shape) for k, s in flatten(build_model(plan.small_cfg).specs()).items()}
    assert {k: tuple(v.shape) for k, v in flatten(co).items()} == want
    ref = flatten(_np(jax.jit(jops.make_coalesce_fn(jspecs, jcfg, JML2))(jp)))
    for k, v in flatten(co).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    js, ts = _init(plan.small_cfg, seed=1)
    de = ops.make_decoalesce_fn(model.specs(), cfg, ML, plan=plan)(ts)
    rt = flatten(ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(de))
    for key, b in flatten(ts).items():
        _close(rt[key].numpy(), b.numpy(), 1e-5)
    ref = flatten(_np(jax.jit(jops.make_decoalesce_fn(jspecs, jcfg, JML2))(js)))
    for k, v in flatten(de).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    maps = plan.build_maps()
    assert {"mamba_inner", "dt_rank", "moe_mlp"} <= set(maps.width)
    for ax, m in maps.width.items():
        n2 = m.F_out.shape[1]
        np.testing.assert_allclose(m.T_out @ m.F_out, np.eye(n2), atol=1e-12, err_msg=ax)
        np.testing.assert_allclose(m.F_in @ m.T_in, np.eye(n2), atol=1e-12, err_msg=ax)
    wplan = plans_lib.build_plan(cfg, ML, depth=False)
    wco = flatten(ops.make_coalesce_fn(model.specs(), cfg, ML, depth=False, plan=wplan)(tp))
    for key, s in flatten(model.specs()).items():
        for i, ax in enumerate(s.axes):
            if ax in wplan.protected_axes:
                assert wco[key].shape[i] == flatten(tp)[key].shape[i], (key, ax)
        if not any(ax in wplan.width_axes for ax in s.axes):
            assert torch.equal(flatten(tp)[key], wco[key]), key
    assert {"conv_k", "mamba_state"} <= set(plan.protected_axes)
    assert ("experts" in plan.protected_axes) == (not cfg.coalesce_experts)


def test_expert_merge_carries_router_scalars():
    """capacity_factor / router_aux_coef carry unchanged and total capacity
    slots are preserved across the expert merge."""
    _, cfg = _cfgs(coalesce_experts=True)
    plan = plans_lib.build_plan(cfg, ML)
    small = plan.small_cfg
    assert plan.carried == {"capacity_factor": cfg.capacity_factor,
                            "router_aux_coef": cfg.router_aux_coef}
    assert (small.capacity_factor, small.router_aux_coef) == (cfg.capacity_factor,
                                                              cfg.router_aux_coef)
    assert small.n_experts == cfg.n_experts // 2
    assert small.moe_top_k == min(cfg.moe_top_k, small.n_experts)
    if small.moe_top_k == cfg.moe_top_k:
        assert moe_capacity(small, 64) * small.n_experts == \
            moe_capacity(cfg, 64) * cfg.n_experts


VC_TC = dict(steps=12, warmup_steps=2, peak_lr=3e-3, batch_size=2, seq_len=16,
             log_every=1, eps=1e-4)


def test_two_level_vcycle_follows_the_reference_history():
    """tests/test_plans.py's "hybrid" case (the ``+experts`` config, 2
    levels), shortened: the History and the final parameters are the
    reference's."""
    jcfg, cfg = _cfgs(coalesce_experts=True)
    batches = _batches(20, batch=2, seq=16)
    init, tp = _init(cfg, seed=0)
    ref = jvc.VCycleRunner(jcfg, JML2, JTC(**VC_TC),
                           lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0).run(
        state=jvc.VCycleState(), params=init)
    got = VCycleRunner(cfg, ML, TrainConfig(**VC_TC), lambda g: _tb(batches[g]),
                       device="cpu").run(state=VCycleState(), params=tp)
    h, w = got.history, ref.history
    assert h.level == w.level and h.step == w.step and 1 in h.level
    np.testing.assert_allclose(h.flops, w.flops, rtol=1e-12)
    np.testing.assert_allclose(h.loss, w.loss, atol=1e-5, rtol=0)
    assert [c.n_experts for c in got.configs] == [4, 2]
    want, final = flatten(_np(ref.params)), flatten(to_reference(got.params, cfg))
    assert final.keys() == want.keys()
    for k in want:
        _close(final[k], want[k], 1e-5)


# ---------------------------------------------------------------------------
# FLOPs and size


def test_flops_match_reference_and_the_full_size():
    jcfg, tcfg = jax_get_config(NAME), get_config(NAME)
    for _ in range(2):  # the level and the level below it
        js, ts = jax_build_model(jcfg).specs(), build_model(tcfg).specs()
        for b, s in [(8, 1024), (2, 256)]:
            assert tflops.train_step_flops(tcfg, ts, b, s) == \
                jflops.train_step_flops(jcfg, js, b, s)
        assert tflops.active_matmul_params(tcfg, ts) == jflops.active_matmul_params(jcfg, js)
        assert tflops.total_params(ts) == jflops.total_params(js)
        jcfg = jplans.build_plan(jcfg, JML()).small_cfg
        tcfg = ops.coalesce_config(tcfg, MultiLevelConfig())
    assert tflops.total_params(build_model(get_config(NAME)).specs()) == 398_555_111_424
