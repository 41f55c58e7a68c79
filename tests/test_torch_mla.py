"""The port's MLA and DeepSeek-V3, on the CPU, against the reference.

``helpers.tiny_mla`` (3 layers, q_lora 32, kv_lora 16, nope 16 + rope 8,
v 16) and DeepSeek-V3's smoke config (one dense layer, two MoE layers with
a shared expert, the MTP head) at f32 on both sides: the same weights cross
with ``repro_torch.bridge`` and the same seeded numpy inputs go through both
packages.

- ``mla_apply``: output and the gradients of ``mean(y * r)`` with respect to
  x and every leaf, on the plain route (S 40) and on the flash route (S 256,
  ``attn_block_k`` 64), where the port runs the flash op's plain versions at
  (Dqk 24, Dv 16), its repaired backward included.
- Absorbed decode after a prefill, against the reference's forward: token
  by token against the dense cache and the paged latent pool, then a
  multi-token paged step (the extend and verify path).
- DeepSeek-V3 smoke: logits, the loss with ``moe_aux`` and ``mtp_ce``, every
  gradient under both remat settings, and one AdamW step.
- The port's copies of ``tests/test_serve.py``'s MLA cases (paged = slots,
  speculative = greedy), each also held to the reference's streams; the
  ``mla`` case of ``tests/test_reload.py``'s reload contract; the
  ``deepseek-v3-671b`` cases of ``tests/test_plans.py`` (with and without
  ``coalesce_experts``), transitions leaf for leaf against the reference's;
  ``tests/test_operators.py``'s halving of the full config.
- A train state (the unstacked ``mtp`` subtree included) saved by either
  package restores in the other bit for bit.
- The 2-level V-cycle on DeepSeek-V3's smoke config against the reference's
  ``History``.

Tolerances (those of ``tests/test_torch_train.py``): losses within 1e-5,
gradients within atol 2e-6, parameters and moments after a step within
1e-5, logits within 1e-4; Adam's ``eps`` is 1e-4 in every stepped case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_mla
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
from repro.layers import attention as jattn
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch import config as tconfig
from repro_torch.bridge import (from_reference, opt_state_from_reference,
                                opt_state_to_reference, to_reference)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.launch.serve import Request, make_server, make_write_prompt
from repro_torch.layers import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model, make_train_step, zero_train_state
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten, tree_map, zeros_tree

NAME = "deepseek-v3-671b"
ML = MultiLevelConfig(n_levels=2)
JML2 = JML(n_levels=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the serving and decode loops issue many tiny
    ops, which a thread pool per test worker only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(j):
    """The port's ModelConfig with the reference config's fields."""
    kw = {}
    for f in dataclasses.fields(j):
        v = getattr(j, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            v = getattr(torch, jnp.dtype(v).name)
        elif f.name == "stages":
            v = tuple(tconfig.Stage(tuple(tconfig.BlockSpec(b.mixer, b.ffn) for b in s.pattern),
                                    s.repeats) for s in v)
        kw[f.name] = v
    return tconfig.ModelConfig(**kw)


def _tiny(**kw):
    """``helpers.tiny_mla`` at f32 in both packages."""
    j = tiny_mla(compute_dtype=jnp.float32, **kw)
    return j, _port_cfg(j)


def _cfgs(**kw):
    """DeepSeek-V3's smoke config at f32 in both packages."""
    j = jax_get_config(NAME, smoke=True).replace(compute_dtype=jnp.float32, **kw)
    t = get_config(NAME, smoke=True).replace(compute_dtype=torch.float32, **kw)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jcfg, tcfg, seed=0):
    """Reference init with the norm scales perturbed; (reference, port)."""
    rng = np.random.default_rng(seed)
    tree = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in ("scale", "q_norm", "kv_norm") else v for k, v in t.items()}

    tree = perturb(tree)
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the layer

LAYER_CASES = {"plain": (40, {}), "flash": (256, dict(attn_impl="blockwise", attn_block_k=64))}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_mla_apply_matches_the_reference(case, monkeypatch):
    S, kw = LAYER_CASES[case]
    jcfg, tcfg = _tiny(**kw)
    B = 2
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     _np(jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
                     ["stages"]["stage_0"]["b0"]["mixer"])
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))

    def jloss(p, x):
        y, _ = jattn.mla_apply(p, x, jcfg, positions=jnp.asarray(pos))
        return jnp.mean(y * r), y

    (jl, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    flash = []
    real = tattn._flash_attention
    monkeypatch.setattr(tattn, "_flash_attention",
                        lambda q, k, v, **a: flash.append((q.shape, v.shape)) or real(q, k, v, **a))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, cache = tattn.mla_apply(tp, tx, tcfg, positions=torch.from_numpy(pos.copy()))
    assert cache is None
    tl = (ty * torch.from_numpy(r)).mean()
    grads = torch.autograd.grad(tl, [tx] + list(flatten(tp).values()))
    _close(ty.detach().numpy(), jy, 1e-5)
    _close(tl.item(), jl, 1e-5)
    _close(grads[0].numpy(), jgx, 2e-6)
    want = flatten(_np(jgp))
    assert list(want) == list(flatten(tp))
    for (key, w), g in zip(want.items(), grads[1:]):
        _close(g.numpy(), w, 2e-6)
    # the flash route at (Dqk 24, Dv 16), KH = H: the plain versions of the
    # flash forward and its backward on the CPU
    assert flash == ([((B, S, 4, 1, 24), (B, S, 4, 16))] if case == "flash" else [])


# ---------------------------------------------------------------------------
# absorbed decode against the forward


@pytest.fixture(scope="module")
def tiny_forward():
    """tiny_mla's weights and the reference's train-mode logits on a seeded
    batch of 2 x 20 tokens."""
    jcfg, tcfg = _tiny()
    jp, tp = _init(jcfg, tcfg, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 20))
    want = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, mode="train")["logits"])(
        jp, jnp.asarray(toks))
    return tcfg, tp, toks, np.asarray(want)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_absorbed_decode_after_prefill_matches_the_forward(layout, tiny_forward):
    """Prefill 12 tokens, decode 5 one at a time against the latent cache,
    then (paged) the last 3 as one multi-token step: every step's logits
    are the reference forward's at those positions."""
    cfg, params, toks, want = tiny_forward
    B, S = toks.shape
    P0, page = 12, 4
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.inference_mode():
        pre = tlm.lm_forward(params, t[:, :P0], cfg, mode="prefill")
        _close(pre["logits"].numpy(), want[:, :P0], 1e-4)
        leaf = pre["caches"]["stage_0"]["b0"]["self"]
        assert set(leaf) == {"ckv", "kpe"} and leaf["ckv"].shape == (3, B, P0, 16)
        if layout == "dense":
            caches = zeros_tree(tlm.cache_specs(cfg, B, 32), torch.float32, "cpu")
            tree_map(lambda c, p: c[:, :, :P0].copy_(p), caches, pre["caches"])
            tables = None
        else:
            M = 32 // page
            caches = zeros_tree(tlm.paged_cache_specs(cfg, 1 + B * M, page), torch.float32,
                                "cpu")
            tables = torch.arange(1, 1 + B * M).view(B, M).flip(1)  # pages out of order
            write = make_write_prompt(page)
            for b in range(B):
                row = tree_map(lambda c: c[:, b:b + 1], pre["caches"])
                write(caches, row, tables[b, :P0 // page])
        last = S - 3 if layout == "paged" else S
        for i in range(P0, last):
            pos = torch.full((B, 1), i)
            out = tlm.lm_forward(params, t[:, i:i + 1], cfg, positions=pos, mode="decode",
                                 caches=caches, block_tables=tables)
            _close(out["logits"][:, 0].numpy(), want[:, i], 1e-4)
        if layout == "paged":
            pos = torch.arange(last, S)[None].expand(B, -1)
            out = tlm.lm_forward(params, t[:, last:], cfg, positions=pos, mode="decode",
                                 caches=caches, block_tables=tables)
            _close(out["logits"].numpy(), want[:, last:], 1e-4)


# ---------------------------------------------------------------------------
# DeepSeek-V3 smoke: the model

SEQ, BATCH = 32, 2


def _batches(n, vocab=512):
    chain = JMarkovLM(vocab)
    return [_np(jax_lm_batch(chain, 0, g, BATCH, SEQ)) for g in range(n)]


def test_logits_match_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _init(jcfg, tcfg, seed=1)
    toks = _batches(1)[0]["tokens"]
    for mode in ("train", "prefill"):
        want = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, mode=mode))(jp, jnp.asarray(toks))
        with torch.no_grad():
            got = tlm.lm_forward(tp, torch.from_numpy(toks.astype(np.int64)), tcfg, mode=mode)
        _close(got["logits"].numpy(), want["logits"], 1e-4)
        _close(got["aux"].item(), want["aux"], 1e-5)
        assert ("mtp_logits" in got) == ("mtp_logits" in want) == (mode == "train")
        if mode == "train":
            _close(got["mtp_logits"].numpy(), want["mtp_logits"], 1e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_mtp_aux_and_every_gradient_match_the_reference(remat):
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
    assert set(tm) == set(jm) == {"ce", "mtp_ce", "moe_aux", "loss"}
    for k in jm:
        _close(tm[k].item(), jm[k], 1e-5)
    assert tm["loss"].item() == pytest.approx(
        tm["ce"].item() + tcfg.mtp_loss_weight * tm["mtp_ce"].item()
        + tcfg.router_aux_coef * tm["moe_aux"].item(), abs=1e-6)
    want = flatten(_np(jg))
    assert any(k.startswith("mtp/") for k in want)
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6)


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
    for k in ("loss", "mtp_ce", "moe_aux", "grad_norm"):
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
# serving: tests/test_serve.py's MLA cases, against the reference's streams

SERVE_KW = dict(batch=2, max_seq=32, page_size=4)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n) for n in (5, 9, 12)]


def _streams(srv, cls, vocab, max_new):
    return {r.rid: r.out for r in srv.run([cls(rid=i, prompt=p, max_new=max_new)
                                           for i, p in enumerate(_prompts(vocab))])}


@pytest.fixture(scope="module")
def reference_mla_streams():
    """The reference's paged greedy streams of ``tests/test_serve.py``'s MLA
    prompts (5 new tokens), and its weights."""
    jcfg, _ = _tiny()
    ref = jax_make_server(jcfg, engine="paged", **SERVE_KW)
    return _np(ref.params), _streams(ref, JaxRequest, jcfg.vocab_size, 5)


def test_paged_matches_slots_mla(reference_mla_streams):
    weights, want = reference_mla_streams
    _, tcfg = _tiny()
    got = {}
    for engine in ("slots", "paged"):
        srv = make_server(tcfg, engine=engine, device="cpu", **SERVE_KW)
        srv.set_params(from_reference(weights, tcfg))
        got[engine] = _streams(srv, Request, tcfg.vocab_size, 5)
    assert got["paged"] == got["slots"] == want


def test_speculative_matches_greedy_mla(reference_mla_streams):
    """The MLA latent pool under the speculative policy (draft_k 3): the
    streams are greedy's, and the reference's speculative server's."""
    weights, greedy = reference_mla_streams
    jcfg, tcfg = _tiny()
    ref = jax_make_server(jcfg, engine="paged", policy="speculative", draft_k=3, **SERVE_KW)
    ref.set_params(jax.tree.map(jnp.asarray, weights))
    assert _streams(ref, JaxRequest, jcfg.vocab_size, 5) == greedy
    srv = make_server(tcfg, engine="paged", policy="speculative", draft_k=3, device="cpu",
                      **SERVE_KW)
    srv.set_params(from_reference(weights, tcfg))
    assert _streams(srv, Request, tcfg.vocab_size, 5) == greedy
    assert srv.stats()["drafted_tokens"] > 0
    assert {k: v for k, v in srv.stats().items() if not k.endswith("_time_s")} == \
        {k: v for k, v in ref.stats().items() if not k.endswith("_time_s")}


def test_deepseek_smoke_paged_streams_match_the_reference():
    """DeepSeek-V3's smoke config (MLA with dense and MoE FFNs) on the paged
    engine: the reference's greedy streams."""
    jcfg, tcfg = _cfgs()
    ref = jax_make_server(jcfg, engine="paged", **SERVE_KW)
    want = _streams(ref, JaxRequest, jcfg.vocab_size, 4)
    srv = make_server(tcfg, engine="paged", device="cpu", **SERVE_KW)
    srv.set_params(from_reference(_np(ref.params), tcfg))
    assert _streams(srv, Request, tcfg.vocab_size, 4) == want


# ---------------------------------------------------------------------------
# reload: the mla case of tests/test_reload.py


def _reqs(vocab, rids, seed, max_new=4):
    rng = np.random.default_rng(seed)
    return [Request(rid=r, prompt=rng.integers(0, vocab, size=int(rng.integers(5, 12))),
                    max_new=max_new) for r in rids]


@pytest.mark.parametrize("engine", ["slots", "paged"])
def test_reload_equivalence_mla(engine):
    """In-flight requests finish under the old weights, admissions after the
    swap stream what a fresh server on the new weights streams, admission is
    gated while a swap is staged, and the paged prefix cache is invalidated."""
    _, cfg = _tiny()
    kw = dict(engine=engine, batch=2, max_seq=48, page_size=8, device="cpu")
    p_new = build_model(cfg).init(torch.Generator().manual_seed(42))
    stream = lambda srv, reqs: {r.rid: r.out for r in srv.run(reqs)}
    V = cfg.vocab_size
    old_oracle = stream(make_server(cfg, **kw), _reqs(V, [0, 1], seed=7))
    new_srv = make_server(cfg, **kw)
    new_srv.set_params(p_new)
    new_oracle = stream(new_srv, _reqs(V, [10, 11], seed=8))

    srv = make_server(cfg, **kw)
    for r in _reqs(V, [0, 1], seed=7):
        assert srv.admit(r)
    srv.step()  # both rows mid-flight
    assert not srv.request_reload(p_new)
    assert srv.reload_pending()
    assert not srv.admit(_reqs(V, [50], seed=9)[0])
    while any(r is not None for r in srv.active):
        srv.step()
    assert srv.reloads == 0
    srv.step()
    assert srv.reloads == 1 and not srv.reload_pending()
    if engine == "paged":
        assert srv.alloc.invalidations_total == 1
    assert {r.rid: r.out for r in srv.done} == old_oracle
    done = stream(srv, _reqs(V, [10, 11], seed=8))
    assert {k: v for k, v in done.items() if k >= 10} == new_oracle


# ---------------------------------------------------------------------------
# checkpoints: the train state, the unstacked ``mtp`` subtree included


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_checkpoint_crosses_the_packages(tmp_path, writer):
    """DeepSeek-V3 smoke's parameters and AdamW state after one step, saved
    by one package and restored by the other, bit for bit."""
    jcfg, tcfg = _cfgs()
    jp, _ = _init(jcfg, tcfg, seed=4)
    jtc = JTC(steps=4, warmup_steps=1, eps=1e-4)
    jp, jopt, _ = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), jax.tree.map(jnp.asarray, _batches(1)[0]))
    jstate = {"params": jp, "opt": jopt}
    if writer == "reference":
        JaxCheckpointManager(str(tmp_path)).save(1, jstate, meta={"step": 1})
        params, opt = zero_train_state(build_model(tcfg), TrainConfig(), device="cpu")
        out, _ = CheckpointManager(str(tmp_path)).restore({"params": params, "opt": opt})
        got = {"params": to_reference(out["params"], tcfg),
               "opt": opt_state_to_reference(out["opt"], tcfg)}
    else:
        CheckpointManager(str(tmp_path)).save(
            1, {"params": from_reference(_np(jp), tcfg),
                "opt": opt_state_from_reference(_np(jopt), tcfg)}, meta={"step": 1})
        got, _ = JaxCheckpointManager(str(tmp_path)).restore(
            jax.tree.map(jnp.zeros_like, jstate))
    got, want = flatten(_np(got)), flatten(_np(jstate))
    assert got.keys() == want.keys() and any(k.startswith("params/mtp/") for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the plan: tests/test_plans.py's deepseek-v3-671b cases

PLAN_CASES = {NAME: {}, NAME + "+experts": dict(coalesce_experts=True)}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_small_cfg_matches_operator_path(name):
    jcfg, cfg = _cfgs(**PLAN_CASES[name])
    plan = plans_lib.build_plan(cfg, ML)
    assert plan.small_cfg == ops.coalesce_config(cfg, ML)
    for ax, n in plan.width_axes.items():
        assert n % 2 == 0 and n >= 2
        assert ax not in plan.protected_axes
    assert {"q_lora", "kv_lora", "embed_cat2"} <= set(plan.width_axes)
    jp = jplans.build_plan(jcfg, JML2)
    assert plan.describe() == jp.describe()
    assert (plan.hooks, plan.width_axes, plan.protected_axes, plan.role_overrides,
            plan.depth_groups, plan.carried) == \
        (jp.hooks, jp.width_axes, jp.protected_axes, jp.role_overrides, jp.depth_groups,
         jp.carried)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_coalesce_and_decoalesce_match_the_reference(name):
    """C(w) has the small model's shapes and equals the reference's leaf for
    leaf (the MTP head's ``embed_cat2`` axis included); D(w_small) equals
    the reference's and C(D(w_small)) == w_small (paper Eq. 13)."""
    jcfg, cfg = _cfgs(**PLAN_CASES[name])
    model = build_model(cfg)
    plan = plans_lib.build_plan(cfg, ML)
    small = build_model(plan.small_cfg)
    jp, tp = _init(jcfg, cfg, seed=0)
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(tp)
    want = {k: tuple(s.shape) for k, s in flatten(small.specs()).items()}
    assert {k: tuple(v.shape) for k, v in flatten(co).items()} == want
    jspecs = jax_build_model(jcfg).specs()
    ref = flatten(_np(jax.jit(jops.make_coalesce_fn(jspecs, jcfg, JML2))(jp)))
    for k, v in flatten(co).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    js, ts = _init(jops.coalesce_config(jcfg, JML2), plan.small_cfg, seed=1)
    de = ops.make_decoalesce_fn(model.specs(), cfg, ML, plan=plan)(ts)
    rt = flatten(ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(de))
    for key, b in flatten(ts).items():
        _close(rt[key].numpy(), b.numpy(), 1e-5)
    ref = flatten(_np(jax.jit(jops.make_decoalesce_fn(jspecs, jcfg, JML2))(js)))
    for k, v in flatten(de).items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_width_maps_are_one_sided_inverses(name):
    """T_out F_out = I and F_in T_in = I for every planned width axis."""
    _, cfg = _cfgs(**PLAN_CASES[name])
    maps = plans_lib.build_plan(cfg, ML).build_maps()
    assert {"q_lora", "kv_lora", "embed_cat2"} <= set(maps.width)
    for ax, m in maps.width.items():
        n2 = m.F_out.shape[1]
        np.testing.assert_allclose(m.T_out @ m.F_out, np.eye(n2), atol=1e-12, err_msg=ax)
        np.testing.assert_allclose(m.F_in @ m.T_in, np.eye(n2), atol=1e-12, err_msg=ax)
    for gname, d in maps.depth.items():
        np.testing.assert_allclose(d.G @ d.R, np.eye(d.R.shape[1]), atol=1e-12, err_msg=gname)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_protected_axes_keep_size_and_values(name):
    """Protected axes never shrink (MLA's head dims among them); leaves with
    only protected or free axes are bit-identical through width-only
    coalescing."""
    jcfg, cfg = _cfgs(**PLAN_CASES[name])
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
    assert ("experts" in plan.protected_axes) == (not cfg.coalesce_experts)
    assert plan.small_cfg.qk_nope_head_dim == cfg.qk_nope_head_dim
    assert plan.small_cfg.v_head_dim == cfg.v_head_dim


def test_coalesce_config_halves_everything():
    """``tests/test_operators.py``'s halving of the full DeepSeek-V3 config."""
    cfg = get_config(NAME)
    small = ops.coalesce_config(cfg, ML)
    assert small.d_model == cfg.d_model // 2
    assert small.n_heads == cfg.n_heads // 2
    assert small.q_lora_rank == cfg.q_lora_rank // 2
    assert small.kv_lora_rank == cfg.kv_lora_rank // 2
    assert small.moe_d_ff == cfg.moe_d_ff // 2
    assert small.n_experts == cfg.n_experts  # experts preserved by default
    assert small.stages[0].repeats == 2  # 3 -> 2 (odd tail)
    assert small.stages[1].repeats == 29  # 58 -> 29
    assert small.resolved_head_dim == cfg.resolved_head_dim  # whole-head merging


# ---------------------------------------------------------------------------
# the V-cycle

VC_TC = dict(steps=12, warmup_steps=2, peak_lr=3e-3, batch_size=2, seq_len=16,
             log_every=1, eps=1e-4)


def test_two_level_vcycle_follows_the_reference_history():
    jcfg, cfg = _cfgs()
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, 2, 16))
    batches = [_np(sample(g)) for g in range(20)]
    init = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    ref = jvc.VCycleRunner(jcfg, JML2, JTC(**VC_TC),
                           lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0).run(
        state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
    runner = VCycleRunner(cfg, ML, TrainConfig(**VC_TC), lambda g: _tb(batches[g]),
                          device="cpu")
    got = runner.run(state=VCycleState(), params=from_reference(init, cfg))
    h, w = got.history, ref.history
    assert h.level == w.level and h.step == w.step and 1 in h.level
    np.testing.assert_allclose(h.flops, w.flops, rtol=1e-12)
    np.testing.assert_allclose(h.loss, w.loss, atol=1e-5, rtol=0)
    assert got.total_flops == ref.total_flops
    assert [c.kv_lora_rank for c in got.configs] == [16, 8]
    want, final = flatten(_np(ref.params)), flatten(to_reference(got.params, cfg))
    assert final.keys() == want.keys()
    for k in want:
        _close(final[k], want[k], 1e-5)
