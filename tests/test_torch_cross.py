"""The port's cross-attention families, on the CPU, against the reference:
Llama-3.2-Vision's gated image layers (``cross_attn``) and Whisper's
encoder-decoder (an ``enc_attn`` encoder stack, ``dec_attn`` decoder
blocks).

Both smoke configs at f32 on both sides: the reference's init, norm scales
and biases perturbed and every ``gate`` set to 0.5 (at its zero init the
image layers add exactly 0 and their projections get no gradient, which
would hide any fault in them), crosses with ``repro_torch.bridge``; the
image embeddings and encoder frames are seeded random numpy (the launchers'
ones would make every attention row uniform and hide a wrong K/V order).

- ``pos_embed_specs`` and the cross-attention specs against the
  reference's.
- ``cross_attn_apply``: output and the gradients with respect to the
  stream, the source and every leaf, S != T, GQA 4/2, a source wider than
  d_model, on the plain route and on the flash route (S 160, T 200,
  ``attn_block_k`` 64: the flash op's plain versions, non-causal); decode
  from the precomputed cross cache.
- The default init's zero gate: exact zeros in both packages.
- For each smoke config: logits (and Whisper's ``enc_out``), the loss and
  every gradient (the ``encoder`` leaves included) under both remat
  settings, also on the flash route (encoder frames or image tokens 200,
  sequence 160); one AdamW step; prefill then decode from the self and
  cross caches against the forward; slots streams against the reference's
  ``Server``, and the paged engine's refusal.
- The port's copies of ``tests/test_plans.py``'s cases for both configs
  (plans, transitions leaf for leaf against the reference's), and
  ``test_flops_match_reference`` for both full configs.
- A Whisper train state saved by either package restores in the other bit
  for bit.
- The 2-level V-cycle against the reference's ``History``.  The reference's
  V-cycle feeds level 0's encoder frames, d_model wide, to the coalesced
  level, which cannot take them; the port coalesces them to the level's
  width (``core/vcycle.py::coalesce_frames``), and the reference run here
  is given the same frames through a subclass.

Tolerances (those of ``tests/test_torch_train.py``): losses within 1e-5,
parameters and moments after a step within 1e-5, logits within 1e-4;
Adam's ``eps`` is 1e-4 in every stepped case.  Gradients within atol 2e-6
plus ``GRAD_REL`` of the leaf's largest |value|, metrics within 1e-5 of
max(1, |value|): the random image embeddings give gradients of several
units (the gate's: 94 at a 0.5 gate), where an f32 sum's rounding alone is
above 2e-6.  Measured against a float64 evaluation of the port on the VLM's
flash case, the embedding's gradient (largest value 1.24) sits 6.7e-6 of
that value off in the reference and 4.4e-6 in the port.
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
from repro.core import flops as jflops
from repro.core import operators as jops
from repro.core import plans as jplans
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.layers import attention as jattn
from repro.layers import basic as jbasic
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch.bridge import (from_reference, opt_state_from_reference,
                                opt_state_to_reference, to_reference)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import flops as tflops
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core.vcycle import VCycleRunner, VCycleState, coalesce_frames
from repro_torch.launch.serve import Request, make_server
from repro_torch.layers import attention as tattn
from repro_torch.layers import basic as tbasic
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model, make_train_step, zero_train_state
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten, tree_map, zeros_tree
from test_torch_speculative import _np, _request_mix, _run

WHISPER, VLM = "whisper-large-v3", "llama-3.2-vision-11b"
NAMES = [WHISPER, VLM]
ML = MultiLevelConfig(n_levels=2)
JML2 = JML(n_levels=2)
SEQ, BATCH = 24, 2
FLASH = dict(attn_impl="blockwise", attn_block_k=64)
GRAD_REL = 1e-5  # of a leaf's largest |gradient| (module docstring)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the serving loops issue many tiny ops, which a
    thread pool per test worker only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """A smoke config at f32 in both packages."""
    j = jax_get_config(name, smoke=True).replace(compute_dtype=jnp.float32, **kw)
    t = get_config(name, smoke=True).replace(compute_dtype=torch.float32, **kw)
    return j, t


def _perturb(tree, rng, gate=0.5):
    """Norm scales and biases moved off their init; every gate at ``gate``."""
    def rec(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = rec(v)
            elif k == "gate":
                out[k] = np.full_like(v, gate)
            elif k in ("scale", "bias") or k.startswith("b") and k[1:] in ("q", "k", "v", "o"):
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return rec(tree)


def _init(jcfg, tcfg, seed=0, gate=0.5):
    """(reference tree, port tree) of the reference's init, perturbed."""
    tree = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    tree = _perturb(tree, np.random.default_rng(seed), gate)
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _close_scaled(got, want, atol):
    """Within ``atol * max(1, |want|)`` (scalar metrics)."""
    _close(got, want, atol * max(1.0, abs(float(want))))


def _close_grad(got, want):
    want = np.asarray(want)
    _close(got, want, 2e-6 + GRAD_REL * float(np.abs(want).max(initial=0.0)))


def _extras(cfg, batch, seed):
    """Seeded random stub-frontend inputs (numpy, f32)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"img_embeds": rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)}
    return {"enc_frames": rng.standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _batches(jcfg, n, batch=BATCH, seq=SEQ):
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, batch, seq))
    return [dict(_np(sample(g)), **_extras(jcfg, batch, 100 + g)) for g in range(n)]


def _tb(b):
    return {k: torch.from_numpy(v if v.dtype == np.float32 else v.astype(np.int64))
            for k, v in b.items()}


def _jb(b):
    return jax.tree.map(jnp.asarray, b)


# ---------------------------------------------------------------------------
# the layer


def test_specs_match_the_reference():
    jcfg, tcfg = _cfgs(VLM)
    for args in [(), ("vision_embed", 48)]:
        for jl, tl in zip(jattn.cross_attn_specs(jcfg, *args).items(),
                          tattn.cross_attn_specs(tcfg, *args).items()):
            assert jl[0] == tl[0]
            assert (jl[1].shape, jl[1].axes, jl[1].roles, jl[1].init) == \
                (tl[1].shape, tl[1].axes, tl[1].roles, tl[1].init)
    j, t = jbasic.pos_embed_specs(448, jcfg)["pos"], tbasic.pos_embed_specs(448, tcfg)["pos"]
    assert (j.shape, j.axes, j.roles, j.init, j.scale) == (t.shape, t.axes, t.roles, t.init,
                                                            t.scale)
    j = jattn.cross_kv_cache_specs(jcfg, 3, 9)["ck"]
    t = tattn.cross_kv_cache_specs(tcfg, 3, 9)["ck"]
    assert (j.shape, j.axes) == (t.shape, t.axes)


LAYER_CASES = {"plain": (40, 24, {}), "flash": (160, 200, FLASH)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_cross_attn_apply_matches_the_reference(case, monkeypatch):
    S, T, kw = LAYER_CASES[case]
    jcfg, tcfg = _cfgs(VLM, vision_dim=48, **kw)
    B, E = 2, jcfg.d_model
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in jattn.cross_attn_specs(jcfg, "vision_embed", 48).items()}
    p["gate"] = np.full((1,), 0.5, np.float32)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    src = rng.standard_normal((B, T, 48)).astype(np.float32)
    r = rng.standard_normal((B, S, E)).astype(np.float32)

    def jloss(p, x, src):
        y = jattn.cross_attn_apply(p, x, jcfg, kv_src=src, gated=True)
        return jnp.mean(y * r), y

    (jl, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        _jb(p), jnp.asarray(x), jnp.asarray(src))
    flash = []
    real = tattn._flash_attention
    monkeypatch.setattr(tattn, "_flash_attention",
                        lambda q, k, v, **a: flash.append((q.shape, k.shape, a["causal"]))
                        or real(q, k, v, **a))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    tx, tsrc = (torch.from_numpy(a).requires_grad_() for a in (x, src))
    ty = tattn.cross_attn_apply(tp, tx, tcfg, kv_src=tsrc, gated=True)
    tl = (ty * torch.from_numpy(r)).mean()
    grads = torch.autograd.grad(tl, [tx, tsrc] + list(tp.values()))
    _close(ty.detach().numpy(), jy, 1e-5)
    _close(tl.item(), jl, 1e-5)
    _close_grad(grads[0].numpy(), jg[1])
    _close_grad(grads[1].numpy(), jg[2])
    for (k, _), g in zip(tp.items(), grads[2:]):
        _close_grad(g.numpy(), jg[0][k])
    assert flash == ([((B, S, 2, 2, 16), (B, T, 2, 16), False)] if case == "flash" else [])
    # decode: the same queries against the precomputed cross cache
    with torch.no_grad():
        cache = tattn.cross_attn_precompute(tp, tsrc, tcfg)
        y_dec = tattn.cross_attn_apply(tp, tx[:, -1:], tcfg, kv_cache=cache, gated=True)
    _close(y_dec.numpy(), jy[:, -1:], 1e-5)
    jcache = jattn.cross_attn_precompute(_jb(p), jnp.asarray(src), jcfg)
    _close(cache["ck"].numpy(), jcache["ck"], 1e-5)


def test_default_gate_is_an_exact_zero():
    """At the zero-init gate, the image layers add exactly 0 and their
    projections get exactly zero gradient in both packages; only the gate's
    own gradient is non-zero, and equal."""
    jcfg, tcfg = _cfgs(VLM)
    jp, tp = _init(jcfg, tcfg, seed=4, gate=0.0)
    batch = _batches(jcfg, 1)[0]
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_build_model(jcfg).loss(p, b), has_aux=True))(jp, _jb(batch))
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = build_model(tcfg).loss(tp, _tb(batch))
    tg = dict(zip(flatten(tp), torch.autograd.grad(tl, leaves)))
    want = flatten(_np(jg))
    image = "stages/stage_0/b0/mixer/"
    for leaf in ("wq", "wk", "wv", "wo"):
        assert np.all(want[image + leaf] == 0) and torch.all(tg[image + leaf] == 0), leaf
    assert np.abs(want[image + "gate"]).max() > 0
    _close_grad(tg[image + "gate"].numpy(), want[image + "gate"])
    with torch.no_grad():
        h = torch.randn(2, 5, tcfg.d_model)
        y = tattn.cross_attn_apply(tree_map(lambda a: a[0], tp["stages"]["stage_0"]["b0"]
                                            ["mixer"]), h, tcfg,
                                   kv_src=_tb(batch)["img_embeds"], gated=True)
    assert torch.all(y == 0)


# ---------------------------------------------------------------------------
# the models


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _init(jcfg, tcfg, seed=1)
    b = _batches(jcfg, 1)[0]
    ex = {k: v for k, v in b.items() if k in ("img_embeds", "enc_frames")}
    for mode in ("train", "prefill"):
        want = jax.jit(lambda p, t, e: jlm.lm_forward(p, t, jcfg, mode=mode, **e))(
            jp, jnp.asarray(b["tokens"]), _jb(ex))
        with torch.no_grad():
            got = tlm.lm_forward(tp, torch.from_numpy(b["tokens"].astype(np.int64)), tcfg,
                                 mode=mode, **{k: torch.from_numpy(v) for k, v in ex.items()})
        _close(got["logits"].numpy(), want["logits"], 1e-4)
        assert (got["enc_out"] is None) == (want["enc_out"] is None) == (name == VLM)
        if name == WHISPER:
            _close(got["enc_out"].numpy(), want["enc_out"], 1e-5)
        if mode == "prefill":  # self and cross K/V of every layer
            for key, w in flatten(_np(want["caches"])).items():
                _close(flatten(got["caches"])[key].numpy(), w, 1e-5)


GRAD_CASES = {f"{n}-{c}": (n, c) for n in NAMES for c in ("none", "full", "flash")}


def _grad_cfg_kw(name, case):
    """remat "none"/"full" at the smoke sizes; "flash": sequence 160 and a
    source of 200 (frames or image tokens) past ``attn_block_k`` 64, remat
    "full"."""
    if case != "flash":
        return dict(remat=case), SEQ
    src = dict(encoder_seq=200) if name == WHISPER else dict(n_image_tokens=200)
    return dict(FLASH, remat="full", **src), 160


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_every_gradient_match_the_reference(case, monkeypatch):
    name, route = GRAD_CASES[case]
    kw, seq = _grad_cfg_kw(name, route)
    jcfg, tcfg = _cfgs(name, **kw)
    jp, tp = _init(jcfg, tcfg, seed=2)
    batch = _batches(jcfg, 1, seq=seq)[0]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_build_model(jcfg).loss(p, b), has_aux=True))(jp, _jb(batch))
    flash = []
    real = tattn._flash_attention
    monkeypatch.setattr(tattn, "_flash_attention",
                        lambda q, k, v, **a: flash.append((q.shape[1], k.shape[1]))
                        or real(q, k, v, **a))
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = build_model(tcfg).loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves, materialize_grads=True)
    assert set(tm) == set(jm) == {"ce", "loss"}
    for k in jm:
        _close(tm[k].item(), jm[k], 1e-5)
    want = flatten(_np(jg))
    assert set(want) == set(flatten(tp))
    assert any(k.startswith("encoder/") for k in want) == (name == WHISPER)
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close_grad(g.numpy(), want[key])
    for key in want:  # the encoder and the cross projections learn
        if key.startswith("encoder/") and key.endswith("wq") or key.endswith("cross/wk"):
            assert np.abs(want[key]).max() > 0, key
    if route == "flash":  # the forward of every attention that passes the thresholds
        T = 200
        want_calls = ({(seq, seq), (seq, T), (T, T)} if name == WHISPER
                      else {(seq, seq), (seq, T)})
        assert set(flash) == want_calls
    else:
        assert not flash


@pytest.mark.parametrize("name", NAMES)
def test_adamw_step_matches_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _init(jcfg, tcfg, seed=3)
    kw = dict(steps=6, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
              weight_decay=0.1, eps=1e-4)
    jtc, ttc = JTC(**kw), TrainConfig(**kw)
    batch = _batches(jcfg, 1)[0]
    jp, jopt, jm = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), _jb(batch))
    tp, topt, tm = make_train_step(build_model(tcfg), ttc)(tp, tadamw.adamw_init(tp, ttc),
                                                           _tb(batch))
    for k in ("loss", "grad_norm"):
        _close_scaled(tm[k].item(), jm[k], 1e-5)
    got = flatten(to_reference(tp, tcfg))
    for key, want in flatten(_np(jp)).items():
        _close(got[key], want, 1e-5)
    opt = opt_state_to_reference(topt, tcfg)
    for part in ("m", "v"):
        got = flatten(opt[part])
        for key, want in flatten(_np(jopt[part])).items():
            _close(got[key], want, 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_decode_after_prefill_matches_the_forward(name):
    """Prefill 14 tokens with the source, then decode 6 one at a time from
    the dense caches (self K/V, and the cross K/V the prefill projected;
    no source is given to decode): every step's logits are the reference
    forward's at that position."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _init(jcfg, tcfg, seed=5)
    b = _batches(jcfg, 1, seq=20)[0]
    ex = {k: v for k, v in b.items() if k in ("img_embeds", "enc_frames")}
    want = np.asarray(jax.jit(lambda p, t, e: jlm.lm_forward(p, t, jcfg, mode="train",
                                                             **e)["logits"])(
        jp, jnp.asarray(b["tokens"]), _jb(ex)))
    t = torch.from_numpy(b["tokens"].astype(np.int64))
    P0 = 14
    with torch.inference_mode():
        pre = tlm.lm_forward(tp, t[:, :P0], tcfg, mode="prefill",
                             **{k: torch.from_numpy(v) for k, v in ex.items()})
        caches = zeros_tree(tlm.cache_specs(tcfg, 2, 24), torch.float32, "cpu")

        def put(c, p):  # self K/V rows up to P0; the cross K/V whole
            (c if c.shape == p.shape else c[:, :, :P0]).copy_(p)

        tree_map(put, caches, pre["caches"])
        for i in range(P0, 20):
            out = tlm.lm_forward(tp, t[:, i:i + 1], tcfg, positions=torch.full((2, 1), i),
                                 mode="decode", caches=caches)
            assert out["enc_out"] is None
            _close(out["logits"][:, 0].numpy(), want[:, i], 1e-4)


SERVE_KW = dict(batch=3, max_seq=48)


@pytest.mark.parametrize("name", NAMES)
def test_slots_streams_match_the_reference(name):
    """Both servers prefill with the stub frontends' ones, as their
    launchers do; the paged engine refuses cross-attention blocks."""
    jcfg, tcfg = _cfgs(name)
    reqs = _request_mix(jcfg.vocab_size)
    ref = jax_make_server(jcfg, engine="slots", **SERVE_KW)
    ref.set_params(jax.tree.map(jnp.asarray, _perturb(_np(ref.params),
                                                      np.random.default_rng(6))))
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
# the plans: tests/test_plans.py's cases for both configs


@pytest.mark.parametrize("name", NAMES)
def test_plan_and_transitions_match_the_reference(name):
    """The plan equals the reference's (the encoder's depth group, the
    pinned ``vision_dim``); C(w) has the small model's shapes and equals the
    reference's leaf for leaf; D(w_small) equals the reference's and
    C(D(w_small)) == w_small; T_out F_out = I and F_in T_in = I."""
    jcfg, cfg = _cfgs(name)
    plan = plans_lib.build_plan(cfg, ML)
    jplan = jplans.build_plan(jcfg, JML2)
    assert plan.small_cfg == ops.coalesce_config(cfg, ML)
    assert plan.describe() == jplan.describe()
    assert (plan.hooks, plan.width_axes, plan.protected_axes, plan.role_overrides,
            plan.depth_groups, plan.carried) == \
        (jplan.hooks, jplan.width_axes, jplan.protected_axes, jplan.role_overrides,
         jplan.depth_groups, jplan.carried)
    if name == WHISPER:
        assert "encoder" in plan.hooks and plan.depth_groups["encoder"] == (2, 1)
        assert plan.small_cfg.n_encoder_layers == 1
    else:
        assert "vision_adapter" in plan.hooks and plan.small_cfg.vision_dim == cfg.vision_dim
    model = build_model(cfg)
    jp, tp = _init(jcfg, cfg, seed=0)
    jspecs = jax_build_model(jcfg).specs()
    co = ops.make_coalesce_fn(model.specs(), cfg, ML, plan=plan)(tp)
    want = {k: tuple(s.shape) for k, s in flatten(build_model(plan.small_cfg).specs()).items()}
    assert {k: tuple(v.shape) for k, v in flatten(co).items()} == want
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
    for ax, m in plan.build_maps().width.items():
        n2 = m.F_out.shape[1]
        np.testing.assert_allclose(m.T_out @ m.F_out, np.eye(n2), atol=1e-12, err_msg=ax)
        np.testing.assert_allclose(m.F_in @ m.T_in, np.eye(n2), atol=1e-12, err_msg=ax)


@pytest.mark.parametrize("name", NAMES)
def test_flops_match_reference(name):
    """The cross-attention and encoder terms of the FLOPs account."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    for _ in range(2):  # the level and the level below it
        js, ts = jax_build_model(jcfg).specs(), build_model(tcfg).specs()
        for b, s in [(8, 1024), (4, 448)]:
            assert tflops.train_step_flops(tcfg, ts, b, s) == \
                jflops.train_step_flops(jcfg, js, b, s)
        assert tflops.active_matmul_params(tcfg, ts) == jflops.active_matmul_params(jcfg, js)
        assert tflops.total_params(ts) == jflops.total_params(js)
        jcfg = jplans.build_plan(jcfg, JML()).small_cfg
        tcfg = ops.coalesce_config(tcfg, MultiLevelConfig())


# ---------------------------------------------------------------------------
# checkpoints: the encoder subtree crosses both ways


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_checkpoint_crosses_the_packages(tmp_path, writer):
    """Whisper smoke's parameters and AdamW state after one step, saved by
    one package and restored by the other, bit for bit."""
    jcfg, tcfg = _cfgs(WHISPER)
    jp, _ = _init(jcfg, tcfg, seed=4)
    jtc = JTC(steps=4, warmup_steps=1, eps=1e-4)
    jp, jopt, _ = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), _jb(_batches(jcfg, 1)[0]))
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
    assert got.keys() == want.keys() and any(k.startswith("params/encoder/") for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the V-cycle

VC_TC = dict(steps=12, warmup_steps=2, peak_lr=3e-3, batch_size=2, seq_len=16,
             log_every=1, eps=1e-4)


class _FramesFittedRunner(jvc.VCycleRunner):
    """The reference's runner with each level's encoder frames coalesced to
    its width, as the port's runner does (the reference feeds level 0's)."""

    def step_fn(self, level):
        fn = super().step_fn(level)
        width, variant = self.cfgs[level].d_model, self.ml.width_variant
        if not level or not self.cfgs[level].n_encoder_layers:
            return fn

        def fitted(params, opt_state, batch, *rest):
            f = torch.from_numpy(np.array(batch["enc_frames"]))
            batch = dict(batch, enc_frames=jnp.asarray(coalesce_frames(f, width,
                                                                       variant).numpy()))
            return fn(params, opt_state, batch, *rest)

        return fitted


def test_coalesce_frames_averages_the_variant_pairs():
    f = torch.arange(16.0).view(1, 2, 8)
    assert torch.equal(coalesce_frames(f, 4), 0.5 * (f[..., :4] + f[..., 4:]))
    assert torch.equal(coalesce_frames(f, 4, "adj"), 0.5 * (f[..., 0::2] + f[..., 1::2]))
    assert torch.equal(coalesce_frames(torch.ones(2, 3, 8), 2), torch.ones(2, 3, 2))
    assert coalesce_frames(f, 8) is f
    with pytest.raises(ValueError):
        coalesce_frames(f, 3)


@pytest.mark.parametrize("name", NAMES)
def test_two_level_vcycle_follows_the_reference_history(name):
    jcfg, cfg = _cfgs(name)
    batches = _batches(jcfg, 20, batch=2, seq=16)
    init, tp = _init(jcfg, cfg, seed=0)
    runner_cls = _FramesFittedRunner if name == WHISPER else jvc.VCycleRunner
    ref = runner_cls(jcfg, JML2, JTC(**VC_TC), lambda g: _jb(batches[g]), seed=0).run(
        state=jvc.VCycleState(), params=init)
    got = VCycleRunner(cfg, ML, TrainConfig(**VC_TC), lambda g: _tb(batches[g]),
                       device="cpu").run(state=VCycleState(), params=tp)
    h, w = got.history, ref.history
    assert h.level == w.level and h.step == w.step and 1 in h.level
    np.testing.assert_allclose(h.flops, w.flops, rtol=1e-12)
    np.testing.assert_allclose(h.loss, w.loss, atol=1e-5, rtol=0)
    assert got.total_flops == ref.total_flops
    want, final = flatten(_np(ref.params)), flatten(to_reference(got.params, cfg))
    assert final.keys() == want.keys()
    for k in want:
        _close(final[k], want[k], 1e-5)
