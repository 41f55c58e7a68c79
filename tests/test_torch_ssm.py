"""The port's recurrent mixers (``layers/ssm.py``: Mamba, mLSTM, sLSTM), on
the CPU, against the reference.

The same weights cross with ``repro_torch.bridge`` and the same seeded numpy
inputs go through both packages, the reference at ``compute_dtype=float32``
and the port at ``torch.float32``.

- Each mixer's output and every parameter gradient (and the input's), on the
  plain loop (``ssm_chunk`` 1), the checkpointed chunks (4 at S 16) and the
  fallback (5: S % 5 != 0).  The sLSTM's first step ties at ``max(n, 1)``.
- Each mixer's prefill state and one decode step from it.
- ``tests/helpers.py``'s ``tiny_xlstm`` and ``tiny_hybrid`` (Mamba beside
  attention) and the xLSTM-125m smoke config: logits, loss and gradients
  under remat none and full, one AdamW step; the port's copy of
  ``tests/test_models.py::test_decode_matches_forward``; slots streams
  equal to the reference's, and the paged engine's refusal.
- The port's copies of ``tests/test_plans.py``'s plan invariants for the
  xLSTM-125m smoke config and ``tiny_hybrid``, transitions leaf for leaf
  against the reference's, and the 2-level "ssm" V-cycle's ``History``.
- The Mamba initialisers: ``mamba_A`` equal to the reference's,
  ``mamba_dt`` from its distribution.

Tolerances (those of ``tests/test_torch_train.py``): losses within 1e-5,
gradients within atol 2e-6, parameters and moments after a step within
1e-5, logits within 1e-4; Adam's ``eps`` is 1e-4.  Looser where the mLSTM
is: the reference's fan-in rule draws the stacked head matrices at std
1/sqrt(first dim) (pinned below), so q, k, v come out ~10x too large, the
mLSTM's outputs reach hundreds and its f32 arithmetic is ill-conditioned
in both packages (their gradients sit equally far, up to 1.7e-4 of a
leaf's largest value, from a float64 evaluation).  Mixer outputs are held
within 1e-5 of ``max(1, max |reference|)``; mLSTM gradients within 1e-5 +
1e-3 of the leaf's largest value (``chip_smoke.py`` phase 6's; the errors
measured reach 0.08 of it for the mixer, 0.05 for ``tiny_xlstm`` and 0.62
for xLSTM-125m's smoke config); the models' gradients the same where an
mLSTM is (``GRAD_TOL``), and their AdamW steps per ``STEP_TOL``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.layers import ssm as jssm
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.param import Spec as JSpec
from repro.param import init_tree as jax_init_tree

from repro_torch import config as tconfig
from repro_torch.bridge import from_reference, opt_state_to_reference, to_reference
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.layers import ssm as tssm
from repro_torch.models import lm as tlm
from repro_torch.models.api import (build_model, make_prefill_step, make_serve_step,
                                    make_train_step)
from repro_torch.optim import adamw as tadamw
from repro_torch.param import Spec, flatten, init_tree, tree_map, unflatten
from helpers import tiny_hybrid, tiny_xlstm
from test_torch_speculative import _np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the recurrent loops issue thousands of tiny ops,
    and with a thread pool each, test workers sharing a host's cores spent
    ~30x longer contending for them than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def torch_cfg(j):
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


CONFIGS = {
    "tiny_xlstm": tiny_xlstm,
    "tiny_hybrid": tiny_hybrid,
    "xlstm-125m": lambda **kw: jax_get_config("xlstm-125m", smoke=True).replace(**kw),
}


def _cfgs(name, **kw):
    """(reference config, port config) at f32 compute."""
    j = CONFIGS[name](compute_dtype=jnp.float32, **kw)
    return j, torch_cfg(j)


def _init(jcfg, tcfg, seed=0):
    """The port's init with the norm scales perturbed, in both packages:
    (reference tree, port tree)."""
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
    """Within ``atol * max(1, max |want|)``."""
    want = np.asarray(want)
    _close(got, want, atol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the initialisers


def test_mamba_A_init_equals_the_reference():
    """log(1..d_state) broadcast: the correctly rounded f32 logs, which the
    reference's XLA ``log`` misses by 1 ulp at some entries (3 of 1..128)."""
    spec = Spec((3, 8, 128), ("layers", "mamba_inner", "mamba_state"), init="mamba_A")
    got = init_tree(torch.Generator().manual_seed(0), {"a": spec})["a"]
    want = np.asarray(jax_init_tree(jax.random.PRNGKey(0), {"a": JSpec(
        spec.shape, spec.axes, init="mamba_A")})["a"])
    assert got.is_contiguous() and got.dtype == torch.float32
    exact = np.log(np.arange(1, 129, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(exact, spec.shape))
    ulps = np.abs(got.numpy().view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 1


def test_mamba_dt_init_follows_the_reference_distribution():
    """softplus(dt) is log-uniform on [1e-3, 1e-1] in both packages: the
    same range, and log10 of it uniform (mean -2, variance 1/3)."""
    shape = (4, 4096)
    spec = Spec(shape, ("layers", "mamba_inner"), init="mamba_dt")
    got = init_tree(torch.Generator().manual_seed(0), {"a": spec})["a"]
    want = np.asarray(jax_init_tree(jax.random.PRNGKey(0), {"a": JSpec(
        shape, spec.axes, init="mamba_dt")})["a"])
    for a in (torch.nn.functional.softplus(got).numpy(),
              np.asarray(jax.nn.softplus(want))):
        lg = np.log10(a)
        assert lg.min() >= -3 - 1e-4 and lg.max() <= -1 + 1e-4
        assert abs(lg.mean() + 2) < 0.02 and abs(lg.var() - 1 / 3) < 0.02
    b = init_tree(torch.Generator().manual_seed(0), {"a": spec})["a"]
    assert torch.equal(got, b)


def test_head_matrices_take_the_reference_fan_in_fallback():
    """The fan_in rule falls back to a leaf's first dim when no dim has role
    "in": the stacked [layers, NH, dh, dh] head matrices (mLSTM wq/wk/wv,
    sLSTM r_*) draw at std 1/sqrt(repeats), not 1/sqrt(dh), in both
    packages (xLSTM-125m: 0.707 where 1/sqrt(dh) is 0.05).  Reproduced on
    purpose; at full width it leaves the model's f32 arithmetic chaotic."""
    cfg = get_config("xlstm-125m")
    specs = build_model(cfg).specs()["stages"]["stage_0"]
    jspecs = jax_build_model(jax_get_config("xlstm-125m")).specs()["stages"]["stage_0"]
    for block, leaf in (("b0", "wq"), ("b3", "r_z")):
        spec, jspec = specs[block]["mixer"][leaf], jspecs[block]["mixer"][leaf]
        assert spec.shape == jspec.shape and spec.roles == jspec.roles
        assert spec.shape[0] == 2 and "in" not in spec.roles
        got = init_tree(torch.Generator().manual_seed(0), {"a": spec})["a"]
        want = np.asarray(jax_init_tree(jax.random.PRNGKey(0), {"a": jspec})["a"])
        for a in (got.numpy(), want):
            assert abs(a.std() * math.sqrt(2) - 1) < 0.01, (block, leaf, a.std())


# ---------------------------------------------------------------------------
# the mixers

MIXER_CFG = {"mamba": "tiny_hybrid", "mlstm": "tiny_xlstm", "slstm": "tiny_xlstm"}
J_MIXERS = {"mamba": (jssm.mamba_specs, jssm.mamba_apply),
            "mlstm": (jssm.mlstm_specs, jssm.mlstm_apply),
            "slstm": (jssm.slstm_specs, jssm.slstm_apply)}


def _mixer_params(mixer, tcfg, seed=1):
    """The port's init of one mixer (numpy), the biases perturbed so every
    gate sees a non-trivial value."""
    rng = np.random.default_rng(seed)
    p = tree_map(lambda t: t.numpy(), init_tree(torch.Generator().manual_seed(seed),
                                                tssm.MIXERS[mixer][0](tcfg)))
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            if k.startswith("b_") or k in ("conv_b", "D") else v for k, v in p.items()}


# gradient tolerance (atol, share of the leaf's largest |value|): the
# mLSTM's gradients move by up to 2.7e-6 of their largest value when the
# reference's weights move by one ulp, so they are held at chip_smoke.py
# phase 6's 1e-5 + 1e-3 of the largest value; Mamba and sLSTM at 2e-6
MIXER_GRAD_TOL = {"mamba": (2e-6, 0.0), "mlstm": (1e-5, 1e-3), "slstm": (2e-6, 0.0)}


MIXER_B, MIXER_S = 2, 16


def _mixer_inputs(mixer, tcfg):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((MIXER_B, MIXER_S, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((MIXER_B, MIXER_S, tcfg.d_model)).astype(np.float32)
    return _mixer_params(mixer, tcfg), x, r


@functools.lru_cache(maxsize=None)
def _reference_mixer(mixer, chunk):
    """The reference's ``mean(y * r)``, y and gradients (numpy).  A chunk
    that does not divide S takes the reference's plain scan, the same
    computation as chunk 1, so it is computed once as chunk 1."""
    if chunk > 1 and MIXER_S % chunk:
        return _reference_mixer(mixer, 1)
    jcfg, tcfg = _cfgs(MIXER_CFG[mixer], ssm_chunk=chunk)
    p, x, r = _mixer_inputs(mixer, tcfg)
    japply = J_MIXERS[mixer][1]

    def jloss(p, x):
        y, _ = japply(p, x, jcfg)
        return jnp.mean(y * r), y

    (jl, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return float(jl), np.asarray(jy), np.asarray(jgx), {k: np.asarray(v) for k, v in jgp.items()}


@pytest.mark.parametrize("chunk", [1, 4, 5], ids=["plain", "chunked", "fallback"])
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_mixer_and_every_gradient_match_the_reference(mixer, chunk):
    _, tcfg = _cfgs(MIXER_CFG[mixer], ssm_chunk=chunk)
    p, x, r = _mixer_inputs(mixer, tcfg)
    jl, jy, jgx, jgp = _reference_mixer(mixer, chunk)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, state = tssm.MIXERS[mixer][2](tp, tx, tcfg)
    assert state is None
    tl = (ty * torch.from_numpy(r)).mean()
    grads = torch.autograd.grad(tl, [tx] + list(tp.values()))
    _close_scaled(ty.detach().numpy(), jy, 1e-5)
    _close(tl.item(), jl, 1e-5)
    atol, rel = MIXER_GRAD_TOL[mixer]
    for g, want in zip(grads, [jgx] + [jgp[key] for key in tp]):
        assert np.abs(want).max() > 0
        _close(g.numpy(), want, atol + rel * np.abs(want).max())


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_prefill_state_and_decode_step_match_the_reference(mixer):
    """Prefill 15 tokens with ``return_state``, then one decode token from
    that state: outputs and every state leaf against the reference's."""
    jcfg, tcfg = _cfgs(MIXER_CFG[mixer], ssm_chunk=5)
    rng = np.random.default_rng(3)
    p = _mixer_params(mixer, tcfg, seed=3)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    japply = J_MIXERS[mixer][1]
    jp = jax.tree.map(jnp.asarray, p)
    jy, jstate = japply(jp, jnp.asarray(x[:, :15]), jcfg, return_state=True)
    jy1, jstate1 = japply(jp, jnp.asarray(x[:, 15:]), jcfg, cache=jstate)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    tapply = tssm.MIXERS[mixer][2]
    with torch.no_grad():
        ty, tstate = tapply(tp, torch.from_numpy(x[:, :15]), tcfg, return_state=True)
        ty1, tstate1 = tapply(tp, torch.from_numpy(x[:, 15:]), tcfg, cache=tstate)
    want_keys = set(tssm.MIXERS[mixer][1](tcfg, 2))
    for got, want in ((tstate, jstate), (tstate1, jstate1)):
        assert set(got) == set(want) == want_keys
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            _close_scaled(got[k].numpy(), want[k], 1e-5)
    _close_scaled(ty.numpy(), jy, 1e-5)
    _close_scaled(ty1.numpy(), jy1, 1e-5)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_f64_compute_keeps_the_state_at_f64(mixer):
    """At compute dtype f64 (never the reference's; ``chip_smoke.py`` phase
    18 holds its equalities there) the states and their cache specs are
    f64, and no f32 rounding is left on the path: prefill 15 tokens plus one
    decode step give the forward over 16 and the prefill's state of 16
    within 1e-12 of max(1, max |value|) (at f32 they differ by ~1e-7)."""
    _, tcfg = _cfgs(MIXER_CFG[mixer], ssm_chunk=4)
    tcfg = tcfg.replace(compute_dtype=torch.float64)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)).double(),
                 _mixer_params(mixer, tcfg, seed=3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, tcfg.d_model)))
    tapply = tssm.MIXERS[mixer][2]
    with torch.no_grad():
        y, state16 = tapply(p, x, tcfg, return_state=True)
        _, state = tapply(p, x[:, :15], tcfg, return_state=True)
        y1, state1 = tapply(p, x[:, 15:], tcfg, cache=state)
    specs = tssm.MIXERS[mixer][1](tcfg, 2)
    assert y.dtype == torch.float64
    for k, spec in specs.items():
        assert state1[k].dtype == state16[k].dtype == (spec.dtype or torch.float64), k
        _close_scaled(state1[k].numpy(), state16[k].numpy(), 1e-12)
    assert all(specs[k].dtype == torch.float64 for k in specs if k != "conv")
    _close_scaled(y1[:, 0].numpy(), y[:, 15].numpy(), 1e-12)


def test_chunked_scan_falls_back_as_the_reference():
    """Chunks only when chunk > 1, S > chunk and S % chunk == 0; equal values
    either way."""
    calls = []

    def step(c, xs):
        calls.append(torch.is_grad_enabled())
        return c + xs[0], c * xs[0]

    x = torch.arange(1.0, 13.0)[:, None]
    want_c, want_y = tssm._scan(step, torch.zeros(1), (x,))
    for chunk in (1, 4, 5, 12, 24):
        c, y = tssm.chunked_scan(step, torch.zeros(1), (x,), chunk)
        assert torch.equal(c, want_c) and torch.equal(y, want_y), chunk
    assert y.shape == (12, 1)


# ---------------------------------------------------------------------------
# the models

MODELS = ["tiny_xlstm", "tiny_hybrid", "xlstm-125m"]
SEQ, BATCH = 16, 2
# gradient tolerance (atol, share of the leaf's largest |value|): the mLSTM
# configs' f32 gradients sit up to 1.7e-4 of the leaf's largest value from a
# float64 evaluation, the reference's as far as the port's, so they are held
# at chip_smoke.py phase 6's 1e-5 + 1e-3 of the largest value
GRAD_TOL = {"tiny_xlstm": (1e-5, 1e-3), "tiny_hybrid": (2e-6, 0.0),
            "xlstm-125m": (1e-5, 1e-3)}


def _batches(n, vocab, seq=SEQ, batch=BATCH):
    chain = JMarkovLM(vocab)
    return [_np(jax_lm_batch(chain, 0, g, batch, seq)) for g in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_model(name):
    """The reference's logits, loss and gradients for ``name`` (ssm_chunk 4)
    on one batch, with the weights (numpy) they came from."""
    jcfg, tcfg = _cfgs(name, ssm_chunk=4)
    jp, _ = _init(jcfg, tcfg)
    batch = _batches(1, jcfg.vocab_size)[0]

    def loss(p, b):
        out = jlm.lm_forward(p, b["tokens"], jcfg, mode="train")
        l, m = jlm.lm_loss(out["logits"], b["labels"], jcfg, out["aux"])
        return l, (m, out["logits"])

    (jl, (jm, logits)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    return _np(jp), batch, float(jl), set(jm), np.asarray(logits), flatten(_np(jg))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_logits_loss_and_every_gradient_match_the_reference(name, remat):
    """ssm_chunk 4: the blocks' checkpointed chunks, inside remat="full"'s
    checkpointed block."""
    weights, batch, jl, jkeys, jlogits, want = _reference_model(name)
    _, tcfg = _cfgs(name, ssm_chunk=4)
    tcfg = tcfg.replace(remat=remat)
    tp = from_reference(weights, tcfg)
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = build_model(tcfg).loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert set(tm) == jkeys == {"ce", "loss"}
    _close(tl.item(), jl, 1e-5)
    assert list(want) == list(flatten(tp))
    atol, rel = GRAD_TOL[name]
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], atol + rel * np.abs(want[key]).max())
    with torch.no_grad():
        got = tlm.lm_forward(tp, torch.from_numpy(batch["tokens"].astype(np.int64)), tcfg)
    _close(got["logits"].numpy(), jlogits, 1e-4)


# after one AdamW step (eps 1e-4): the grad norm's share of its value, the
# parameters' atol, the moments' atol and share of the leaf's largest
# |value|.  An mLSTM config carries its gradients' error into the step: on
# xLSTM-125m's smoke config (grad norm 249 at init) the grad norms 2.3e-4 of
# their value apart, parameters 2.0e-5, every compared leaf within 0.24 of
# these tolerances
STEP_TOL = {"tiny_hybrid": (0.0, 1e-5, 1e-5, 0.0), "xlstm-125m": (1e-3, 1e-4, 1e-5, 2e-3)}


@pytest.mark.parametrize("name", ["tiny_hybrid", "xlstm-125m"])
def test_adamw_step_matches_the_reference(name):
    """The port's ``make_train_step`` against the reference's, which is its
    loss and gradients (``_reference_model``'s, as the test above compares
    them; ssm_chunk 4) followed by its ``adamw_update``."""
    weights, batch, jl, _, _, jg = _reference_model(name)
    _, tcfg = _cfgs(name, ssm_chunk=4)
    kw = dict(steps=6, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
              weight_decay=0.1, eps=1e-4)
    jtc, ttc = JTC(**kw), TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, weights)
    jp, jopt, jm = jax.jit(functools.partial(jadamw.adamw_update, tc=jtc))(
        jp, jax.tree.map(jnp.asarray, unflatten(jg)), jadamw.adamw_init(jp, jtc))
    tp = from_reference(jax.tree.map(np.copy, weights), tcfg)  # updated in place
    tp, topt, tm = make_train_step(build_model(tcfg), ttc)(tp, tadamw.adamw_init(tp, ttc),
                                                           _tb(batch))
    norm_rel, p_atol, m_atol, m_rel = STEP_TOL[name]
    _close(tm["loss"].item(), jl, 1e-5)
    _close(tm["grad_norm"].item(), jm["grad_norm"], 1e-5 + norm_rel * float(jm["grad_norm"]))
    got = flatten(to_reference(tp, tcfg))
    for key, want in flatten(_np(jp)).items():
        _close(got[key], want, p_atol)
    opt = opt_state_to_reference(topt, tcfg)
    for part in ("m", "v"):
        got = flatten(opt[part])
        for key, want in flatten(_np(jopt[part])).items():
            _close(got[key], want, m_atol + m_rel * np.abs(want).max())


@pytest.mark.parametrize("fam", ["xlstm", "hybrid"])
def test_decode_matches_forward(fam):
    """``tests/test_models.py::test_decode_matches_forward`` on the port:
    prefill tokens[:T] then decode position T from the dense caches; the
    logits equal the full forward's at T (the port's own init, the Mamba
    initialisers included)."""
    cfg = torch_cfg({"xlstm": tiny_xlstm, "hybrid": tiny_hybrid}[fam](
        compute_dtype=jnp.float32, capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full = model.forward_logits(params, {"tokens": toks})
    T = S - 1
    lg_pre, caches = make_prefill_step(model)(params, toks[:, :T])
    _close(lg_pre.numpy(), full[:, T - 1].numpy(), 3e-3)

    def grow(buf, spec):  # prefill length T -> max_seq S; states as they are
        out = torch.zeros(spec.shape, dtype=spec.dtype or buf.dtype)
        out[tuple(slice(0, n) for n in buf.shape)] = buf
        return out

    caches = tree_map(grow, caches, tlm.cache_specs(cfg, B, S))
    lg_dec, _ = make_serve_step(model)(params, caches, toks[:, T:T + 1],
                                       torch.full((B,), T, dtype=torch.int64))
    _close(lg_dec.numpy(), full[:, T].numpy(), 3e-3)
