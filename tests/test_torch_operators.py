"""The port's projection plans and operators against the JAX reference, on
the CPU, at f32.

* ``build_plan(...).describe()``, ``small_cfg`` and every matrix of
  ``build_maps()`` equal the reference's for every config the port carries,
  under both width and depth variants and the single-direction plans.
* ``coalesce``/``decoalesce``/``interpolate`` equal the reference leaf for
  leaf, exactly (the stack-variant contractions are one add and a
  power-of-two scale, the dense ones multiply by 0, 0.5 and 1 only), with
  the fused kernels and with the dense matrices; interpolate within one
  rounding (the reference fuses into an FMA).
* ``C(D(w)) == w`` for width-only transitions, and the tied-embedding 2x
  logit scale after width de-coalescing (DESIGN.md §4) is reproduced.
* A single-direction coalescing shares no storage with its input, so the
  in-place train step of the small model leaves the V-cycle's stash as it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.configs import get_config as jax_get_config
from repro.configs import paper_models as jpm
from repro.core import operators as jops
from repro.core import plans as jplans
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference
from repro_torch.config import MultiLevelConfig as TML
from repro_torch.config import TrainConfig as TTC
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as tpm
from repro_torch.core import operators as tops
from repro_torch.core import plans as tplans
from repro_torch.data import MarkovLM, lm_batch
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.param import flatten

CONFIGS = ["tinyllama-1.1b", "tinyllama-smoke", "gpt-base", "bert-base", "bert-large",
           "deit-b", "gpt-proxy", "bert-proxy", "deit-proxy"]
FULL_SIZE = {"tinyllama-1.1b", "gpt-base", "bert-base", "bert-large", "deit-b"}
VARIANTS = [dict(), dict(width_variant="adj", depth_variant="stack")]
DIRECTIONS = [(True, True), (True, False), (False, True)]


def _pair(name):
    """(reference config, port config) of one name."""
    if name == "tinyllama-smoke":
        return jax_get_config("tinyllama-1.1b", smoke=True), get_config("tinyllama-1.1b",
                                                                        smoke=True)
    if name.endswith("-proxy"):
        fn = name.split("-")[0] + "_proxy"
        return getattr(jpm, fn)(), getattr(tpm, fn)()
    return jax_get_config(name), get_config(name)


def _same_cfg(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif f.name == "stages":
            assert [(s.repeats, [(x.mixer, x.ffn) for x in s.pattern]) for s in a] == \
                [(s.repeats, [(x.mixer, x.ffn) for x in s.pattern]) for s in b]
        else:
            assert a == b, f.name


@pytest.mark.parametrize("direction", DIRECTIONS, ids=["both", "width", "depth"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["stack-adj", "adj-stack"])
@pytest.mark.parametrize("name", CONFIGS)
def test_plans_and_maps_equal_the_reference(name, variant, direction):
    jcfg, tcfg = _pair(name)
    width, depth = direction
    jp = jplans.build_plan(jcfg, JML(**variant), width=width, depth=depth)
    tp = tplans.build_plan(tcfg, TML(**variant), width=width, depth=depth)
    assert tp.describe() == jp.describe()
    assert (tp.hooks, tp.width_axes, tp.protected_axes, tp.role_overrides,
            tp.depth_groups, tp.carried, tp.axis_sizes()) == \
        (jp.hooks, jp.width_axes, jp.protected_axes, jp.role_overrides,
         jp.depth_groups, jp.carried, jp.axis_sizes())
    _same_cfg(tp.small_cfg, jp.small_cfg)
    if name in FULL_SIZE and (variant, direction) != (VARIANTS[0], DIRECTIONS[0]):
        return  # full-width maps are dense n x n numpy products: compared once
    jm, tm = jp.build_maps(), tp.build_maps()
    assert set(tm.width) == set(jm.width) and set(tm.depth) == set(jm.depth)
    for ax in jm.width:
        assert tm.width[ax].variant == jm.width[ax].variant
        for f in ("F_out", "F_in", "T_out", "T_in"):
            np.testing.assert_array_equal(getattr(tm.width[ax], f), getattr(jm.width[ax], f))
    for g in jm.depth:
        np.testing.assert_array_equal(tm.depth[g].R, jm.depth[g].R)
        np.testing.assert_array_equal(tm.depth[g].G, jm.depth[g].G)
    t = tm.as_torch("cpu")
    for ax in t.width:
        assert t.width[ax].F_out.dtype == torch.float32


def _dense(n_layers=4, **kw):
    j = jpm.gpt_proxy(d_model=64, n_layers=n_layers, vocab=256).replace(
        compute_dtype=jnp.float32, **kw)
    t = tpm.gpt_proxy(d_model=64, n_layers=n_layers, vocab=256).replace(
        compute_dtype=torch.float32, **kw)
    return j, t


def _init(jcfg, tcfg, seed):
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)  # non-trivial biases and scales
    return tree, from_reference(tree, tcfg)


def _equal_trees(got, want):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for key in want:
        g = got[key].numpy()
        assert g.shape == want[key].shape, key
        np.testing.assert_array_equal(g, want[key], err_msg=key)


def _interpolated(got, want, a, b, alpha):
    """One rounding apart at most: within 1 ulp of the largest of the two
    products and the result (the reference's compiler fuses into an FMA)."""
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    a, b = flatten(a), flatten(b)
    assert set(got) == set(want)
    for key in want:
        x, y = np.asarray(a[key]), b[key].numpy()
        tol = np.spacing(np.maximum.reduce([np.abs((1 - alpha) * x), np.abs(alpha * y),
                                            np.abs(want[key])]).astype(np.float32))
        assert np.all(np.abs(got[key].numpy() - want[key]) <= tol), key


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS, ids=["stack-adj", "adj-stack"])
def test_operators_equal_the_reference_leaf_for_leaf(variant, fused):
    jcfg, tcfg = _dense()
    jml, tml = JML(**variant), TML(**variant)
    jsmall = jops.coalesce_config(jcfg, jml)
    tsmall = tops.coalesce_config(tcfg, tml)
    _same_cfg(tsmall, jsmall)
    jspecs, tspecs = jax_build_model(jcfg).specs(), build_model(tcfg).specs()
    jp, tp = _init(jcfg, tcfg, 0)
    co_j = jax.jit(lambda p: jops.coalesce(p, jspecs, jcfg, jml, fused=fused))(
        jax.tree.map(jnp.asarray, jp))
    co_t = tops.coalesce(tp, tspecs, tcfg, tml, fused=fused)
    _equal_trees(co_t, co_j)
    js, ts = _init(jsmall, tsmall, 1)
    de_j = jax.jit(lambda p: jops.decoalesce(p, jspecs, jcfg, jml, fused=fused))(
        jax.tree.map(jnp.asarray, js))
    de_t = tops.decoalesce(ts, tspecs, tcfg, tml, fused=fused)
    _equal_trees(de_t, de_j)
    _interpolated(tops.interpolate(tp, de_t, 0.25),
                  jax.jit(lambda a, b: jops.interpolate(a, b, 0.25))(
                      jax.tree.map(jnp.asarray, jp), de_j), jp, de_t, 0.25)
    # the make_* builders are the same transitions as plain callables
    _equal_trees(tops.make_coalesce_fn(tspecs, tcfg, tml, fused=fused)(tp), co_j)
    _equal_trees(tops.make_decoalesce_fn(tspecs, tcfg, tml, fused=fused)(ts), de_j)


def test_coalesce_leaves_inputs_untouched_and_returns_contiguous_leaves():
    jcfg, tcfg = _dense()
    _, tp = _init(jcfg, tcfg, 2)
    before = {k: v.clone() for k, v in flatten(tp).items()}
    out = tops.coalesce(tp, build_model(tcfg).specs(), tcfg, TML())
    for k, v in flatten(tp).items():
        assert torch.equal(v, before[k])
    assert all(v.is_contiguous() for v in flatten(out).values())


@pytest.mark.parametrize("direction", DIRECTIONS[1:], ids=["width", "depth"])
def test_single_direction_coalesce_leaves_the_stash_untouched_by_training(direction):
    """Leaves that a width-only or depth-only plan does not project (the
    embedding and final norm under depth-only) come back as copies: a train
    step of the small model, which updates its parameters in place, must
    not write into the pre-coalesce tree the V-cycle keeps for Interpolation."""
    _, tcfg = _dense()
    width, depth = direction
    tml = TML()
    small_cfg = tops.coalesce_config(tcfg, tml, width=width, depth=depth)
    _, tp = _init(*_dense(), 6)
    stash = {k: v.clone() for k, v in flatten(tp).items()}
    small = tops.make_coalesce_fn(build_model(tcfg).specs(), tcfg, tml, width=width,
                                  depth=depth)(tp)
    ptrs = {v.untyped_storage().data_ptr() for v in flatten(tp).values()}
    assert not ptrs & {v.untyped_storage().data_ptr() for v in flatten(small).values()}
    tc = TTC(steps=2, warmup_steps=1, batch_size=2, seq_len=16)
    batch = lm_batch(MarkovLM(small_cfg.vocab_size), 0, 0, 2, 16, device="cpu")
    make_train_step(build_model(small_cfg), tc)(small, adamw_init(small, tc), batch)
    for k, v in flatten(tp).items():
        assert torch.equal(v, stash[k]), k


@pytest.mark.parametrize("tie", [True, False])
def test_width_round_trip_is_exact(tie):
    """C(D(w)) == w bit for bit for a width-only transition."""
    jcfg, tcfg = _dense(tie_embeddings=tie)
    tml = TML()
    small = tops.coalesce_config(tcfg, tml, width=True, depth=False)
    specs = build_model(tcfg).specs()
    ps = build_model(small).init(torch.Generator().manual_seed(3))
    de = tops.make_decoalesce_fn(specs, tcfg, tml, width=True, depth=False)(ps)
    back = tops.make_coalesce_fn(specs, tcfg, tml, width=True, depth=False)(de)
    for key, leaf in flatten(ps).items():
        assert torch.equal(flatten(back)[key], leaf), key


def test_tied_embedding_logits_double_after_width_decoalescing():
    """The pinned 2x logit scale of the reference (tests/test_operators.py,
    DESIGN.md §4): tied embeddings de-coalesce to twice the small model's
    logits; untied ones preserve them."""
    for tie, factor in ((True, 2.0), (False, 1.0)):
        _, tcfg = _dense(n_layers=2, tie_embeddings=tie)
        tml = TML()
        small_cfg = tops.coalesce_config(tcfg, tml, width=True, depth=False)
        small, model = build_model(small_cfg), build_model(tcfg)
        ps = small.init(torch.Generator().manual_seed(4))
        pl = tops.make_decoalesce_fn(model.specs(), tcfg, tml, width=True, depth=False)(ps)
        toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 16)))
        with torch.no_grad():
            lg_small = small.forward_logits(ps, {"tokens": toks})
            lg_large = model.forward_logits(pl, {"tokens": toks})
        np.testing.assert_allclose(lg_large.numpy(), factor * lg_small.numpy(),
                                   atol=2e-4, rtol=2e-4)
