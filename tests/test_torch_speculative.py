"""The port's speculative decode policy, on the CPU, against the reference.

Port copies of the speculative cases of ``tests/test_serve.py`` and
``tests/test_reload.py``: the coalesced level-1 draft may be arbitrarily
wrong (random weights, or a draft sabotaged to disagree on the first token
of every round) and the emitted streams must still equal greedy decode's,
with rejected positions rewound through the allocator's rollback.  Each case
also runs the reference's ``SpeculativePolicy`` on the same weights (moved
across with ``repro_torch.bridge``) and the same numpy prompts, and requires
the same streams and the same ``stats()`` but for the two host-time fields.
``make_draft_projection`` is held leaf for leaf to the reference's.  All at
f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_dense
from repro.config import MultiLevelConfig as JML
from repro.core import operators as jops
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SpeculativePolicy as JaxSpeculativePolicy
from repro.launch.serve import make_server as jax_make_server
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference
from repro_torch.config import BlockSpec, ModelConfig, MultiLevelConfig, uniform_stages
from repro_torch.core import operators as ops
from repro_torch.launch.serve import Request, SpeculativePolicy, make_server
from repro_torch.models.api import build_model
from repro_torch.param import flatten


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: under the suite's six workers the tiny models'
    thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMES = ("draft_time_s", "verify_time_s")


def _cfgs(**kw):
    """``helpers.tiny_dense(compute_dtype=float32, **kw)`` in both packages
    (shared with ``tests/test_torch_slots.py``, as are ``_np``,
    ``_request_mix`` and ``_run``)."""
    base = dict(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=256, stages=uniform_stages(3, BlockSpec("attn", "dense")),
                qk_norm=True, remat="none", attn_impl="plain", compute_dtype=torch.float32)
    base.update(kw)
    return tiny_dense(compute_dtype=jnp.float32, **kw), ModelConfig(**base)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _request_mix(vocab, seed=1):
    """``tests/test_serve.py::_request_mix``: mixed lengths, a shared-prefix
    cohort and one oversized prompt, as (rid, prompt, max_new)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=20)
    reqs = [(i, rng.integers(0, vocab, size=int(rng.integers(4, 14))), 6) for i in range(5)]
    for i in range(5, 8):
        reqs.append((i, np.concatenate([shared, rng.integers(0, vocab, size=3 + i)]), 6))
    reqs.append((99, rng.integers(0, vocab, size=64), 4))
    return reqs


def _run(srv, reqs, cls):
    return {r.rid: r.out for r in srv.run([cls(*a) for a in reqs])}


def _same_stats(got, want):
    """Equal ``stats()`` but for the host-time fields."""
    drop = lambda s: {k: v for k, v in s.items() if k not in TIMES}
    assert drop(got) == drop(want)
    assert set(TIMES) <= set(got)


@functools.lru_cache(maxsize=None)
def _width_consistent_params(jcfg, ml):
    """decoalesce(width-only)(level-1 init), in the reference: serving
    weights whose width-only draft is function-identical to the full model."""
    model = jax_build_model(jcfg)
    small = jax_build_model(jops.coalesce_config(jcfg, ml, width=True, depth=False))
    return _np(jops.make_decoalesce_fn(model.specs(), jcfg, ml, width=True, depth=False)(
        small.init(jax.random.PRNGKey(3))))


def _greedy(tcfg, weights, reqs, **kw):
    srv = make_server(tcfg, engine="paged", device="cpu", **kw)
    srv.set_params(from_reference(weights, tcfg))
    return _run(srv, reqs, Request)


@pytest.mark.parametrize("prefix_reuse", [True, False], ids=["reuse", "no-reuse"])
def test_speculative_matches_greedy_and_the_reference(prefix_reuse):
    """Random weights: the draft is essentially unrelated to the full model,
    rollback fires constantly, and every stream still equals greedy's (and
    the reference's speculative server's, stats too); the pool drains."""
    jcfg, tcfg = _cfgs()
    kw = dict(batch=3, max_seq=48, page_size=8, prefix_reuse=prefix_reuse)
    reqs = _request_mix(jcfg.vocab_size)
    ref = jax_make_server(jcfg, engine="paged", policy="speculative", draft_k=3, **kw)
    want = _run(ref, reqs, JaxRequest)
    weights = _np(ref.params)
    assert want == _greedy(tcfg, weights, reqs, **kw)
    srv = make_server(tcfg, engine="paged", policy="speculative", draft_k=3, device="cpu", **kw)
    srv.set_params(from_reference(weights, tcfg))
    assert _run(srv, reqs, Request) == want
    assert [r.rid for r in srv.rejected] == [99]
    st = srv.stats()
    _same_stats(st, ref.stats())
    assert st["drafted_tokens"] > 0 and st["rolled_back_positions"] > 0
    assert srv.alloc.pool.n_used == 0 and srv.policy.draft_alloc.pool.n_used == 0
    if prefix_reuse:
        assert srv.prefill_tokens_saved > 0


@pytest.fixture(scope="module")
def reference_k4():
    """One reference speculative server (k 4, width-only draft, batch 2,
    max_seq 48) for the cases of that shape, so that its steps compile once;
    each case starts it with ``reset()`` and its own weights.  Returns the
    server and its initial weights."""
    jcfg, _ = _cfgs(qk_norm=False, tie_embeddings=False)
    jpol = JaxSpeculativePolicy(k=4, ml=JML(), draft_width=True, draft_depth=False)
    ref = jax_make_server(jcfg, engine="paged", policy=jpol, batch=2, max_seq=48, page_size=8)
    return ref, _np(ref.params)


def _consistent_case(k, seed, n_prompts, plen, max_new, max_seq, sabotage=False, ref=None):
    """Width-consistent weights through ``set_params`` (the reload path, which
    must re-project the draft): returns the port's server, whose streams and
    stats equal the reference's (``ref``, reset, when given) and whose streams
    equal greedy's, each speculative server having drafted width-only."""
    jcfg, tcfg = _cfgs(qk_norm=False, tie_embeddings=False)
    p = _width_consistent_params(jcfg, JML())
    prompts = np.random.default_rng(seed).integers(0, jcfg.vocab_size, size=(n_prompts, plen))
    reqs = [(i, pr, max_new) for i, pr in enumerate(prompts)]
    kw = dict(batch=2, max_seq=max_seq, page_size=8)
    pol = SpeculativePolicy(k=k, ml=MultiLevelConfig(), draft_width=True, draft_depth=False)
    if ref is None:
        ref = jax_make_server(jcfg, engine="paged", **kw, policy=JaxSpeculativePolicy(
            k=k, ml=JML(), draft_width=True, draft_depth=False))
    if sabotage:  # +1 mod vocab: the first drafted token of every round is wrong
        for pl in (pol, ref.policy):
            honest = pl._draft_argmax
            pl._draft_argmax = lambda logits, h=honest: (h(logits) + 1) % jcfg.vocab_size
    srv = make_server(tcfg, engine="paged", policy=pol, device="cpu", **kw)
    srv.set_params(from_reference(p, tcfg))
    ref.reset()
    ref.set_params(jax.tree.map(jnp.asarray, p))
    greedy = _greedy(tcfg, p, reqs, **kw)
    assert _run(srv, reqs, Request) == greedy == _run(ref, reqs, JaxRequest)
    _same_stats(srv.stats(), ref.stats())
    return srv


def test_speculative_full_accept_on_consistent_params(reference_k4):
    srv = _consistent_case(k=4, seed=11, n_prompts=4, plen=7, max_new=8, max_seq=48,
                           ref=reference_k4[0])
    st = srv.stats()
    assert st["accept_rate"] > 0.9 and st["accepted_tokens"] > 0


def test_speculative_forced_rejection_rolls_back():
    srv = _consistent_case(k=3, seed=13, n_prompts=3, plen=6, max_new=6, max_seq=32,
                           sabotage=True)
    st = srv.stats()
    assert st["drafted_tokens"] > 0 and st["accept_rate"] <= 0.05
    assert srv.alloc.rolled_back_total > 0 and srv.alloc.pool.n_used == 0


def test_speculative_reset_and_reuse():
    """reset() rebuilds the draft pool and allocator and zeroes the policy's
    stats; the same prompt then gives the same tokens, as in the reference."""
    jcfg, tcfg = _cfgs()
    kw = dict(policy="speculative", draft_k=2, batch=2, max_seq=32, page_size=8)
    ref = jax_make_server(jcfg, engine="paged", **kw)
    srv = make_server(tcfg, engine="paged", device="cpu", **kw)
    srv.set_params(from_reference(_np(ref.params), tcfg))
    out0 = _run(srv, [(0, np.arange(6), 3)], Request)[0]
    srv.reset()
    assert srv.stats()["spec_rounds"] == 0 and srv.done == []
    assert srv.policy.draft_alloc.pool.n_used == 0
    assert _run(srv, [(1, np.arange(6), 3)], Request)[1] == out0
    assert _run(ref, [(1, np.arange(6), 3)], JaxRequest)[1] == out0
    _same_stats(srv.stats(), ref.stats())


def test_reload_speculative_reprojects_draft(reference_k4):
    """A drained swap re-projects the draft from the new serving weights:
    the draft equals ``_project(new params)`` exactly, the post-swap accept
    rate is near 1 on width-consistent weights, and the streams equal
    greedy's and the reference's."""
    jcfg, tcfg = _cfgs(qk_norm=False, tie_embeddings=False)
    p_new = _width_consistent_params(jcfg, JML())
    kw = dict(batch=2, max_seq=48, page_size=8)
    rng = np.random.default_rng(8)
    reqs_new = [(r, rng.integers(0, jcfg.vocab_size, size=int(rng.integers(5, 12))), 8)
                for r in (10, 11)]
    rng = np.random.default_rng(7)
    reqs_old = [(r, rng.integers(0, jcfg.vocab_size, size=int(rng.integers(5, 12))), 4)
                for r in (0, 1)]
    pol = SpeculativePolicy(k=4, ml=MultiLevelConfig(), draft_width=True, draft_depth=False)
    ref, p_old = reference_k4
    ref.reset()
    ref.set_params(jax.tree.map(jnp.asarray, p_old))
    jpol = ref.policy
    srv = make_server(tcfg, engine="paged", policy=pol, device="cpu", **kw)
    srv.set_params(from_reference(p_old, tcfg))
    assert _run(srv, reqs_old, Request) == _run(ref, reqs_old, JaxRequest)
    assert srv.request_reload(from_reference(p_new, tcfg))  # drained: swaps now
    assert ref.request_reload(jax.tree.map(jnp.asarray, p_new))
    want, got = flatten(pol._project(srv.params)), flatten(pol.draft_params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    pol._zero_stats()
    jpol._zero_stats()
    done = _run(srv, reqs_new, Request)
    assert done == _run(ref, reqs_new, JaxRequest)
    assert {k: v for k, v in done.items() if k >= 10} == _greedy(tcfg, p_new, reqs_new, **kw)
    _same_stats(srv.stats(), ref.stats())
    assert srv.stats()["accept_rate"] > 0.9


@pytest.mark.parametrize("depth", [False, True], ids=["width", "width+depth"])
def test_draft_projection_matches_the_reference(depth):
    """``make_draft_projection``: the same draft config and, leaf for leaf,
    the same draft parameters within 1e-6."""
    jcfg, tcfg = _cfgs(stages=uniform_stages(4, BlockSpec("attn", "dense")))
    rng = np.random.default_rng(5)
    weights = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
                           _np(jax_build_model(jcfg).init(jax.random.PRNGKey(2))))
    jdraft, jproject = jops.make_draft_projection(jax_build_model(jcfg).specs(), jcfg, JML(),
                                                  width=True, depth=depth)
    tdraft, tproject = ops.make_draft_projection(build_model(tcfg).specs(), tcfg,
                                                 MultiLevelConfig(), width=True, depth=depth)
    for f in ("d_model", "n_heads", "n_kv_heads", "d_ff", "n_layers", "resolved_head_dim"):
        assert getattr(tdraft, f) == getattr(jdraft, f), f
    assert tdraft.n_layers == (2 if depth else 4)
    want = flatten(_np(jproject(jax.tree.map(jnp.asarray, weights))))
    got = flatten(tproject(from_reference(weights, tcfg)))
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
