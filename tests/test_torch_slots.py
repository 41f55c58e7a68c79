"""The port's ``slots`` engine (dense ``[batch, max_seq]`` caches), on the CPU.

The slots engine is the equivalence oracle of the paged engine.  Port copies
of ``tests/test_serve.py``'s cases: paged equals slots token for token with
prefix reuse on and off, and ``make_server`` keeps the reference's contract
for the slots engine (that both engines share one scheduler core is
``tests/test_torch_serve.py::test_scheduler_lives_on_engine_core``); of
``tests/test_reload.py``'s reload contract on the slots engine (GQA).  Each
stream is also held to the reference's slots engine on the same weights
(moved across with ``repro_torch.bridge``) and the same numpy prompts, at
f32, including the TinyLlama smoke config with ``attn_block_k=64``, where
prompts of 130+ tokens prefill through the flash route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, Server, SpeculativePolicy, make_server
from test_torch_speculative import _cfgs, _np, _request_mix, _run
from test_torch_speculative import one_thread  # noqa: F401 (autouse)


def _port(tcfg, weights, engine, **kw):
    srv = make_server(tcfg, engine=engine, device="cpu", **kw)
    srv.set_params(from_reference(weights, tcfg))
    return srv


@pytest.fixture(scope="module")
def reference_slots():
    """The reference's slots streams and rejections on the request mix, with
    its weights."""
    jcfg, _ = _cfgs()
    ref = jax_make_server(jcfg, engine="slots", batch=3, max_seq=48)
    streams = _run(ref, _request_mix(jcfg.vocab_size), JaxRequest)
    return _np(ref.params), streams, [r.rid for r in ref.rejected]


@pytest.mark.parametrize("prefix_reuse", [True, False], ids=["reuse", "no-reuse"])
def test_paged_matches_slots_token_for_token(prefix_reuse, reference_slots):
    """The same requests through both engines give identical greedy streams
    and rejections, and both equal the reference's slots engine."""
    weights, want, rejected = reference_slots
    _, tcfg = _cfgs()
    results = {}
    for engine in ("slots", "paged"):
        srv = _port(tcfg, weights, engine, batch=3, max_seq=48, page_size=8,
                    prefix_reuse=prefix_reuse)
        results[engine] = (_run(srv, _request_mix(tcfg.vocab_size), Request),
                           sorted(r.rid for r in srv.rejected))
    assert results["paged"][1] == results["slots"][1] == rejected == [99]
    assert results["paged"][0] == results["slots"][0] == want


def test_slots_match_the_reference_on_flash_prefill():
    """TinyLlama smoke config at ``attn_block_k=64``: prompts of 130..200
    tokens prefill through the flash route, the short one through plain
    attention; the slots streams equal the reference's."""
    jcfg = jax_get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=jnp.float32,
                                                                attn_block_k=64)
    tcfg = get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=torch.float32,
                                                           attn_block_k=64)
    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, jcfg.vocab_size, size=n), 5)
            for i, n in enumerate((130, 171, 200, 9))]
    ref = jax_make_server(jcfg, engine="slots", batch=3, max_seq=256)
    want = _run(ref, reqs, JaxRequest)
    srv = _port(tcfg, _np(ref.params), "slots", batch=3, max_seq=256)
    assert isinstance(srv, Server)
    assert _run(srv, reqs, Request) == want
    assert srv.stats() == ref.stats() == {"policy": "greedy"}


def test_slots_engine_stays_greedy_only():
    """The speculative policy refuses the slots engine by name, through
    ``make_server`` and through a policy instance alike."""
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="paged engine"):
        make_server(tcfg, engine="slots", policy="speculative", device="cpu")
    with pytest.raises(NotImplementedError, match="paged engine"):
        Server(tcfg, batch=2, max_seq=16, policy=SpeculativePolicy(k=2), device="cpu")
    srv = make_server(tcfg, engine="slots", batch=2, max_seq=16, device="cpu")
    assert srv.engine_name == "slots" and srv.cache["stage_0"]["b0"]["self"]["k"].shape \
        == (3, 2, 16, 2, 16)


def _reqs(vocab, rids, seed, max_new=4):
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(0, vocab, size=int(rng.integers(5, 12))), max_new) for r in rids]


def test_reload_equivalence_slots():
    """``tests/test_reload.py``'s reload contract on the slots engine (GQA):
    in-flight requests finish under the OLD weights, admission is gated
    while a swap is staged, the swap lands at the first drained tick, and
    admissions after it stream what the reference streams on the NEW
    weights."""
    jcfg, tcfg = _cfgs()
    kw = dict(engine="slots", batch=2, max_seq=48)
    p_new = _np(jax_build_model(jcfg).init(jax.random.PRNGKey(42)))
    ref = jax_make_server(jcfg, **kw)  # one reference server, reset between the oracles
    p_old = _np(ref.params)
    old_oracle = _run(ref, _reqs(jcfg.vocab_size, [0, 1], seed=7), JaxRequest)
    ref.reset()
    ref.set_params(jax.tree.map(jnp.asarray, p_new))
    new_oracle = _run(ref, _reqs(jcfg.vocab_size, [10, 11], seed=8), JaxRequest)

    srv = _port(tcfg, p_old, **kw)
    for a in _reqs(tcfg.vocab_size, [0, 1], seed=7):
        assert srv.admit(Request(*a))
    srv.step()  # both rows mid-flight
    assert not srv.request_reload(from_reference(p_new, tcfg))  # staged, not swapped
    assert srv.reload_pending()
    assert not srv.admit(Request(*_reqs(tcfg.vocab_size, [50], seed=9)[0]))  # gated
    while any(r is not None for r in srv.active):
        srv.step()
    assert srv.reloads == 0
    srv.step()  # the first drained tick boundary lands the swap
    assert srv.reloads == 1 and not srv.reload_pending()
    assert {r.rid: r.out for r in srv.done} == old_oracle
    done = _run(srv, _reqs(tcfg.vocab_size, [10, 11], seed=8), Request)
    assert {k: v for k, v in done.items() if k >= 10} == new_oracle
