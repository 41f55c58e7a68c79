"""The port's paged greedy server, on the CPU.

The acceptance oracle: with the same weights (moved across with
``repro_torch.bridge``) the port's ``PagedServer`` and the reference's
``make_server(engine="paged")`` emit the same greedy tokens, request for
request, at f32 -- for the TinyLlama smoke config on prompts that take the
plain and the flash prefill routes and the prefix-reuse extend path, and for
``gpt_proxy``.  Then the port's copies of the reference's scheduler tests
(``tests/test_serve.py``): the lifecycle cases on both engines (paged and
slots), then the paged engine's pool-exhaustion queueing and a fully free
pool after a drain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import gpt_proxy as jax_gpt_proxy
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server

from repro_torch.bridge import from_reference
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import gpt_proxy
from repro_torch.launch.serve import EngineCore, PagedServer, Request, Server, make_server
from test_torch_ssm import one_thread  # noqa: F401 (autouse)


def _mix(vocab, lengths, shared_len, seed):
    """Prompts of the given lengths plus a pair sharing a ``shared_len``
    prefix (the second is served by the extend step) and one oversized."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=n) for n in lengths]
    shared = rng.integers(0, vocab, size=shared_len)
    prompts += [np.concatenate([shared, rng.integers(0, vocab, size=n)]) for n in (30, 44)]
    prompts.append(rng.integers(0, vocab, size=400))  # > max_seq - 1: rejected
    return prompts


@pytest.mark.parametrize("arch", ["tinyllama", "gpt"])
def test_paged_server_matches_reference_token_for_token(arch):
    if arch == "tinyllama":
        # attn_block_k=64: the 130..200-token prompts take the flash route
        jcfg = jax_get_config("tinyllama-1.1b", smoke=True).replace(
            compute_dtype=jnp.float32, attn_block_k=64)
        tcfg = get_config("tinyllama-1.1b", smoke=True).replace(
            compute_dtype=torch.float32, attn_block_k=64)
        prompts = _mix(jcfg.vocab_size, [130, 171, 200, 9], 136, seed=1)
    else:
        jcfg = jax_gpt_proxy(n_layers=2).replace(compute_dtype=jnp.float32)
        tcfg = gpt_proxy(n_layers=2).replace(compute_dtype=torch.float32)
        prompts = _mix(jcfg.vocab_size, [5, 23, 64], 24, seed=2)
    kw = dict(engine="paged", batch=3, max_seq=256, page_size=8)
    ref = jax_make_server(jcfg, **kw)
    ref_done = ref.run([JaxRequest(i, p, 6) for i, p in enumerate(prompts)])
    srv = make_server(tcfg, device="cpu", **kw)
    srv.set_params(from_reference(jax.tree.map(np.asarray, ref.params), tcfg))
    done = srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])
    assert {r.rid: r.out for r in done} == {r.rid: r.out for r in ref_done}
    assert [r.rid for r in srv.rejected] == [r.rid for r in ref.rejected] == [len(prompts) - 1]
    assert srv.stats() == ref.stats()
    assert srv.prefill_tokens_saved > 0  # the shared pair ran the extend step


@pytest.mark.parametrize("prefix_reuse", [True, False], ids=["reuse", "no-reuse"])
def test_gpt_paged_server_matches_reference_with_and_without_prefix_reuse(prefix_reuse):
    """GPT (tied embeddings, LayerNorm, biases, GELU) as the hand-off server
    runs it: ``gpt_proxy`` with the flash prefill route (``attn_block_k=64``,
    prompts of 130+ tokens), every leaf perturbed so no bias is zero, the
    shared-prefix pair served by the extend step or, without prefix reuse,
    by a cold prefill.  Streams and stats equal the reference's."""
    rng = np.random.default_rng(3)
    jcfg = jax_gpt_proxy(n_layers=2).replace(compute_dtype=jnp.float32, attn_block_k=64)
    tcfg = gpt_proxy(n_layers=2).replace(compute_dtype=torch.float32, attn_block_k=64)
    prompts = _mix(jcfg.vocab_size, [150, 23, 201], 136, seed=4)
    kw = dict(engine="paged", batch=3, max_seq=256, page_size=8, prefix_reuse=prefix_reuse)
    ref = jax_make_server(jcfg, **kw)
    weights = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                                      ).astype(np.float32), ref.params)
    ref.set_params(jax.tree.map(jnp.asarray, weights))
    ref_done = ref.run([JaxRequest(i, p, 6) for i, p in enumerate(prompts)])
    srv = make_server(tcfg, device="cpu", **kw)
    srv.set_params(from_reference(weights, tcfg))
    done = srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])
    assert {r.rid: r.out for r in done} == {r.rid: r.out for r in ref_done}
    assert srv.stats() == ref.stats()
    assert (srv.prefill_tokens_saved > 0) == prefix_reuse


# ---------------------------------------------------------------------------
# scheduler (copies of tests/test_serve.py's cases, port only)


@pytest.fixture(scope="module")
def cfg():
    return get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=torch.float32)


@pytest.fixture(params=["paged", "slots"])
def engine(request):
    return request.param


def _server(cfg, batch, max_seq, **kw):
    return make_server(cfg, batch=batch, max_seq=max_seq, page_size=kw.pop("page_size", 8),
                       device="cpu", **kw)


def test_continuous_batching_recycles_rows(cfg, engine):
    srv = _server(cfg, batch=2, max_seq=48, engine=engine)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 100, size=int(rng.integers(4, 9))),
                    max_new=3) for i in range(5)]
    done = srv.run(reqs)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.out) == 3 for r in done)
    assert srv.rejected == [] and all(a is None for a in srv.active)


def test_admit_rejects_oversized_prompt(cfg, engine):
    srv = _server(cfg, batch=2, max_seq=16, engine=engine)
    with pytest.raises(ValueError, match="cannot be admitted"):
        srv.admit(Request(rid=0, prompt=np.arange(16), max_new=4))
    with pytest.raises(ValueError, match="cannot be admitted"):
        srv.admit(Request(rid=1, prompt=np.arange(40), max_new=4))
    assert srv.admit(Request(rid=2, prompt=np.arange(15), max_new=4))


def test_run_drops_oversized_instead_of_wedging(cfg, engine):
    srv = _server(cfg, batch=2, max_seq=16, engine=engine)
    done = srv.run([Request(rid=0, prompt=np.arange(20), max_new=2),
                    Request(rid=1, prompt=np.arange(4), max_new=2),
                    Request(rid=2, prompt=np.arange(5), max_new=2)])
    assert [r.rid for r in srv.rejected] == [0]
    assert sorted(r.rid for r in done) == [1, 2]
    assert all(len(r.out) == 2 for r in done)


def test_pos_capped_at_last_cache_index(cfg, engine):
    srv = _server(cfg, batch=1, max_seq=12, engine=engine)
    done = srv.run([Request(rid=0, prompt=np.arange(11), max_new=50)])
    assert len(done) == 1 and len(done[0].out) >= 1
    assert int(srv.pos[0]) <= srv.max_seq - 1


def test_pool_exhaustion_queues_until_pages_free(cfg):
    """Each request needs 4 pages and the pool holds 8: at most 2 in flight
    though the batch allows 4; all finish, none rejected."""
    rng = np.random.default_rng(7)
    srv = _server(cfg, batch=4, max_seq=32, page_size=4, n_pages=9, prefix_reuse=False)
    done = srv.run([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=10),
                            max_new=4) for i in range(5)])
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert srv.rejected == [] and srv.pages_in_use_peak <= 8
    assert srv.alloc.pool.n_used == 0


def test_never_admittable_block_table_rejected(cfg):
    srv = _server(cfg, batch=2, max_seq=64, page_size=4, n_pages=5)
    done = srv.run([Request(rid=0, prompt=np.arange(30), max_new=8),
                    Request(rid=1, prompt=np.arange(6), max_new=4)])
    assert [r.rid for r in srv.rejected] == [0] and [r.rid for r in done] == [1]


def test_pool_fully_free_after_drain(cfg):
    srv = _server(cfg, batch=3, max_seq=48)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, size=20)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(n)), max_new=4)
            for i, n in enumerate(rng.integers(4, 14, size=4))]
    reqs += [Request(rid=10 + i, prompt=np.concatenate([shared, np.arange(3 + i)]),
                     max_new=4) for i in range(3)]
    srv.run(reqs)
    assert srv.alloc.pool.n_used == 0 and srv.pages_in_use_peak > 0
    assert len(srv.alloc.live) == 0 and len(srv.alloc.prefix) == 0
    assert srv.prefill_tokens_saved > 0


def test_reset_and_set_params(cfg):
    """reset() clears request and pool state; the same prompt then gives the
    same tokens.  set_params() swaps weights and drops the prefix cache."""
    srv = _server(cfg, batch=2, max_seq=32)
    out0 = list(srv.run([Request(rid=0, prompt=np.arange(6), max_new=3)])[0].out)
    srv.reset()
    assert srv.done == [] and srv.alloc.pool.n_used == 0
    assert srv.run([Request(rid=1, prompt=np.arange(6), max_new=3)])[0].out == out0
    srv.set_params({k: v for k, v in srv.params.items()})
    assert srv.alloc.invalidations_total == 1


def test_scheduler_lives_on_engine_core():
    """Admission, the run loop, token commit, reset and set_params live on
    ``EngineCore`` once; neither engine overrides them."""
    for meth in ("fits", "admit", "run", "reset", "commit", "step", "set_params"):
        assert getattr(PagedServer, meth) is getattr(EngineCore, meth)
        assert getattr(Server, meth) is getattr(EngineCore, meth)


def test_make_server_rejects_what_is_not_ported(cfg):
    """The reference's rejection contract: unknown engines and policies,
    a policy of the wrong type, and speculation on the slots engine."""
    with pytest.raises(ValueError, match="unknown engine"):
        make_server(cfg, engine="vllm", device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        make_server(cfg, engine="paged", policy="beam", device="cpu")
    with pytest.raises(TypeError, match="policy must be"):
        make_server(cfg, engine="paged", policy=42, device="cpu")
    with pytest.raises(NotImplementedError, match="paged engine"):
        make_server(cfg, engine="slots", policy="speculative", device="cpu")


def test_make_server_without_device_needs_cuda(cfg, monkeypatch):
    """Nothing carries on quietly on the CPU: no device and no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(cfg)
