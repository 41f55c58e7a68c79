"""``remat="dots"`` (selective checkpointing) against the reference's
``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``, on the CPU at f32.

Three smoke configs, one per family the policy meets differently:
TinyLlama-1.1B's (dense, seq 256 past ``attn_block_k`` 64, so attention
takes the flash ``autograd.Function``, which "dots" recomputes), Phi-3.5-MoE's
(seq 32: plain attention, whose score ``bmm`` and the expert einsum carry a
batch dimension and are recomputed) and xLSTM-125m's (``ssm_chunk`` 4: the
per-chunk checkpoints of ``layers/ssm.py`` nest inside the selective region).

Under "dots" the port's loss and every gradient sit within the tolerances of
the families' parity tests from the reference's "dots" (dense and MoE: loss
1e-5, gradients 2e-6; xLSTM: gradients 1e-5 plus 1e-3 of the leaf's largest
value, measured in ``tests/test_torch_ssm.py``), and are bit-equal to the
port's own "none" and "full": the policy moves memory, not values.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference, to_reference
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model
from repro_torch.param import flatten
from test_torch_speculative import _np
from test_torch_ssm import torch_cfg

# name -> (reference config overrides, seq, gradient (atol, share of the
# leaf's largest |value|))
CASES = {
    "tinyllama-1.1b": (dict(attn_impl="blockwise", attn_block_k=64), 256, (2e-6, 0.0)),
    "phi3.5-moe-42b-a6.6b": (dict(), 32, (2e-6, 0.0)),
    "xlstm-125m": (dict(ssm_chunk=4), 16, (1e-5, 1e-3)),
}
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the recurrent loops issue thousands of tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name, remat):
    kw, _, _ = CASES[name]
    return jax_get_config(name, smoke=True).replace(compute_dtype=jnp.float32, remat=remat,
                                                    **kw)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's loss and gradients under "dots" on one batch, with the
    weights (numpy; the port's init, norm scales perturbed) and the batch."""
    jcfg = _jcfg(name, "dots")
    tcfg = torch_cfg(jcfg)
    rng = np.random.default_rng(0)
    tree = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(0)), tcfg)

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k == "scale" else v for k, v in t.items()}

    tree = perturb(tree)
    batch = _np(jax_lm_batch(JMarkovLM(jcfg.vocab_size), 0, 0, BATCH, CASES[name][1]))
    jmodel = jax_build_model(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    return tree, batch, float(jl), flatten(_np(jg))


def _port_grads(name, remat, weights, batch):
    tcfg = torch_cfg(_jcfg(name, remat))
    tp = from_reference(weights, tcfg)
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
    tl, _ = build_model(tcfg).loss(tp, tb)
    return tl.detach(), dict(zip(flatten(tp), torch.autograd.grad(tl, leaves)))


@pytest.mark.parametrize("name", list(CASES))
def test_dots_loss_and_every_gradient_match_the_reference(name):
    weights, batch, jl, want = _reference(name)
    tl, tg = _port_grads(name, "dots", weights, batch)
    np.testing.assert_allclose(tl.item(), jl, atol=1e-5, rtol=0)
    assert sorted(tg) == sorted(want)
    atol, rel = CASES[name][2]
    for key, g in tg.items():
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=atol + rel * np.abs(want[key]).max(), err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_dots_equals_the_ports_none_and_full(name):
    """Selective recomputation gives the same bits as keeping every
    activation and as recomputing the whole block."""
    weights, batch, _, _ = _reference(name)
    tl, tg = _port_grads(name, "dots", weights, batch)
    for other in ("none", "full"):
        ol, og = _port_grads(name, other, weights, batch)
        assert torch.equal(tl, ol), other
        for key, g in tg.items():
            assert torch.equal(g, og[key]), (other, key)


class _ProductCounter(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active: the ones
    ``DOTS_SAVED_OPS`` names ("saved") and ``bmm`` over a batch ("batched")."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tlm._MM_OPS or (func is torch.ops.aten.bmm.default
                                   and args[0].shape[0] == 1):
            self.counts["saved"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.counts["batched"] += 1
        return func(*args, **(kwargs or {}))


def test_policy_saves_the_unbatched_products_and_recomputes_the_rest():
    """The op list is pinned, and in the backward of Phi's smoke config (plain
    attention, MoE experts): "dots" runs exactly as many unbatched products
    as "none" (only the gradient products: no forward product is re-run),
    and more batched ones (the attention scores and the expert einsum are
    recomputed); "full" re-runs unbatched forward products too."""
    assert tlm.DOTS_SAVED_OPS == ("aten.mm.default", "aten.addmm.default",
                                  "aten.bmm.default[batch 1]")
    assert tlm.SUPPORTED_REMAT == ("none", "full", "dots")
    name = "phi3.5-moe-42b-a6.6b"
    weights, batch, _, _ = _reference(name)
    seen = {}
    for remat in ("none", "dots", "full"):
        tcfg = torch_cfg(_jcfg(name, remat))
        tp = from_reference(weights, tcfg)
        leaves = list(flatten(tp).values())
        for p in leaves:
            p.requires_grad_(True)
        tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
        tl, _ = build_model(tcfg).loss(tp, tb)
        with _ProductCounter() as c:
            torch.autograd.grad(tl, leaves)
        seen[remat] = c.counts
    assert seen["dots"]["saved"] == seen["none"]["saved"] > 0, seen
    assert seen["dots"]["batched"] > seen["none"]["batched"], seen
    assert seen["full"]["saved"] > seen["none"]["saved"], seen
    assert seen["full"]["batched"] == seen["dots"]["batched"], seen
