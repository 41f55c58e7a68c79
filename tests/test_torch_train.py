"""The port's training step against the JAX reference, on the CPU, at f32.

``gpt_proxy(d_model=64, n_layers=2, vocab=256)`` at ``seq_len=256`` with
``attn_block_k=64``, so attention takes the flash route on both sides (the
reference's ``flash_xla`` custom VJP, the port's ``FlashAttention`` on the
plain versions).  The same weights cross with ``repro_torch.bridge`` and the
same reference batches cross through numpy.

Tolerances: the loss within 1e-5 and every gradient within atol 2e-6 (f32,
other summation orders); after one and three AdamW steps the parameters and
moments within 1e-5.  The step tests set Adam's ``eps`` to 1e-4: Adam's
first steps move each weight by about ``lr * g / (|g| + eps)``, and at the
default 1e-8 a gradient element that is zero up to rounding moves its
weight by up to ``lr`` either way on the two sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs.paper_models import gpt_proxy as jax_gpt_proxy
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch.bridge import (from_reference, opt_state_from_reference,
                                opt_state_to_reference, to_reference)
from repro_torch.config import TrainConfig
from repro_torch.configs.paper_models import gpt_proxy
from repro_torch.models import lm as tlm
from repro_torch.models.api import (build_model, init_train_state, make_eval_loss,
                                    make_train_step)
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten

SEQ, BATCH = 256, 2


def _cfgs(remat="none"):
    j = jax_gpt_proxy(d_model=64, n_layers=2, vocab=256).replace(
        compute_dtype=jnp.float32, attn_impl="blockwise", attn_block_k=64)
    t = gpt_proxy(d_model=64, n_layers=2, vocab=256).replace(
        compute_dtype=torch.float32, attn_impl="blockwise", attn_block_k=64, remat=remat)
    return j, t


def _params(jcfg, tcfg, seed=0):
    """Reference init with the vector leaves perturbed (zero biases would
    hide the bias gradients' paths); returns (reference tree, port tree)."""
    rng = np.random.default_rng(seed)
    vectors = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in vectors else v for k, v in tree.items()}

    tree = perturb(jax.tree.map(np.asarray,
                                jax_build_model(jcfg).init(jax.random.PRNGKey(seed))))
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _batches(n, vocab=256, batch=BATCH):
    chain = JMarkovLM(vocab)
    return [jax.tree.map(np.asarray, jax_lm_batch(chain, 0, g, batch, SEQ))
            for g in range(n)]


def _tb(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_reference(remat):
    jcfg, tcfg = _cfgs(remat)
    jp, tp = _params(jcfg, tcfg)
    batch = _batches(1)[0]
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b), has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, metrics = tmodel.loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    _close(tl.item(), jl, 1e-5)
    assert metrics["ce"] is tl
    want = flatten(jax.tree.map(np.asarray, jg))
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6)


def test_forward_logits_and_eval_loss_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=1)
    batch = _batches(1)[0]
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    _close(tmodel.forward_logits(tp, _tb(batch)).detach().numpy(),
           jax.jit(jmodel.forward_logits)(jp, jb), 1e-4)
    got = make_eval_loss(tmodel)(tp, _tb(batch))
    _close(got["loss"].item(), jax.jit(jmodel.loss)(jp, jb)[0], 1e-5)


def test_padded_vocab_columns_stay_in_the_logsumexp():
    """vocab 250 pads to 256: the six padding logits count in the
    normaliser, as in the reference (logits are not sliced to vocab_size)."""
    _, tcfg = _cfgs()
    tcfg = tcfg.replace(vocab_size=250)
    assert tcfg.padded_vocab == 256
    logits = torch.zeros(1, 3, 256)
    labels = torch.tensor([[0, 5, -1]])
    loss, _ = tlm.lm_loss(logits, labels, tcfg)
    assert abs(loss.item() - np.log(256)) < 1e-6


@pytest.mark.parametrize("n_steps,grad_accum", [(1, 1), (3, 1), (1, 2)])
def test_train_steps_match_reference(n_steps, grad_accum):
    """Params, moments, count, grad_norm and lr after ``n_steps`` AdamW
    steps (warm-up 2 of 6, cosine), from the same weights and batches."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    kw = dict(steps=6, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
              weight_decay=0.1, grad_accum=grad_accum, eps=1e-4)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))
    tstep = make_train_step(build_model(tcfg), ttc)
    jopt = jadamw.adamw_init(jp, jtc)
    topt = tadamw.adamw_init(tp, ttc)
    raw = _batches(n_steps * grad_accum)
    for s in range(n_steps):
        mb = raw[s * grad_accum:(s + 1) * grad_accum]
        b = mb[0] if grad_accum == 1 else {k: np.stack([m[k] for m in mb]) for k in mb[0]}
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tm = tstep(tp, topt, _tb(b))
        _close(tm["loss"].item(), jm["loss"], 1e-5)
        _close(tm["grad_norm"].item(), jm["grad_norm"], 1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    got_p = flatten(to_reference(tp, tcfg))
    for key, want in flatten(jax.tree.map(np.asarray, jp)).items():
        _close(got_p[key], want, 1e-5)
    got_o = opt_state_to_reference(topt, tcfg)
    assert int(got_o["count"]) == int(jopt["count"]) == n_steps
    for part in ("m", "v"):
        want = flatten(jax.tree.map(np.asarray, jopt[part]))
        for key, g in flatten(got_o[part]).items():
            _close(g, want[key], 1e-5)
    # the state crosses back: the reference's optimizer state, bridged in,
    # equals the port's own
    back = opt_state_from_reference(jax.tree.map(np.asarray, jopt), tcfg)
    assert back["count"] == topt["count"]
    for key, g in flatten(back["m"]).items():
        _close(g.numpy(), flatten(topt["m"])[key].numpy(), 1e-5)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(steps=20, warmup_steps=5, peak_lr=6e-4, end_lr_frac=0.1, schedule=schedule)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    for step in range(0, 24):
        want = float(jadamw.lr_at(jnp.asarray(step), jtc))
        assert tadamw.lr_at(step, ttc) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_weight_decay_mask_is_the_stacked_leaf_ndim():
    """With zero gradients only weight decay moves a parameter: stacked
    biases and norm scales ([layers, E], ndim 2) ARE decayed, ``final_norm``
    ([E]) is not -- the reference's code, pinned against it."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=3)
    kw = dict(steps=10, warmup_steps=0, peak_lr=1e-2, weight_decay=0.5)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    before = {k: v.clone() for k, v in flatten(tp).items()}
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, _ = jax.jit(lambda p, g, o: jadamw.adamw_update(p, g, o, jtc))(
        jp, zeros, jadamw.adamw_init(jp, jtc))
    tnew, _, _ = tadamw.adamw_update(tp, {k: v for k, v in _zero_tree(tp).items()},
                                     tadamw.adamw_init(tp, ttc), ttc)
    got, want = flatten(tnew), flatten(jax.tree.map(np.asarray, jnew))
    for key in got:  # 1 ulp apart where the reference fuses into an FMA
        _close(got[key].numpy(), want[key], 1e-6)
    lr = tadamw.lr_at(1, ttc)
    bias = "stages/stage_0/b0/mixer/bq"
    scale = "stages/stage_0/b0/norm1/scale"
    assert before[scale].ndim == 2 and before["final_norm/scale"].ndim == 1
    for key in (bias, scale, "embed/tok"):
        _close(got[key].numpy(), (before[key] * (1 - lr * 0.5)).numpy(), 1e-6)
    assert torch.equal(got["final_norm/scale"], before["final_norm/scale"])
    assert torch.equal(got["final_norm/bias"], before["final_norm/bias"])


def _zero_tree(tree):
    return {k: _zero_tree(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_init_train_state_and_remat_dots():
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    params, opt = init_train_state(model, TrainConfig(), torch.Generator().manual_seed(0))
    assert opt["count"] == 0
    for key, leaf in flatten(opt["m"]).items():
        assert leaf.shape == flatten(params)[key].shape and not leaf.any()
    with pytest.raises(NotImplementedError, match="dots"):
        build_model(tcfg.replace(remat="dots")).loss(
            params, _tb(_batches(1)[0]))
