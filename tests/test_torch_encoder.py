"""The port's encoder (BERT, MLM) and ViT (DeiT) arms against the JAX
reference, on the CPU, at f32; their batch generators; the energy model.

* ``bert_proxy(d_model=64, n_layers=4)``: the loss, every gradient and the
  parameters and moments after one AdamW step, on a reference MLM batch, at
  seq 64 (plain attention) and at seq 640 with ``attn_impl="blockwise"``
  (640 > ``attn_block_k`` = 512: the non-causal flash op, through its plain
  version and its ``autograd.Function``).  Tolerances as in
  ``tests/test_torch_train.py``: loss within 1e-5, gradients within atol
  2e-6, the stepped state within 1e-5 (Adam's ``eps`` at 1e-4 for the
  reason given there).
* ``deit_proxy(d_model=64, n_layers=2)``: ``vit_forward`` logits within
  1e-5, loss within 1e-5, the same accuracy, every gradient within 2e-6,
  on a reference ``vision_batch``.
* ``masked_lm_batch`` and ``vision_batch`` of the port: the reference's
  distributions (their draws differ: torch generators, not ``jax.random``).
* ``energy_report`` equals the reference's for every device it lists.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import bert_proxy as jax_bert_proxy
from repro.configs.paper_models import deit_proxy as jax_deit_proxy
from repro.core import flops as jflops
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import masked_lm_batch as jax_masked_lm_batch
from repro.data.synthetic import vision_batch as jax_vision_batch
from repro.models import vit as jvit
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw

from repro_torch.bridge import from_reference, opt_state_to_reference, to_reference
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import bert_proxy, deit_proxy, gpt_proxy
from repro_torch.core import flops as tflops
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import dispatch as kd
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import vit as tvit
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten

VECTORS = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}


def _params(jcfg, tcfg, seed=0):
    """Reference init with the vector leaves perturbed (zero biases would
    hide the bias gradients' paths); returns (reference tree, port tree)."""
    rng = np.random.default_rng(seed)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in VECTORS else v for k, v in tree.items()}

    tree = perturb(jax.tree.map(np.asarray,
                                jax_build_model(jcfg).init(jax.random.PRNGKey(seed))))
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _tb(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# BERT (encoder, MLM)

BERT_CASES = {"plain-seq64": ("plain", 64), "blockwise-seq640": ("blockwise", 640)}


def _bert(impl):
    j = jax_bert_proxy(d_model=64, n_layers=4).replace(compute_dtype=jnp.float32,
                                                       attn_impl=impl)
    t = bert_proxy(d_model=64, n_layers=4).replace(compute_dtype=torch.float32,
                                                   attn_impl=impl)
    return j, t


def _mlm_batch(cfg, seq, step=0, batch=2):
    b = jax_masked_lm_batch(JMarkovLM(cfg.vocab_size), 0, step, batch, seq,
                            cfg.vocab_size - 1)
    return jax.tree.map(np.asarray, b)


@pytest.mark.parametrize("case", BERT_CASES)
def test_bert_loss_and_every_gradient_match_reference(case, monkeypatch):
    impl, seq = BERT_CASES[case]
    jcfg, tcfg = _bert(impl)
    jp, tp = _params(jcfg, tcfg)
    batch = _mlm_batch(jcfg, seq)
    assert (batch["labels"] == -1).any() and (batch["labels"] >= 0).any()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    calls = []  # the flash op's causal flags: it runs at seq 640, non-causal
    fwd = kd._REGISTRY["flash_attention"]["torch"]

    def counting(*a, causal, **kw):
        calls.append(causal)
        return fwd(*a, causal=causal, **kw)

    monkeypatch.setitem(kd._REGISTRY["flash_attention"], "torch", counting)
    tl, _ = tmodel.loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert calls == ([False] * tcfg.n_layers if impl == "blockwise" else [])
    _close(tl.item(), jl, 1e-5)
    want = flatten(jax.tree.map(np.asarray, jg))
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6)


@pytest.mark.parametrize("case", BERT_CASES)
def test_bert_train_step_matches_reference(case):
    impl, seq = BERT_CASES[case]
    jcfg, tcfg = _bert(impl)
    jp, tp = _params(jcfg, tcfg, seed=2)
    kw = dict(steps=6, warmup_steps=0, peak_lr=3e-3, batch_size=2, seq_len=seq,
              weight_decay=0.1, eps=1e-4)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    batch = _mlm_batch(jcfg, seq, step=1)
    jopt = jadamw.adamw_init(jp, jtc)
    jp, jopt, jm = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jopt, jax.tree.map(jnp.asarray, batch))
    tp, topt, tm = make_train_step(build_model(tcfg), ttc)(tp, tadamw.adamw_init(tp, ttc),
                                                           _tb(batch))
    _close(tm["loss"].item(), jm["loss"], 1e-5)
    _close(tm["grad_norm"].item(), jm["grad_norm"], 1e-5)
    got_p = flatten(to_reference(tp, tcfg))
    for key, want in flatten(jax.tree.map(np.asarray, jp)).items():
        _close(got_p[key], want, 1e-5)
    got_o = opt_state_to_reference(topt, tcfg)
    for part in ("m", "v"):
        want = flatten(jax.tree.map(np.asarray, jopt[part]))
        for key, g in flatten(got_o[part]).items():
            _close(g, want[key], 1e-5)


# ---------------------------------------------------------------------------
# DeiT (ViT)


@pytest.fixture
def one_thread():
    """One intra-op thread: with a pool, the order in which torch sums a
    gradient's reduction follows the host's thread count, and one DeiT
    gradient element then lands 2.07e-6 from the reference's on an 8-core
    host against the 2e-6 tolerance (the sum, not the model, moves)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deit_logits_loss_and_every_gradient_match_reference(one_thread):
    jcfg = jax_deit_proxy(d_model=64, n_layers=2).replace(compute_dtype=jnp.float32)
    tcfg = deit_proxy(d_model=64, n_layers=2).replace(compute_dtype=torch.float32)
    assert tvit.n_patches(tcfg) == jvit.n_patches(jcfg) == 16
    assert tvit.patch_dim(tcfg) == jvit.patch_dim(jcfg) == 192
    jp, tp = _params(jcfg, tcfg, seed=4)
    batch = jax.tree.map(np.asarray, jax_vision_batch(0, 0, 8, 16, 192, jcfg.n_classes))
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {"patches": torch.from_numpy(np.array(batch["patches"])),
          "labels": torch.from_numpy(batch["labels"].astype(np.int64))}
    logits = tmodel.forward_logits(tp, tb)
    assert logits.dtype == torch.float32 and logits.shape == (8, jcfg.n_classes)
    _close(logits.detach().numpy(), jax.jit(jmodel.forward_logits)(jp, jb), 1e-5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b), has_aux=True))(
        jp, jb)
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = tmodel.loss(tp, tb)
    tg = torch.autograd.grad(tl, leaves)
    _close(tl.item(), jl, 1e-5)
    assert tm["acc"].item() == float(jm["acc"])
    want = flatten(jax.tree.map(np.asarray, jg))
    assert set(want) == set(flatten(tp))
    for (key, _), g in zip(flatten(tp).items(), tg):
        _close(g.numpy(), want[key], 2e-6)


@pytest.mark.parametrize("name", ["bert-base", "bert-large", "deit-b"])
def test_build_model_takes_the_paper_arms(name):
    """The full-size configs build, with the reference's leaf names and
    shapes (no weights are drawn at this size)."""
    want = {k: tuple(v.shape) for k, v in
            flatten(jax_build_model(jax_get_config(name)).specs()).items()}
    got = {k: tuple(v.shape) for k, v in flatten(build_model(get_config(name)).specs()).items()}
    assert got == want


# ---------------------------------------------------------------------------
# the port's batch generators


def test_masked_lm_batch_distribution():
    """15% of positions masked (within 5 standard deviations), inputs at
    ``mask_id`` exactly there, labels -1 exactly elsewhere, and the masked
    positions' labels put back give a sample of the chain."""
    vocab, B, S = 64, 64, 256
    chain = tsyn.MarkovLM(vocab)
    b = tsyn.masked_lm_batch(chain, 0, 3, B, S, vocab - 1, device="cpu")
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (B, S) and toks.dtype == labels.dtype == torch.int64
    mask = labels >= 0
    rate = mask.float().mean().item()
    assert abs(rate - 0.15) < 5 * np.sqrt(0.15 * 0.85 / (B * S)), rate
    assert torch.all(toks[mask] == vocab - 1)
    assert torch.all(labels[~mask] == -1)
    seq = torch.where(mask, labels, toks).numpy()
    succ = chain.succ
    for a, c in zip(seq[:, :-1].ravel(), seq[:, 1:].ravel()):
        assert c in succ[a]
    again = tsyn.masked_lm_batch(chain, 0, 3, B, S, vocab - 1, device="cpu")
    assert torch.equal(again["tokens"], toks) and torch.equal(again["labels"], labels)
    other = tsyn.masked_lm_batch(chain, 0, 4, B, S, vocab - 1, device="cpu")
    assert not torch.equal(other["labels"] >= 0, mask)


def test_vision_batch_distribution():
    """Shapes and types; labels in range; each image is its class prototype
    (scale 0.5, the same at every step of one seed, another for another
    seed) plus unit noise."""
    N, P, C, B = 16, 48, 10, 256
    protos = tsyn._prototypes(0, C, N, P, torch.device("cpu"))
    assert protos.shape == (C, N, P) and abs(protos.std().item() - 0.5) < 0.02
    for step in (0, 1):
        b = tsyn.vision_batch(0, step, B, N, P, C, device="cpu")
        assert b["patches"].shape == (B, N, P) and b["patches"].dtype == torch.float32
        assert b["labels"].dtype == torch.int64
        assert 0 <= b["labels"].min() and b["labels"].max() < C
        noise = b["patches"] - protos[b["labels"]]
        assert abs(noise.mean().item()) < 0.01 and abs(noise.std().item() - 1.0) < 0.01
    other = tsyn.vision_batch(1, 0, B, N, P, C, device="cpu")
    noise = other["patches"] - protos[other["labels"]]
    assert noise.std().item() > 1.05  # seed 1 has prototypes of its own
    ref = jax_vision_batch(0, 0, B, N, P, C)  # the reference: the same moments
    ref_noise = np.asarray(ref["patches"]).std()
    assert abs(ref_noise - float(tsyn.vision_batch(0, 0, B, N, P, C, device="cpu")
                                 ["patches"].std())) < 0.02


@pytest.mark.parametrize("arch", ["bert", "deit", "gpt"])
def test_make_batch_fn_follows_the_family(arch):
    tc = TrainConfig(batch_size=2, seq_len=32)
    cfg = {"bert": bert_proxy(), "deit": deit_proxy(), "gpt": gpt_proxy()}[arch]
    b = make_batch_fn(cfg, tc, device="cpu")(0)
    if arch == "deit":
        assert b["patches"].shape == (2, tvit.n_patches(cfg), tvit.patch_dim(cfg))
        assert b["labels"].shape == (2,)
    elif arch == "bert":
        mask = b["labels"] >= 0
        assert b["tokens"].shape == (2, 32) and torch.all(b["tokens"][mask] == cfg.vocab_size - 1)
    else:
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_batches_without_cuda_and_without_device_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.masked_lm_batch(tsyn.MarkovLM(16), 0, 0, 1, 4, 15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.vision_batch(0, 0, 1, 4, 12, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch_fn(bert_proxy(), TrainConfig())


# ---------------------------------------------------------------------------
# FLOPs of the ViT step and the energy model


def test_vit_flops_match_reference_and_charge_tc_seq_len():
    """The reference charges a ViT step at the ``seq`` it is given (the
    V-cycle passes ``tc.seq_len``), not at N + 1: the port copies that."""
    jcfg, tcfg = jax_get_config("deit-b"), get_config("deit-b")
    js, ts = jax_build_model(jcfg).specs(), build_model(tcfg).specs()
    for seq in (64, 197):
        assert tflops.train_step_flops(tcfg, ts, 64, seq) == \
            jflops.train_step_flops(jcfg, js, 64, seq)
    assert tflops.train_step_flops(tcfg, ts, 64, 64) < tflops.train_step_flops(tcfg, ts, 64, 197)


def test_energy_report_matches_reference():
    assert set(tflops.DEVICES) == set(jflops.DEVICES)
    for name, dev in jflops.DEVICES.items():
        assert dataclasses.asdict(tflops.DEVICES[name]) == dataclasses.asdict(dev)
        for flops in (1.0, 3.7e15, 2.5e19):
            for kw in ({}, dict(utilization=0.9, pue=1.3, grid_kgco2_per_kwh=0.2)):
                assert tflops.energy_report(flops, name, **kw) == \
                    jflops.energy_report(flops, name, **kw)
    assert tflops.DEVICES["h100"].peak_flops == 989e12
    assert tflops.DEVICES["h100"].tdp_watts == 700.0
    for bad in (dict(utilization=0.0), dict(pue=0.9), dict(grid_kgco2_per_kwh=-1.0)):
        with pytest.raises(ValueError):
            tflops.EnergyModel(tflops.DEVICES["h100"], **bad)
    with pytest.raises(ValueError):
        tflops.DevicePower("x", peak_flops=1.0, tdp_watts=1.0, idle_frac=1.0)
