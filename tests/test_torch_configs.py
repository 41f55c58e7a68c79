"""The configs the port carries, against the reference's, on the CPU.

One parametrised test over the registered reference configs, all of which
the port implements (TinyLlama-1.1B, Phi-3.5-MoE, Qwen3-4B, Qwen3-14B,
Command-R-35B, xLSTM-125m, DeepSeek-V3 with MLA and its MTP head,
Jamba-1.5-Large, Llama-3.2-Vision-11B, Whisper-large-v3):

- ``get_config(name)`` and ``get_config(name, smoke=True)`` equal the
  reference's field for field (dtypes by name);
- the full config's spec tree has the reference's leaf names and shapes,
  the assigned hyperparameters and a parameter count near the advertised
  size (the port's copies of ``tests/test_arch_smoke.py``'s pins);
- at smoke size and f32, from the reference's weights and the same seeded
  numpy batch (with seeded image embeddings or encoder frames for the
  cross-attention families), one AdamW step's loss (within 1e-5) and one
  decode step's logits against a dense cache (within 1e-4) match the
  reference; the VLM's gradient norm is held to a float64 evaluation of
  both packages instead (``F64_CHECKED``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.core.flops import total_params as jax_total_params
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_serve_step as jax_make_serve_step
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw as jadamw
from repro.param import is_spec as jax_is_spec

from repro_torch.bridge import from_reference
from repro_torch.config import TrainConfig
from repro_torch.configs import _MODULES, get_config
from repro_torch.core.flops import total_params
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model, make_serve_step, make_train_step
from repro_torch.optim import adamw as tadamw
from repro_torch.param import flatten, zeros_tree
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

# tests/test_arch_smoke.py's assigned hyperparameters and advertised sizes
PINS = {
    "phi3.5-moe-42b-a6.6b": (dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
                                  vocab_size=32064, n_experts=16, moe_top_k=2),
                             (38e9, 46e9)),
    "tinyllama-1.1b": (dict(n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
                            vocab_size=32000), (0.9e9, 1.3e9)),
    "qwen3-4b": (dict(n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
                      vocab_size=151936, qk_norm=True), (3e9, 5e9)),
    "qwen3-14b": (dict(n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
                       vocab_size=151936, qk_norm=True), (12e9, 17e9)),
    "command-r-35b": (dict(n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
                           vocab_size=256000, use_bias=False), (30e9, 40e9)),
    "xlstm-125m": (dict(n_layers=12, d_model=768, n_heads=4, d_ff=0, vocab_size=50304),
                   (0.08e9, 0.2e9)),
    "deepseek-v3-671b": (dict(n_layers=61, d_model=7168, n_heads=128, vocab_size=129280,
                              n_experts=256, moe_top_k=8, moe_d_ff=2048),
                         (600e9, 740e9)),
    "jamba-1.5-large-398b": (dict(n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
                                  vocab_size=65536, n_experts=16, moe_top_k=2),
                             (350e9, 440e9)),
    "llama-3.2-vision-11b": (dict(n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
                                  d_ff=14336, vocab_size=128256), (8e9, 13e9)),
    "whisper-large-v3": (dict(n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
                              d_ff=5120, vocab_size=51866, n_encoder_layers=32),
                         (1.2e9, 2.0e9)),
}

# the mLSTM's f32 gradients are as far from a float64 evaluation in the
# reference as in the port (tests/test_torch_ssm.py): xLSTM-125m's smoke grad
# norm (302 at init) differs by 1.8e-4 of its value
METRIC_RTOL = {("xlstm-125m", "grad_norm"): 1e-3}
# the VLM's grad norm (228 at init) is its zero-init gate's gradient, a sum
# of the image layer's output over every token, and the two packages' f32
# sums part at 3e-6 of it, a gap that moves with the host's SIMD width.  It
# is held instead to a float64 evaluation (``_f64_grad_norms``): the port's
# f32 norm must lie no further from the reference's f64 norm than twice the
# larger of the reference's own f32 distance and a fixed floor of
# ``F64_FLOOR`` of that norm.  Both f64 evaluations keep some f32 islands
# (rotary tables, attention scores) and part at 4.0e-7 of it; the floor
# covers that, and the port's f64 norm is held to the reference's within the
# same floor.  Measured: port 1.4e-6, reference 4.4e-6.
F64_CHECKED = {("llama-3.2-vision-11b", "grad_norm")}
F64_FLOOR = 1e-6


def _f64_grad_norms(jcfg, tcfg, weights, batch):
    """The reference's and the port's gradient norms of the loss, each
    package evaluated with float64 parameters, inputs and compute dtype."""
    with jax.enable_x64(True):
        jc = jcfg.replace(compute_dtype=jnp.float64)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), weights)
        jb = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
              for k, v in batch.items()}
        g = jax.jit(jax.grad(lambda p: jax_build_model(jc).loss(p, jb)[0]))(jp)
        ref = float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                                for x in jax.tree.leaves(g))))
    tc = tcfg.replace(compute_dtype=torch.float64)
    tp = from_reference(weights, tc, dtype=torch.float64)
    leaves = list(flatten(tp).values())
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v.astype(np.float64 if v.dtype == np.float32 else np.int64))
          for k, v in batch.items()}
    loss, _ = build_model(tc).loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    port = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    return ref, port


def _same_cfg(t, j):
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name == "stages":
            assert [(s.repeats, [(x.mixer, x.ffn) for x in s.pattern]) for s in a] == \
                [(s.repeats, [(x.mixer, x.ffn) for x in s.pattern]) for s in b]
        else:
            assert a == b, f.name


def _shapes(specs, spec_pred):
    out = {}

    def rec(t, path):
        if spec_pred(t):
            out["/".join(path)] = tuple(t.shape)
            return
        for k, v in t.items():
            rec(v, path + (k,))

    rec(specs, ())
    return out


def test_registry_carries_the_five_configs():
    assert sorted(_MODULES) == sorted(PINS)


@pytest.mark.parametrize("name", sorted(PINS))
def test_config_matches_the_reference(name):
    # field for field, full and smoke
    for smoke in (False, True):
        _same_cfg(get_config(name, smoke=smoke), jax_get_config(name, smoke=smoke))
    assert get_config(name, smoke=True).name == get_config(name).name
    # the full config's spec tree, pins and parameter count
    full, jfull = get_config(name), jax_get_config(name)
    specs, jspecs = build_model(full).specs(), jax_build_model(jfull).specs()
    got = {k: tuple(s.shape) for k, s in flatten(specs).items()}
    assert got == _shapes(jspecs, jax_is_spec)
    fields, (lo, hi) = PINS[name]
    for k, v in fields.items():
        assert getattr(full, k) == v, k
    n = total_params(specs)
    assert n == jax_total_params(jspecs) and lo <= n <= hi
    # smoke size at f32: one AdamW step and one decode step
    jcfg = jax_get_config(name, smoke=True).replace(compute_dtype=jnp.float32)
    tcfg = get_config(name, smoke=True).replace(compute_dtype=torch.float32)
    weights = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (2, jcfg.n_image_tokens, jcfg.vision_dim)).astype(np.float32)
    if jcfg.family == "audio":
        batch["enc_frames"] = rng.standard_normal(
            (2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    kw = dict(steps=5, warmup_steps=1, peak_lr=1e-3, batch_size=2, seq_len=16, eps=1e-4)
    jtc, ttc = JTC(**kw), TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, weights)
    _, _, jm = jax.jit(jax_make_train_step(jax_build_model(jcfg), jtc))(
        jp, jadamw.adamw_init(jp, jtc), jax.tree.map(jnp.asarray, batch))
    tp = from_reference(weights, tcfg)
    _, _, tm = make_train_step(build_model(tcfg), ttc)(
        tp, tadamw.adamw_init(tp, ttc),
        {k: torch.from_numpy(v if v.dtype == np.float32 else v.astype(np.int64))
         for k, v in batch.items()})
    assert set(tm) >= set(jm) - {"lr"}
    for k in jm:
        if (name, k) in F64_CHECKED:
            truth, port64 = _f64_grad_norms(jcfg, tcfg, weights, batch)
            port_gap, ref_gap = abs(tm[k].item() - truth), abs(float(jm[k]) - truth)
            assert abs(port64 - truth) <= F64_FLOOR * truth, (k, truth, port64)
            assert port_gap <= 2 * max(ref_gap, F64_FLOOR * truth), \
                (k, tm[k].item(), float(jm[k]), truth, port64)
        elif k != "lr":
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=1e-5,
                                       rtol=METRIC_RTOL.get((name, k), 0), err_msg=k)
    # decode: one token a row at position 4 of an empty dense cache
    B, T = 2, 24
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype or jnp.float32),
                           jlm.cache_specs(jcfg, B, T), is_leaf=jax_is_spec)
    step_toks = rng.integers(0, jcfg.vocab_size, size=(B, 1))
    want, _ = jax.jit(jax_make_serve_step(jax_build_model(jcfg)))(
        jax.tree.map(jnp.asarray, weights), jcaches, jnp.asarray(step_toks),
        jnp.full((B,), 4, jnp.int32))
    tcaches = zeros_tree(tlm.cache_specs(tcfg, B, T), torch.float32, "cpu")
    got, _ = make_serve_step(build_model(tcfg))(
        from_reference(weights, tcfg), tcaches, torch.from_numpy(step_toks.astype(np.int64)),
        torch.full((B,), 4, dtype=torch.int64))
    assert got.shape == (B, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
