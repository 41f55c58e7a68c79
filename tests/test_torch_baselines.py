"""The port's five baselines (``core/baselines.py``) against the JAX
reference, on the CPU, at f32.

Each ``BASELINES[name]`` runs on ``bert_proxy(d_model=64, n_layers=4)``
(seq 64, batch 2) under the paper's Table 1 schedule (``ML_BERT``: 2
levels, alpha 0.5), 2 small and 2 final steps (and 2 LiGO fit steps), on
the reference's own MLM batches.  The whole ``History`` must match: the same
(flops, step, level) entries, so every FLOPs charge is the reference's, and
losses within 1e-5.  The reference draws its initial parameters inside each
baseline, so here ``Model.init`` of the port returns, for each config, the
reference's initial tree for the same config and seed, bridged across.
Adam's ``eps`` is 1e-4 for the reason given in ``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.paper_models import bert_proxy as jax_bert_proxy
from repro.core import baselines as jbl
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import masked_lm_batch as jax_masked_lm_batch
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference
from repro_torch.config import MultiLevelConfig as TML
from repro_torch.config import TrainConfig as TTC
from repro_torch.configs.paper_models import bert_proxy
from repro_torch.core import baselines as tbl
from repro_torch.models import api as tapi
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

SEQ, BATCH = 64, 2
KW = dict(steps=4, warmup_steps=1, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
          log_every=1, eps=1e-4)
ML_BERT = dict(n_levels=2, alpha=0.5, e_a_frac=0.05, e_small_frac=0.5)
RUN_KW = {"ligo": dict(fit_steps=2)}


def _jax_cfg(t):
    """The reference's ModelConfig with the port config's fields."""
    kw = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            v = getattr(jnp, str(v).split(".")[-1])
        elif f.name == "stages":
            v = tuple(jconfig.Stage(pattern=tuple(jconfig.BlockSpec(b.mixer, b.ffn)
                                                  for b in s.pattern), repeats=s.repeats)
                      for s in v)
        kw[f.name] = v
    return jconfig.ModelConfig(**kw)


@pytest.fixture(scope="module")
def arena():
    jcfg = jax_bert_proxy(d_model=64, n_layers=4).replace(compute_dtype=jnp.float32)
    tcfg = bert_proxy(d_model=64, n_layers=4).replace(compute_dtype=torch.float32)
    chain = JMarkovLM(jcfg.vocab_size)
    batches = [jax.tree.map(np.asarray, jax_masked_lm_batch(
        chain, 0, g, BATCH, SEQ, jcfg.vocab_size - 1)) for g in range(6)]
    return jcfg, tcfg, batches


@pytest.fixture
def reference_init(monkeypatch):
    """``Model.init`` of the port returns the reference's init (seed 0)."""
    cache = {}

    def init(self, gen):
        key = repr(self.cfg)
        if key not in cache:
            cache[key] = jax.tree.map(np.asarray, jax_build_model(_jax_cfg(self.cfg)).init(
                jax.random.PRNGKey(0)))
        return from_reference(cache[key], self.cfg, device=gen.device)

    monkeypatch.setattr(tapi.Model, "init", init)


def test_registry_matches_reference():
    assert set(tbl.BASELINES) == set(jbl.BASELINES)


@pytest.mark.parametrize("name", sorted(jbl.BASELINES))
def test_baseline_history_follows_the_reference(name, arena, reference_init):
    jcfg, tcfg, batches = arena
    kw = dict(small_steps=2, final_steps=2, **RUN_KW.get(name, {}))
    want = jbl.BASELINES[name](jcfg, jconfig.MultiLevelConfig(**ML_BERT),
                               jconfig.TrainConfig(**KW),
                               lambda g: jax.tree.map(jnp.asarray, batches[g]), **kw)
    got = tbl.BASELINES[name](
        tcfg, TML(**ML_BERT), TTC(**KW),
        lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()},
        device="cpu", **kw)
    assert got.level == want.level and got.step == want.step
    np.testing.assert_allclose(got.flops, want.flops, rtol=1e-12)
    np.testing.assert_allclose(got.loss, want.loss, atol=1e-5, rtol=0)
    assert len(got.loss) == 4 + 2 * (name == "ligo")
    assert all(np.isfinite(got.loss)) and np.all(np.diff(got.flops) > 0)


@pytest.mark.parametrize("name", sorted(jbl.BASELINES))
def test_baselines_without_cuda_and_without_device_raise(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbl.BASELINES[name](bert_proxy(), TML(), TTC(), lambda g: None)
