"""The port's V-cycle against the JAX reference, on the CPU, at f32.

* ``segments``, ``History.smoothed``, ``flops_to_reach``,
  ``saving_vs_baseline`` and the FLOPs functions equal the reference's.
* A 2-level ``run_vcycle`` and ``run_scratch`` on ``gpt_proxy`` (seq 256,
  ``attn_block_k=64``: the flash route), fed the reference's own batches
  through numpy from the same initial weights, follow the reference's loss
  trace: the same (flops, step, level) entries and losses within 1e-5
  (f32 over 17 steps; 9.5e-7 measured), with Adam's ``eps`` at 1e-4 for the
  reason given in ``tests/test_torch_train.py``.  So do 3-level V-cycles at
  alpha 0.25 and 0.5 and the Appendix E variants, and the paper's BERT and
  DeiT arms on their reference batches (MLM; class-conditional patches).
* ``MarkovLM``: the chain's tables are bit-identical; the port's sampler
  matches the chain's transition probabilities within a chi-square bound.
* The entry points raise when there is no CUDA card and no device is given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import bert_proxy as jax_bert_proxy
from repro.configs.paper_models import deit_proxy as jax_deit_proxy
from repro.configs.paper_models import gpt_proxy as jax_gpt_proxy
from repro.core import flops as jflops
from repro.core import vcycle as jvc
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.data.synthetic import masked_lm_batch as jax_masked_lm_batch
from repro.data.synthetic import vision_batch as jax_vision_batch
from repro.models.vit import n_patches as jax_n_patches
from repro.models.vit import patch_dim as jax_patch_dim
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference
from repro_torch.config import MultiLevelConfig as TML
from repro_torch.config import TrainConfig as TTC
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import bert_proxy, deit_proxy, gpt_proxy
from repro_torch.core import flops as tflops
from repro_torch.core import operators as tops
from repro_torch.core import vcycle as tvc
from repro_torch.data import synthetic as tsyn
from repro_torch.models.api import build_model
from helpers import tiny_hybrid
from test_torch_ssm import one_thread, torch_cfg  # noqa: F401 (one_thread: autouse)


def test_segments_match_reference():
    for steps, ea, es, K in [(40, 0.05, 0.5, 2), (300, 0.033, 0.5, 2), (10, 0.2, 0.5, 3),
                             (7, 0.0, 0.9, 2)]:
        kw = dict(n_levels=K, e_a_frac=ea, e_small_frac=es)
        want = jvc.segments(None, JML(**kw), JTC(steps=steps), final_steps=None)
        got = tvc.segments(None, TML(**kw), TTC(steps=steps))
        assert [(s.phase, s.level, s.steps) for s in got] == \
            [(s.phase, s.level, s.steps) for s in want]
    assert [s.steps for s in tvc.segments(None, TML(e_a_frac=0.05), TTC(steps=40))] == \
        [2, 20, 40]


def _hist(mod, rng, n, drop=0.0):
    h = mod.History()
    loss = 5.0
    for i in range(n):
        loss = loss * (0.97 - drop) + 0.05 * rng.standard_normal()
        h.log(1e9 * (i + 1), loss, i + 1, i % 2)
    return h


def test_history_metrics_match_reference():
    for seed in range(3):
        base_j, base_t = (_hist(m, np.random.default_rng(seed), 30) for m in (jvc, tvc))
        ours_j, ours_t = (_hist(m, np.random.default_rng(seed + 7), 30, 0.02)
                          for m in (jvc, tvc))
        for w in (1, 5):
            for a, b in zip(base_t.smoothed(w), base_j.smoothed(w)):
                np.testing.assert_array_equal(a, b)
            assert tvc.flops_to_reach(ours_t, 3.0, w) == jvc.flops_to_reach(ours_j, 3.0, w)
            assert tvc.saving_vs_baseline(base_t, ours_t, w) == \
                jvc.saving_vs_baseline(base_j, ours_j, w)
        assert base_t.to_dict() == base_j.to_dict()
    short_t, short_j = (_hist(m, np.random.default_rng(0), 3) for m in (jvc, tvc))
    assert tvc.flops_to_reach(short_t, -1.0) is None is jvc.flops_to_reach(short_j, -1.0)


@pytest.mark.parametrize("name", ["gpt-base", "tinyllama-1.1b", "gpt-proxy", "bert-large",
                                  "deit-b", "phi3.5-moe-42b-a6.6b", "qwen3-4b", "xlstm-125m",
                                  "tiny_hybrid", "deepseek-v3-671b"])
def test_flops_match_reference(name):
    """Recurrent layers are charged 6 * mamba_d_inner * mamba_d_state per
    token, xLSTM's included: the reference's code, not its comment (NH *
    dh^2), reproduced on purpose."""
    if name == "gpt-proxy":
        jcfg, tcfg = jax_gpt_proxy(), gpt_proxy()
    elif name == "tiny_hybrid":  # Mamba beside attention (tests/helpers.py)
        jcfg = tiny_hybrid()
        tcfg = torch_cfg(jcfg)
    else:
        jcfg, tcfg = jax_get_config(name), get_config(name)
    for _ in range(2):  # the level and the level below it
        js, ts = jax_build_model(jcfg).specs(), build_model(tcfg).specs()
        for b, s in [(8, 1024), (2, 256)]:
            assert tflops.train_step_flops(tcfg, ts, b, s) == \
                jflops.train_step_flops(jcfg, js, b, s)
            assert tflops.model_flops_reference(tcfg, ts, b * s) == \
                jflops.model_flops_reference(jcfg, js, b * s)
        assert tflops.total_params(ts) == jflops.total_params(js)
        assert tflops.active_matmul_params(tcfg, ts) == jflops.active_matmul_params(jcfg, js)
        if name == "xlstm-125m":  # no attention: the recurrent term alone
            rec = tflops.forward_flops(tcfg, ts, 1, 1) - 2.0 * tflops.active_matmul_params(
                tcfg, ts)
            assert rec == tcfg.n_layers * 6.0 * tcfg.mamba_d_inner * tcfg.mamba_d_state
        jcfg = jvc.plans_lib.build_plan(jcfg, JML()).small_cfg
        tcfg = tops.coalesce_config(tcfg, TML())


SEQ, BATCH = 256, 2
KW = dict(steps=10, warmup_steps=2, peak_lr=3e-3, batch_size=BATCH, seq_len=SEQ,
          log_every=1, eps=1e-4)
MLKW = dict(n_levels=2, alpha=0.25, e_a_frac=0.2, e_small_frac=0.5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt_proxy(d_model=64, n_layers=2, vocab=256).replace(
        compute_dtype=jnp.float32, attn_block_k=64, attn_impl="blockwise")
    tcfg = gpt_proxy(d_model=64, n_layers=2, vocab=256).replace(
        compute_dtype=torch.float32, attn_block_k=64, attn_impl="blockwise", remat="full")
    chain = JMarkovLM(256)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, BATCH, SEQ))
    batches = [jax.tree.map(np.asarray, sample(g)) for g in range(24)]
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, batches, init


def _port_batch_fn(batches):
    return lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}


def _same_trace(got, want, atol=1e-5):
    assert got.level == want.level and got.step == want.step
    np.testing.assert_allclose(got.flops, want.flops, rtol=1e-12)
    np.testing.assert_allclose(got.loss, want.loss, atol=atol, rtol=0)


def _vcycle_traces(setup, mlkw):
    """(runner, the port's output, the reference's output) of one V-cycle
    from the same weights on the same batches."""
    jcfg, tcfg, batches, init = setup
    want = jvc.run_vcycle(jcfg, JML(**mlkw), JTC(**KW),
                          lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0)
    runner = tvc.VCycleRunner(tcfg, TML(**mlkw), TTC(**KW), _port_batch_fn(batches),
                              device="cpu")
    got = runner.run(state=tvc.VCycleState(), params=from_reference(init, tcfg))
    _same_trace(got.history, want.history)
    assert got.total_flops == want.total_flops
    return runner, got, want


def test_two_level_vcycle_follows_the_reference_trace(setup):
    runner, got, _ = _vcycle_traces(setup, MLKW)
    assert [(s.phase, s.level, s.steps) for s in runner.plan] == \
        [("down", 0, 2), ("up", 1, 5), ("final", 0, 10)]
    assert got.history.level == [0] * 2 + [1] * 5 + [0] * 10
    assert runner.n_compiles == 2
    assert [c.d_model for c in got.configs] == [64, 32]
    assert got.history.loss[-1] < got.history.loss[0]


@pytest.mark.parametrize("mlkw,levels", [
    (dict(MLKW, n_levels=3), [0] * 2 + [1] * 2 + [2] * 5 + [1] * 5 + [0] * 10),
    (dict(MLKW, n_levels=3, alpha=0.5), [0] * 2 + [1] * 2 + [2] * 5 + [1] * 5 + [0] * 10),
    (dict(MLKW, width_variant="adj", depth_variant="stack"), [0] * 2 + [1] * 5 + [0] * 10),
], ids=["3-level-alpha0.25", "3-level-alpha0.5", "appendixE-adj-stack"])
def test_vcycle_variants_follow_the_reference_trace(setup, mlkw, levels):
    """Three levels at the paper's two interpolation ratios, and the
    Appendix E variants (adjacent-pair width merge, stacked depth merge)."""
    runner, got, _ = _vcycle_traces(setup, mlkw)
    assert got.history.level == levels
    n = mlkw["n_levels"]
    assert runner.n_compiles == n
    assert [c.d_model for c in got.configs] == [64, 32, 16][:n]


# the paper's other arms: BERT under its Table 1 schedule and a wider,
# deeper BERT under the Table 4 three-level schedule (MLM batches), DeiT
# under the Table 3 schedule (class-conditional patches, seq = N + 1)
ML_BERT = dict(n_levels=2, alpha=0.5, e_a_frac=0.05, e_small_frac=0.5)
ML_TABLE4 = dict(n_levels=3, alpha=0.5, e_a_frac=0.05, e_small_frac=0.35)
ML_GPT = dict(n_levels=2, alpha=0.25, e_a_frac=0.05, e_small_frac=0.5)
ARMS = {"bert-table1": ("bert", dict(d_model=64, n_layers=4), ML_BERT, 16),
        "bert-table4-3level": ("bert", dict(d_model=96, n_layers=8), ML_TABLE4, 20),
        "deit-table3": ("deit", dict(d_model=64, n_layers=2), ML_GPT, 16)}


@pytest.mark.parametrize("arm", ARMS)
def test_paper_arm_vcycle_follows_the_reference_trace(arm):
    family, size, mlkw, n_entries = ARMS[arm]
    jproxy, tproxy = {"bert": (jax_bert_proxy, bert_proxy),
                      "deit": (jax_deit_proxy, deit_proxy)}[family]
    jcfg = jproxy(**size).replace(compute_dtype=jnp.float32)
    tcfg = tproxy(**size).replace(compute_dtype=torch.float32)
    if family == "bert":
        seq, chain = 64, JMarkovLM(jcfg.vocab_size)
        raw = [jax_masked_lm_batch(chain, 0, g, BATCH, seq, jcfg.vocab_size - 1)
               for g in range(n_entries)]
    else:
        N, P = jax_n_patches(jcfg), jax_patch_dim(jcfg)
        seq = N + 1
        raw = [jax_vision_batch(0, g, 4, N, P, jcfg.n_classes) for g in range(n_entries)]
    batches = [jax.tree.map(np.asarray, b) for b in raw]
    tc = dict(KW, seq_len=seq, batch_size=len(batches[0]["labels"]))
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    want = jvc.run_vcycle(jcfg, JML(**mlkw), JTC(**tc),
                          lambda g: jax.tree.map(jnp.asarray, batches[g]), seed=0)
    port_batch = lambda g: {k: torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i"
                                                         else np.float32))
                            for k, v in batches[g].items()}
    runner = tvc.VCycleRunner(tcfg, TML(**mlkw), TTC(**tc), port_batch, device="cpu")
    got = runner.run(state=tvc.VCycleState(), params=from_reference(init, tcfg))
    assert len(got.history.loss) == n_entries
    _same_trace(got.history, want.history)
    assert got.total_flops == want.total_flops
    assert runner.n_compiles == mlkw["n_levels"]


def test_run_scratch_follows_the_reference_trace(setup):
    jcfg, tcfg, batches, init = setup
    tc = dict(KW, steps=6)
    model = build_model(tcfg)
    _, _, got, _, _ = tvc.train_segment(model, TTC(**tc), _port_batch_fn(batches), 6,
                                        params=from_reference(init, tcfg), device="cpu")
    jmodel = jax_build_model(jcfg)
    _, _, want, _, _ = jvc.train_segment(jmodel, JTC(**tc),
                                         lambda g: jax.tree.map(jnp.asarray, batches[g]), 6,
                                         params=jax.tree.map(jnp.asarray, init))
    _same_trace(got, want)
    _, hist = tvc.run_scratch(tcfg, TTC(**tc), _port_batch_fn(batches), steps=2,
                              device="cpu")
    assert hist.step == [1, 2] and all(np.isfinite(hist.loss))


def test_markov_chain_tables_are_bit_identical():
    for vocab, branch, seed in [(256, 4, 1234), (50257, 4, 1234), (17, 3, 5)]:
        j, t = JMarkovLM(vocab, branch, seed), tsyn.MarkovLM(vocab, branch, seed)
        np.testing.assert_array_equal(t.succ, np.asarray(j.succ))
        np.testing.assert_array_equal(t.probs, np.asarray(j.probs))
        assert t.probs.dtype == np.asarray(j.probs).dtype
        assert t.entropy() == j.entropy()
    assert tsyn.chain_entropy(256) == JMarkovLM(256).entropy()


def test_markov_sampler_matches_the_transition_probabilities():
    """Pearson chi-square of the (token -> next) counts of 64 x 400 sampled
    transitions against the chain's probabilities (a successor listed twice
    for one token gets their summed probability).  The bound is the degrees
    of freedom plus 5 standard deviations of the chi-square distribution."""
    vocab = 16
    chain = tsyn.MarkovLM(vocab)
    toks = tsyn.lm_batch(chain, 0, 0, 64, 400, device="cpu")["tokens"].numpy()
    counts = np.zeros((vocab, vocab))
    np.add.at(counts, (toks[:, :-1].ravel(), toks[:, 1:].ravel()), 1)
    expect = np.zeros((vocab, vocab))
    for a in range(vocab):
        for c in range(chain.branch):
            expect[a, chain.succ[a, c]] += chain.probs[a, c]
    expect *= counts.sum(1, keepdims=True)
    assert np.all(counts[expect == 0] == 0)  # only listed successors occur
    cells = expect > 0
    chi2 = float((((counts - expect) ** 2)[cells] / expect[cells]).sum())
    dof = int(cells.sum()) - vocab
    assert chi2 < dof + 5 * np.sqrt(2 * dof), (chi2, dof)


def test_lm_batch_is_a_function_of_seed_step_shard():
    chain = tsyn.MarkovLM(64)
    a = tsyn.lm_batch(chain, 3, 7, 4, 32, device="cpu")
    b = tsyn.lm_batch(chain, 3, 7, 4, 32, device="cpu")
    c = tsyn.lm_batch(chain, 3, 8, 4, 32, device="cpu")
    d = tsyn.lm_batch(chain, 3, 7, 4, 32, shard=1, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"]) and not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].shape == (4, 32) and a["tokens"].dtype == torch.int64


def test_entry_points_without_cuda_and_without_device_raise(monkeypatch, setup):
    _, tcfg, batches, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bf = _port_batch_fn(batches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvc.run_vcycle(tcfg, TML(**MLKW), TTC(**KW), bf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvc.run_scratch(tcfg, TTC(**KW), bf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvc.VCycleRunner(tcfg, TML(**MLKW), TTC(**KW), bf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.lm_batch(tsyn.MarkovLM(16), 0, 0, 1, 4)
