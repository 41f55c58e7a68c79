"""The port's model stack against the JAX reference, on the CPU, at f32.

Norms, RoPE, the FFN, ``gqa_apply``, ``lm_forward`` prefill (logits and
caches), one paged decode step and one prefix-extend step are compared with
the reference functions on the same weights (moved across with
``repro_torch.bridge``) and the same inputs, at atol 1e-4.  Two configs: the
TinyLlama smoke config (SwiGLU, RMSNorm, GQA, untied head) and ``gpt_proxy``
(biases, LayerNorm, GELU, tied embeddings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import gpt_proxy as jax_gpt_proxy
from repro.launch.serve import make_write_prompt as jax_write_prompt
from repro.launch.serve import zeros_paged_cache as jax_zeros_paged_cache
from repro.layers import attention as jattn
from repro.layers import basic as jbasic
from repro.layers import ffn as jffn
from repro.models import lm as jlm
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_paged_decode_step as jax_paged_step
from repro.models.api import make_prefill_step as jax_prefill_step

from repro_torch.bridge import from_reference, to_reference
from repro_torch.config import BlockSpec, uniform_stages
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import gpt_proxy
from repro_torch.launch.serve import make_write_prompt, zeros_paged_cache
from repro_torch.layers import attention as tattn
from repro_torch.layers import basic as tbasic
from repro_torch.layers import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model, make_paged_decode_step, make_prefill_step
from repro_torch.param import flatten
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _cfgs(name):
    """(reference config, port config), both at f32 compute."""
    if name == "tinyllama":
        return (jax_get_config("tinyllama-1.1b", smoke=True).replace(
                    compute_dtype=jnp.float32, attn_block_k=64),
                get_config("tinyllama-1.1b", smoke=True).replace(
                    compute_dtype=torch.float32, attn_block_k=64))
    return (jax_gpt_proxy(n_layers=2).replace(compute_dtype=jnp.float32),
            gpt_proxy(n_layers=2).replace(compute_dtype=torch.float32))


def _params(jcfg, tcfg, seed=0):
    """Reference init with every vector leaf (norm scales, biases) perturbed
    so the bias/scale code paths see non-trivial values; both trees."""
    rng = np.random.default_rng(seed)
    vectors = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in vectors else v for k, v in tree.items()}

    tree = perturb(jax.tree.map(np.asarray,
                                jax_build_model(jcfg).init(jax.random.PRNGKey(seed))))
    return jax.tree.map(jnp.asarray, tree), from_reference(tree, tcfg)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.fixture(scope="module", params=["tinyllama", "gpt"])
def arch(request):
    jcfg, tcfg = _cfgs(request.param)
    jp, tp = _params(jcfg, tcfg)
    return request.param, jcfg, tcfg, jp, tp


def _block0(params):
    return params["stages"]["stage_0"]["b0"]


# ---------------------------------------------------------------------------
# layers


def test_norms_match_reference(arch):
    _, jcfg, tcfg, jp, tp = arch
    x = np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jn = jax.tree.map(lambda a: a[0], _block0(jp)["norm1"])
    tn = {k: v[0] for k, v in _block0(tp)["norm1"].items()}
    _close(tbasic.norm_apply(tn, torch.from_numpy(x), tcfg),
           jbasic.norm_apply(jn, jnp.asarray(x), jcfg))
    _close(tbasic.rms_norm(torch.from_numpy(x), tn["scale"], 1e-5),
           jbasic.rms_norm(jnp.asarray(x), jn["scale"], 1e-5))


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(-1, 300, size=(2, 7))
    _close(tbasic.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jbasic.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_ffn_matches_reference(arch):
    _, jcfg, tcfg, jp, tp = arch
    x = np.random.default_rng(3).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jf = jax.tree.map(lambda a: a[0], _block0(jp)["ffn"])
    tf = {k: v[0] for k, v in _block0(tp)["ffn"].items()}
    _close(tffn.ffn_apply(tf, torch.from_numpy(x), tcfg),
           jffn.ffn_apply(jf, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("S", [20, 200])  # plain route; flash route when the
def test_gqa_apply_prefill_matches_reference(arch, S):  # config allows it
    _, jcfg, tcfg, jp, tp = arch
    x = 0.5 * np.random.default_rng(4).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    jm = jax.tree.map(lambda a: a[0], _block0(jp)["mixer"])
    tm = {k: v[0] for k, v in _block0(tp)["mixer"].items()}
    got, _ = tattn.gqa_apply(tm, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos.copy()), causal=True)
    want, _ = jattn.gqa_apply(jm, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                              causal=True)
    _close(got, want)


# ---------------------------------------------------------------------------
# whole model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def test_prefill_logits_and_caches_match_reference(arch):
    name, jcfg, tcfg, jp, tp = arch
    toks = _tokens(jcfg, (2, 150 if name == "tinyllama" else 30), 5)
    want = jlm.lm_forward(jp, jnp.asarray(toks), jcfg, mode="prefill")
    got = tlm.lm_forward(tp, torch.from_numpy(toks), tcfg, mode="prefill")
    _close(got["logits"], want["logits"])
    wc, gc = flatten(want["caches"]), flatten(got["caches"])
    assert set(wc) == set(gc)
    for key in wc:
        assert tuple(gc[key].shape) == wc[key].shape
        _close(gc[key], wc[key])


def test_paged_decode_and_extend_match_reference(arch):
    """Prefill a prompt, scatter it into pages, then one batched decode step
    (one live row, one idle row) and one left-padded extend step over a
    prefix-shared table; logits and page pools after each step."""
    _, jcfg, tcfg, jp, tp = arch
    P, n_pages, L = 8, 16, 19
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    prompt = _tokens(jcfg, (1, L), 6)
    jl, jpc = jax_prefill_step(jmodel)(jp, jnp.asarray(prompt))
    tl, tpc = make_prefill_step(tmodel)(tp, torch.from_numpy(prompt))
    _close(tl, jl)
    ids = np.array([3, 5, 6])
    jpages = jax_write_prompt(P)(jax_zeros_paged_cache(jcfg, n_pages, P), jpc,
                                 jnp.asarray(ids))
    tpages = make_write_prompt(P)(zeros_paged_cache(tcfg, n_pages, P, "cpu"), tpc,
                                  torch.from_numpy(ids))

    def step(toks, pos, bt):
        nonlocal jpages, tpages
        jlog, jpages = jax_paged_step(jmodel)(jp, jpages, *(jnp.asarray(a) for a in
                                                            (toks, pos, bt)))
        tlog, tpages = make_paged_decode_step(tmodel)(tp, tpages, *(torch.from_numpy(a)
                                                                    for a in (toks, pos, bt)))
        _close(tlog, jlog)
        for key, want in flatten(jpages).items():
            _close(flatten(tpages)[key], want)

    # decode: row 0 at position L through its table, row 1 idle (length 0)
    step(np.array([[7], [0]]), np.array([[L], [-1]]),
         np.array([[3, 5, 6, 0], [0, 0, 0, 0]]))
    # extend: 11 new tokens after 16 shared positions, left-padded to 16
    toks = np.zeros((1, 16), np.int64)
    toks[0, 5:] = _tokens(jcfg, (11,), 7)
    pos = np.full((1, 16), -1)
    pos[0, 5:] = np.arange(16, 27)
    step(toks, pos, np.array([[3, 5, 9, 10]]))


# ---------------------------------------------------------------------------
# weight bridge, configs, init


def test_bridge_round_trip_keeps_names_shapes_values(arch):
    _, jcfg, tcfg, jp, tp = arch
    want = flatten(jax.tree.map(np.asarray, jp))
    back = flatten(to_reference(tp, tcfg))
    assert list(back) == list(want)
    for key in want:
        assert back[key].shape == want[key].shape
        np.testing.assert_array_equal(back[key], want[key])
    assert "stages/stage_0/b0/mixer/wq" in want and "embed/tok" in want


def test_bridge_rejects_renamed_and_reshaped_leaves(arch):
    _, jcfg, tcfg, jp, _ = arch
    tree = jax.tree.map(np.asarray, jp)
    renamed = dict(tree, final_norm={"gain": tree["final_norm"]["scale"]})
    with pytest.raises(ValueError, match="leaf names"):
        from_reference(renamed, tcfg)
    reshaped = dict(tree, final_norm=dict(tree["final_norm"],
                                          scale=tree["final_norm"]["scale"][:-1]))
    with pytest.raises(ValueError, match="leaf shapes"):
        from_reference(reshaped, tcfg)
    with pytest.raises(ValueError, match="leaf names"):
        to_reference({"embed": {}}, tcfg)


def test_bridge_carries_bf16_leaves():
    jcfg, tcfg = _cfgs("tinyllama")
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = from_reference(tree, tcfg)
    leaf = tp["stages"]["stage_0"]["b0"]["mixer"]["wq"]
    assert leaf.dtype == torch.bfloat16
    want = tree["stages"]["stage_0"]["b0"]["mixer"]["wq"].astype(np.float32)
    np.testing.assert_array_equal(leaf.float().numpy(), want)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "tinyllama-smoke", "gpt-proxy",
                                  "gpt-base", "bert-base"])
def test_configs_are_copies_of_the_reference(name):
    if name == "tinyllama-smoke":
        j, t = jax_get_config("tinyllama-1.1b", smoke=True), get_config("tinyllama-1.1b",
                                                                        smoke=True)
    elif name == "gpt-proxy":
        j, t = jax_gpt_proxy(), gpt_proxy()
    else:
        j, t = jax_get_config(name), get_config(name)
    for f in dataclasses.fields(t):
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(getattr(t, f.name)).split(".")[-1] == \
                jnp.dtype(getattr(j, f.name)).name
        elif f.name == "stages":
            assert [(s.repeats, [(b.mixer, b.ffn) for b in s.pattern]) for s in t.stages] \
                == [(s.repeats, [(b.mixer, b.ffn) for b in s.pattern]) for s in j.stages]
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.padded_vocab == j.padded_vocab and t.n_layers == j.n_layers
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_init_tree_follows_specs_and_generator():
    _, tcfg = _cfgs("tinyllama")
    model = build_model(tcfg)
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    specs = flatten(model.specs())
    for key, leaf in flatten(a).items():
        assert tuple(leaf.shape) == specs[key].shape and leaf.dtype == torch.float32
        assert torch.equal(leaf, flatten(b)[key])
    wq = a["stages"]["stage_0"]["b0"]["mixer"]["wq"]
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.1  # fan_in = E
    assert torch.all(a["final_norm"]["scale"] == 1.0)


def test_build_model_rejects_what_is_not_ported():
    gpt = get_config("gpt-base")
    # the VLM's image layers, Whisper's decoder blocks and its encoder stack
    # are ported: their specs are the reference's
    for cfg in (gpt.replace(stages=uniform_stages(2, BlockSpec("cross_attn", "dense"))),
                gpt.replace(stages=uniform_stages(2, BlockSpec("dec_attn", "dense"))),
                gpt.replace(n_encoder_layers=2)):
        j = jax_get_config("gpt-base").replace(
            stages=tuple(jconfig.Stage(tuple(jconfig.BlockSpec(b.mixer, b.ffn)
                                             for b in st.pattern), st.repeats)
                         for st in cfg.stages), n_encoder_layers=cfg.n_encoder_layers)
        got = {k: tuple(s.shape) for k, s in flatten(build_model(cfg).specs()).items()}
        want = {k: tuple(s.shape) for k, s in flatten(jax_build_model(j).specs()).items()}
        assert got == want
    # selective remat builds the reference's specs; a name neither package
    # knows is refused
    got = {k: tuple(s.shape) for k, s in
           flatten(build_model(gpt.replace(remat="dots")).specs()).items()}
    want = {k: tuple(s.shape) for k, s in flatten(jax_build_model(
        jax_get_config("gpt-base").replace(remat="dots")).specs()).items()}
    assert got == want
    with pytest.raises(NotImplementedError, match="remat"):
        build_model(gpt.replace(remat="offload"))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        build_model(get_config("tinyllama-1.1b", smoke=True).replace(kernel_backend="pallas"))
