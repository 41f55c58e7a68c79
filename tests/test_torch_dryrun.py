"""The dry run's parts held to the reference on the CPU (one intra-op
thread; anything that makes a fake process group runs in a subprocess).

* ``launch/op_cost.py`` against ``repro/launch/hlo_cost.py`` on the cases
  of the reference's ``tests/test_hlo_cost.py``: one matmul exactly, a
  gradient at 3x its forward, a write into a slice at twice the update.
* One step of each family, unsharded, at f32 with the plain kernels on
  meta tensors, against ``analyze_text`` of the reference's compiled step.
  The dense, BERT, DeiT and MLA steps lie within 1% (``FLOP_TOL``); the
  others are pinned at their measured ratio (``PINNED``, each with its
  reason).  Parameter counts and ``model_flops_reference`` are equal for
  every registered config.
* The six kernels' meta forms: the plain versions' output shapes and
  types, and each ``*_cost`` against its closed form.
* The counter's collective tally on a fake 1x2 mesh against two gloo
  ranks running the same train and decode steps.
* ``lower_cell`` on a fake 2x4 mesh, one full-size cell on 16x16, and the
  CLI's resume.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTC
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import PAPER_CONFIGS as J_PAPER
from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import bert_proxy as jax_bert_proxy
from repro.configs.paper_models import deit_proxy as jax_deit_proxy
from repro.core import flops as jflops
from repro.launch.hlo_cost import analyze_text
from repro.models import vit as jvit
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_prefill_step as jax_prefill
from repro.models.api import make_serve_step as jax_serve
from repro.models.api import make_train_step as jax_train
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.config import SHAPES, TrainConfig
from repro_torch.configs import ASSIGNED, cell_is_skipped, get_config
from repro_torch.configs.paper_models import bert_proxy, deit_proxy
from repro_torch.core import flops as tflops
from repro_torch.kernels import coalesce_pair as cp
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import interp_axpy as ia
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.op_cost import count_step
from repro_torch.models.api import (build_model, make_prefill_step, make_serve_step,
                                    make_train_step)
from repro_torch.optim import adamw_init
from repro_torch.param import tree_map
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 300  # the suite's other workers share the host
FLOP_TOL = 0.01
B, S, T = 2, 32, 64

# (family, step) -> (port / reference FLOPs, why they differ)
PINNED = {
    ("xlstm-125m", "train"): (
        1.0310834813499112,
        "the backward of the recurrent time loops: the forward, prefill and decode "
        "agree exactly, and so does the port's one-step meta scan with its real loop"),
    ("jamba-1.5-large-398b", "train"): (
        0.8313578706591807,
        "the reference's _conv_flops takes a kernel's last dim as its output features, "
        "which holds for the forward's WIO kernel only: the depthwise conv's backward "
        "convolutions (kernels laid out 0oi and i0o, feature_group_count 128) count "
        "64-140x their work there, 52.9 M of its 315.2 M"),
}
FAMILIES = [("tinyllama-1.1b", k) for k in ("train", "prefill", "decode")] + \
    [("deepseek-v3-671b", k) for k in ("train", "prefill", "decode")] + \
    [("bert", "train"), ("deit", "train"), ("phi3.5-moe-42b-a6.6b", "train"),
     ("xlstm-125m", "train"), ("jamba-1.5-large-398b", "train"),
     ("llama-3.2-vision-11b", "prefill"), ("whisper-large-v3", "train")]


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


# ---------------------------------------------------------------------------
# op_cost against hlo_cost


def test_a_single_matmul_counts_exactly():
    w = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    ref = analyze_text(jax.jit(lambda w: w @ w).lower(w).compile().as_text())["flops"]
    _, c = count_step(lambda w: w @ w, torch.empty(256, 256, device="meta"))
    assert c.flops == 2 * 256 ** 3
    assert c.flops == pytest.approx(ref, rel=FLOP_TOL)
    assert c.bytes == 3 * 256 * 256 * 4  # two operands and the result


def test_a_gradient_counts_three_forwards():
    w, x = jax.ShapeDtypeStruct((128, 128), jnp.float32), jax.ShapeDtypeStruct((32, 128),
                                                                                  jnp.float32)
    loss = lambda w, x: jnp.sum((x @ w) ** 2)
    j_fwd = analyze_text(jax.jit(loss).lower(w, x).compile().as_text())["flops"]
    j_bwd = analyze_text(jax.jit(jax.grad(loss, argnums=(0, 1))).lower(w, x)
                         .compile().as_text())["flops"]
    tw = torch.empty(128, 128, device="meta", requires_grad=True)
    tx = torch.empty(32, 128, device="meta", requires_grad=True)
    _, fwd = count_step(lambda w, x: ((x @ w) ** 2).sum(), tw, tx)
    _, bwd = count_step(lambda w, x: torch.autograd.grad(((x @ w) ** 2).sum(), (w, x)), tw, tx)
    assert bwd.flops == 3 * fwd.flops == pytest.approx(j_bwd, rel=FLOP_TOL)
    assert fwd.flops == pytest.approx(j_fwd, rel=FLOP_TOL)


def test_a_write_into_a_slice_counts_twice_the_update():
    big, upd = jax.ShapeDtypeStruct((4096, 512), jnp.float32), jax.ShapeDtypeStruct(
        (1, 512), jnp.float32)

    def jf(b, u):
        def body(c, i):
            return jax.lax.dynamic_update_slice(c, u, (i, 0)), None
        return jax.lax.scan(body, b, jnp.arange(100))[0]

    ref = analyze_text(jax.jit(jf, donate_argnums=(0,)).lower(big, upd).compile().as_text())

    def tf(b, u):
        for i in range(100):
            b[i:i + 1] = u
        return b

    _, c = count_step(tf, torch.empty(4096, 512, device="meta"), torch.empty(1, 512, device="meta"))
    assert c.bytes == 100 * 2 * 512 * 4
    assert ref["bytes"] < 100 * 4096 * 512 * 4 / 10  # the reference's own bound
    _, c = count_step(lambda b, u: b.index_put_((torch.tensor([7]),), u),
                      torch.empty(4096, 512, device="meta"), torch.empty(1, 512, device="meta"))
    assert c.by_op["index_put_"]["bytes"] == 2 * 512 * 4


# ---------------------------------------------------------------------------
# steps against the reference


def _cfgs(name):
    if name == "bert":
        return jax_bert_proxy(d_model=64, n_layers=2), bert_proxy(d_model=64, n_layers=2)
    if name == "deit":
        return jax_deit_proxy(d_model=64, n_layers=2), deit_proxy(d_model=64, n_layers=2)
    return jax_get_config(name, smoke=True), get_config(name, smoke=True)


def _extras(jc, lead):
    """The VLM's and the encoder-decoder's extra inputs: (reference, meta)."""
    out = {}
    if jc.family == "vlm":
        out["img_embeds"] = lead + (jc.n_image_tokens, jc.vision_dim or jc.d_model)
    if jc.family == "audio":
        out["enc_frames"] = lead + (jc.encoder_seq, jc.d_model)
    return ({k: jnp.zeros(v, jnp.float32) for k, v in out.items()},
            {k: torch.empty(v, device="meta") for k, v in out.items()})


def _step_flops(name, kind):
    jc, tc = _cfgs(name)
    jc = jc.replace(compute_dtype=jnp.float32)
    tc = tc.replace(compute_dtype=torch.float32, kernel_backend="torch")
    jm, tm = jax_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or torch.float32,
                                        device="meta"), tm.specs())
    long = lambda *sh: torch.empty(sh, dtype=torch.long, device="meta")
    if kind == "train":
        jt, tt = JTC(batch_size=B, seq_len=S), TrainConfig(batch_size=B, seq_len=S)
        if jc.family == "vit":
            n, d = jvit.n_patches(jc), jvit.patch_dim(jc)
            jb = {"patches": jnp.zeros((B, n, d), jnp.float32), "labels": jnp.zeros((B,), jnp.int32)}
            tb = {"patches": torch.empty(B, n, d, device="meta"), "labels": long(B)}
        else:
            jx, tx = _extras(jc, (B,))
            jb = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32),
                  **jx}
            tb = {"tokens": long(B, S), "labels": long(B, S), **tx}
        text = jax.jit(jax_train(jm, jt)).lower(jp, jax_adamw_init(jp, jt), jb).compile()
        _, c = count_step(make_train_step(tm, tt), tp, adamw_init(tp, tt), tb)
    elif kind == "prefill":
        jx, tx = _extras(jc, (B,))
        text = jax.jit(jax_prefill(jm)).lower(jp, jnp.zeros((B, S), jnp.int32), **jx).compile()
        _, c = count_step(make_prefill_step(tm), tp, long(B, S), **tx)
    else:
        jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype or jnp.float32),
                              jm.cache_specs(B, T), is_leaf=lambda x: hasattr(x, "axes"))
        text = jax.jit(jax_serve(jm)).lower(jp, jcache, jnp.zeros((B, 1), jnp.int32),
                                            jnp.zeros((B,), jnp.int32)).compile()
        tcache = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or torch.float32,
                                                device="meta"), tm.cache_specs(B, T))
        _, c = count_step(make_serve_step(tm), tp, tcache, long(B, 1), long(B))
    return c.flops, analyze_text(text.as_text())["flops"]


@pytest.mark.parametrize("name,kind", FAMILIES)
def test_step_flops_match_the_reference(name, kind):
    got, want = _step_flops(name, kind)
    ratio, why = PINNED.get((name, kind), (1.0, "within FLOP_TOL"))
    assert got / want == pytest.approx(ratio, rel=FLOP_TOL if ratio == 1.0 else 1e-6), why


@pytest.mark.parametrize("name", list(J_ASSIGNED) + list(J_PAPER))
def test_params_and_model_flops_equal_the_reference(name):
    jc, tc = jax_get_config(name), get_config(name)
    js, ts = jax_build_model(jc).specs(), build_model(tc).specs()
    assert tflops.total_params(ts) == jflops.total_params(js)
    for train in (True, False):
        assert tflops.model_flops_reference(tc, ts, 4096.0, train=train) == \
            jflops.model_flops_reference(jc, js, 4096.0, train=train)


def test_cells_and_shapes_match_the_reference():
    from repro.config import SHAPES as J_SHAPES
    from repro.configs import cell_is_skipped as j_skipped

    assert ASSIGNED == list(J_ASSIGNED)
    assert {k: (s.kind, s.seq_len, s.global_batch) for k, s in SHAPES.items()} == \
        {k: (s.kind, s.seq_len, s.global_batch) for k, s in J_SHAPES.items()}
    for arch in ASSIGNED:
        for shape in SHAPES:
            assert cell_is_skipped(arch, shape) == j_skipped(arch, shape)
    assert sum(bool(cell_is_skipped(a, s)) for a in ASSIGNED for s in SHAPES) == 8


# ---------------------------------------------------------------------------
# the kernels' meta forms and costs


def _pairs(B, S, T, H, causal, off):
    return B * H * (S * off + S * (S + 1) / 2) if causal else B * H * S * T


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 48), (False, 0)])
@pytest.mark.parametrize("dims", [(1, 64, 112, 4, 2, 64, 64), (2, 16, 64, 8, 8, 192, 128)])
def test_flash_costs_equal_their_closed_forms(dims, causal, off):
    Bq, Sq, Tk, H, KH, D, Dv = dims
    if not causal:
        off = 0
    p = _pairs(Bq, Sq, Tk, H, causal, off)
    q, o, kv, st = Bq * Sq * H * D, Bq * Sq * H * Dv, Bq * Tk * KH * (D + Dv), 4 * Bq * H * Sq
    kw = dict(causal=causal, q_offset=off)
    assert fa.flash_fwd_cost(*dims, **kw) == (2.0 * (D + Dv) * p, 2 * (q + kv + o) + st)
    assert fa.flash_bwd_dq_cost(*dims, **kw) == (2.0 * (2 * D + Dv) * p,
                                                 2 * (2 * q + kv + 2 * o) + 2 * st)
    assert fa.flash_bwd_dkv_cost(*dims, **kw) == (4.0 * (D + Dv) * p,
                                                  2 * (q + o + 2 * kv) + 2 * st)
    assert fa.flash_fwd_cost(*dims, itemsize=4, **kw)[1] == 4 * (q + kv + o) + st


def test_the_other_costs_equal_their_closed_forms():
    lengths = [5, 0, 40]
    B_, KH, G, D, P, M = 3, 2, 4, 64, 16, 3
    n = sum(lengths)
    want_bytes = 2 * n * KH * D * 2 + 2 * B_ * KH * G * D * 2 + 8 * (1 + 0 + 3) + 8 * B_
    assert pa.paged_attention_decode_cost(B_, KH, G, D, P, M, lengths) == \
        (4.0 * n * KH * G * D, want_bytes)
    assert pa.paged_attention_decode_cost(B_, KH, G, D, P, M, None)[0] == 4.0 * 3 * 48 * KH * G * D
    assert cp.coalesce_pair_cost((768, 50304), 0) == (768 * 50304, 4 * 1.5 * 768 * 50304)
    assert ia.interp_axpy_cost(50304 * 768) == (3.0 * 50304 * 768, 12 * 50304 * 768)


def _plain_and_meta():
    g = torch.Generator().manual_seed(0)
    r = lambda *sh: torch.randn(sh, generator=g)
    q, k, v = r(2, 40, 4, 64), r(2, 40, 2, 64), r(2, 40, 2, 64)
    out, lse = fa.flash_attention_torch(q, k, v, causal=True, q_offset=0)
    do = r(*out.shape)
    pq, kp, vp = r(3, 2, 2, 64), r(9, 16, 2, 64), r(9, 16, 2, 64)
    tables = torch.tensor([[1, 2], [3, 4], [5, 6]])
    lengths = torch.tensor([5, 0, 20])
    w, a, b = r(8, 6), r(5, 7), r(5, 7)
    return [
        ("flash_attention", (q, k, v), dict(causal=True)),
        ("flash_attention_bwd", (q, k, v, out, lse, do), dict(causal=True)),
        ("paged_attention_decode", (pq, kp, vp, tables, lengths), {}),
        ("coalesce_pair", (w,), dict(axis=0)),
        ("interp_axpy", (a, b, 0.25), {}),
    ]


@pytest.mark.parametrize("case", range(5))
def test_meta_forms_give_the_plain_versions_shapes_and_report_their_cost(case):
    op, args, kw = _plain_and_meta()[case]
    plain = dispatch.dispatch(op, *args, **kw)
    margs = tuple(_meta(a) if isinstance(a, torch.Tensor) else a for a in args)
    assert dispatch.resolve_backend(op, torch.device("meta")) == "meta"
    seen = []
    with kcost.recording(lambda *rec: seen.append(rec)):
        meta = dispatch.dispatch(op, *margs, **kw)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    assert [(t.shape, t.dtype) for t in as_tuple(meta)] == \
        [(t.shape, t.dtype) for t in as_tuple(plain)]
    assert all(t.device.type == "meta" for t in as_tuple(meta))
    names = {"flash_attention": ["flash_attention_fwd"],
             "flash_attention_bwd": ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]}
    assert [s[0] for s in seen] == names.get(op, [op]) and all(s[3] == 1 for s in seen)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.dispatch(op, *margs, backend="cuda", **kw)
    with pytest.raises(ValueError, match="needs meta tensors"):
        dispatch.dispatch(op, *args, backend="meta", **kw)


# ---------------------------------------------------------------------------
# fake process groups, in processes of their own

FAKE_SRC = '''
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch.config import MeshConfig, SHAPES
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.launch import dryrun
import collectives_case
what = sys.argv[1]
if what == "tally":
    mesh = make_fake_mesh(MeshConfig((1, 2)), rank=0)
    print(json.dumps(collectives_case.run(mesh, "meta")))
elif what == "smoke":
    from repro_torch.configs import get_config
    mesh = make_fake_mesh(MeshConfig((2, 4)), rank=0)
    # the reduced configs at a head dim the flash kernels take
    recs = {s: dryrun.lower_cell(a, SHAPES[s], mesh, verbose=False,
                                 cfg=get_config(a, smoke=True).replace(head_dim=64))
            for a, s in (("tinyllama-1.1b", "train_4k"), ("deepseek-v3-671b", "decode_32k"),
                         ("jamba-1.5-large-398b", "prefill_32k"))}
    print(json.dumps(recs))
elif what == "logits":
    # Qwen3-4B's train_4k on 16x16 (reduced to 3 layers of d 64 with its
    # vocabulary, and at full size), with the logits split through the loss
    # and, as before, gathered whole
    from repro_torch.configs import get_config
    from repro_torch.models import api, lm as lm_lib
    mesh = make_production_mesh()
    cfgs = {"reduced": get_config("qwen3-4b", smoke=True).replace(
                vocab_size=151936, head_dim=64, remat="full"),
            "full": get_config("qwen3-4b")}
    split_loss = api.Model.loss

    def gathered_loss(self, params, batch, z_loss=0.0):
        out = lm_lib.lm_forward(params, batch["tokens"], self.cfg, mode="train")
        return lm_lib.lm_loss(out["logits"], batch["labels"], self.cfg, out["aux"],
                              z_loss=z_loss)

    recs = {}
    for form, loss in (("split", split_loss), ("gathered", gathered_loss)):
        api.Model.loss = loss
        for size, cfg in cfgs.items():
            recs[f"{size}/{form}"] = dryrun.lower_cell("qwen3-4b", SHAPES["train_4k"], mesh,
                                                       verbose=False, cfg=cfg)
    api.Model.loss = split_loss

    # its prefill_32k reduced: the last position's block of logits gathered,
    # and, as before, every position's gathered and the last one read
    def gathered_prefill(model):
        @torch.inference_mode()
        def step(params, tokens, img_embeds=None, enc_frames=None):
            out = lm_lib.lm_forward(params, tokens, model.cfg, mode="prefill",
                                    img_embeds=img_embeds, enc_frames=enc_frames)
            return out["logits"][:, -1, :], out["caches"]

        return step

    for form, make in (("split", api.make_prefill_step), ("gathered", gathered_prefill)):
        dryrun.make_prefill_step = make
        recs[f"prefill/{form}"] = dryrun.lower_cell("qwen3-4b", SHAPES["prefill_32k"], mesh,
                                                    verbose=False, cfg=cfgs["reduced"])
    print(json.dumps(recs))
else:
    rec = dryrun.lower_cell("tinyllama-1.1b", SHAPES["decode_32k"], make_production_mesh(),
                            verbose=False)
    print(json.dumps(rec))
'''

# one train step and one decode step of a tiny dense model on a 1x2 mesh,
# counted, on meta tensors (the fake group) or on the CPU (gloo)
CASE_SRC = '''
import torch
from repro_torch.config import BlockSpec, ModelConfig, TrainConfig, uniform_stages
from repro_torch.distributed.sharding import mesh_ctx, param_shardings
from repro_torch.launch import specs
from repro_torch.launch.dryrun import serve_rules
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.api import build_model, make_serve_step, make_train_step
from repro_torch.distributed.sharding import RULES
from repro_torch.param import init_tree, tree_map
from repro_torch.optim import adamw_init


def run(mesh, device):
    cfg = ModelConfig(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256,
                      stages=uniform_stages(2, BlockSpec("attn", "dense")), qk_norm=True,
                      remat="full", attn_impl="plain", compute_dtype=torch.float32)
    model = build_model(cfg)
    tc = TrainConfig(batch_size=2, seq_len=16, grad_accum=2)
    out = {}
    for kind in ("train", "decode"):
        rules = RULES if kind == "train" else serve_rules()
        blocks = specs.local_tree(model.specs(), mesh, rules, dtype=torch.float32)
        if device != "meta":
            blocks = tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator()
                                                    .manual_seed(1)), blocks)
        c = OpCounter()
        if kind == "train":
            batch = {k: torch.zeros((2, 1, 16), dtype=torch.long, device=device)
                     for k in ("tokens", "labels")}
            opt = adamw_init(blocks, tc)
            c.add_arguments(blocks, opt, batch)
            with c:
                res = make_train_step(model, tc, mesh=mesh)(blocks, opt, batch)
        else:
            caches = specs.local_tree(model.cache_specs(2, 32), mesh, rules, dtype=torch.float32)
            if device != "meta":
                caches = tree_map(lambda t: torch.zeros(t.shape), caches)
            toks = torch.zeros((2, 1), dtype=torch.long, device=device)
            pos = torch.full((2,), 20, dtype=torch.long, device=device)
            c.add_arguments(blocks, caches, toks, pos)
            with c, mesh_ctx(mesh, dense_serving=True):
                res = make_serve_step(model)(blocks, caches, toks, pos)
        c.finish(res)
        out[kind] = {"collectives": c.collective_totals(), "flops": c.flops}
    return out
'''

GLOO_SRC = '''
import json, os, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_distributed, make_host_mesh
import collectives_case
rank = int(os.environ["RANK"])
init_distributed(os.environ["COORD"], 2, rank, device="cpu")
res = collectives_case.run(make_host_mesh(1, 2, device="cpu"), "cpu")
if rank == 0:
    print("RESULT " + json.dumps(res))
'''


def _env(tmp):
    (tmp / "collectives_case.py").write_text(CASE_SRC)
    return dict(os.environ, PYTHONPATH=os.pathsep.join(("src", str(tmp))), OMP_NUM_THREADS="1")


def _python(src, *args, env):
    return subprocess.Popen([sys.executable, "-c", src, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _result(p, timeout=TIMEOUT, marker=None):
    out, _ = p.communicate(timeout=timeout)
    assert p.returncode == 0, out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if marker:
        lines = [ln[len(marker):] for ln in lines if ln.startswith(marker)]
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The fake-group processes and the two gloo ranks, run together."""
    tmp = tmp_path_factory.mktemp("fake")
    env = _env(tmp)
    procs = {w: _python(FAKE_SRC, w, env=env) for w in ("tally", "smoke", "full", "logits")}
    coord = f"file://{tmp / 'gloo.coord'}"  # rank 0 writes the port it binds there
    gloo = [_python(GLOO_SRC, env=dict(env, RANK=str(r), COORD=coord)) for r in range(2)]
    try:
        res = {w: _result(p) for w, p in procs.items()}
        res["gloo"] = _result(gloo[0], marker="RESULT ")
        out, _ = gloo[1].communicate(timeout=TIMEOUT)
        assert gloo[1].returncode == 0, out
    finally:
        for p in list(procs.values()) + gloo:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_the_fake_mesh_counts_the_collectives_two_gloo_ranks_make(fake_runs, kind):
    fake, real = fake_runs["tally"][kind], fake_runs["gloo"][kind]
    assert fake["collectives"] == real["collectives"]
    assert fake["collectives"]["total"]["count"] > 0
    assert fake["flops"] == real["flops"]


REC_KEYS = {"arch", "shape", "mesh", "rank", "status", "trace_s", "memory", "collectives",
            "roofline", "params", "kernels"}


def _finite(rec):
    r = rec["roofline"]
    return all(np.isfinite(r[k]) for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                                           "useful_flops_ratio", "step_time_s"))


def test_lower_cell_on_a_fake_2x4_mesh(fake_runs):
    for shape, rec in fake_runs["smoke"].items():
        assert set(rec) == REC_KEYS and rec["status"] == "ok" and rec["mesh"] == "2x4"
        assert rec["shape"] == shape and _finite(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "alias_bytes", "peak_bytes_est", "fits"}
        assert rec["roofline"]["n_devices"] == 8 and rec["roofline"]["flops_per_device"] > 0
    # the flash kernels' meta forms report their costs on the train and prefill paths
    train, prefill = fake_runs["smoke"]["train_4k"], fake_runs["smoke"]["prefill_32k"]
    assert set(train["kernels"]) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"}
    assert set(prefill["kernels"]) == {"flash_attention_fwd"}
    assert fake_runs["smoke"]["decode_32k"]["kernels"] == {}


def test_a_full_size_decode_cell_on_16x16(fake_runs):
    """TinyLlama-1.1B at decode_32k (batch 128 of 32768 positions): 8 rows
    a rank, each holding 2048 positions of every K/V head."""
    rec = fake_runs["full"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and _finite(rec)
    assert rec["memory"]["fits"] is True
    layers, kv = 22, 4 * 64
    cache = 2 * layers * 8 * 2048 * kv * 2  # K and V, bf16
    assert rec["memory"]["argument_bytes"] > cache
    assert rec["trace_s"] < 60


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_the_split_loss_fits_qwen3_4b_train_4k_on_16x16(fake_runs, size):
    """The logits stay split over "model" through the loss: Qwen3-4B's
    train_4k cell fits 80 GiB a device on 16x16 (99.6 GiB with the logits
    gathered whole), and the peak falls by at least 15/16 of one
    microbatch's gathered logits in the compute dtype (a rank keeps 1/16 of
    them)."""
    split, gathered = (fake_runs["logits"][f"{size}/{f}"] for f in ("split", "gathered"))
    assert split["status"] == gathered["status"] == "ok"
    rows = 256 // 16 // 2  # train_4k's 256 rows over 16 data ranks, 2 microbatches
    logits = rows * 4096 * 151936 * 2  # bf16
    drop = gathered["memory"]["peak_bytes_est"] - split["memory"]["peak_bytes_est"]
    assert drop >= 15 / 16 * logits, (drop / 2**30, logits / 2**30)
    if size == "full":
        assert split["memory"]["fits"] is True and gathered["memory"]["fits"] is False
    print(f"[qwen3-4b {size}] peak {gathered['memory']['peak_bytes_est'] / 2**30:.1f} -> "
          f"{split['memory']['peak_bytes_est'] / 2**30:.1f} GiB a device")


def test_the_prefill_gathers_the_last_position_only_on_16x16(fake_runs):
    """Qwen3-4B's prefill_32k reduced (3 layers of d 64, its vocabulary) on
    16x16: a device's 2 rows of 32768 positions keep their logits split
    over "model" up to the last position, so the peak falls by at least
    15/16 of the logits gathered whole in the compute dtype (a rank keeps
    1/16 of them), as the reference's sharded prefill keeps them."""
    split, gathered = (fake_runs["logits"][f"prefill/{f}"] for f in ("split", "gathered"))
    assert split["status"] == gathered["status"] == "ok"
    cfg = get_config("qwen3-4b", smoke=True).replace(vocab_size=151936)
    rows = SHAPES["prefill_32k"].global_batch // 16
    logits = rows * SHAPES["prefill_32k"].seq_len * cfg.padded_vocab * 2  # bf16
    drop = gathered["memory"]["peak_bytes_est"] - split["memory"]["peak_bytes_est"]
    assert drop >= 15 / 16 * logits, (drop / 2**30, logits / 2**30)
    print(f"[qwen3-4b reduced prefill_32k] peak {gathered['memory']['peak_bytes_est'] / 2**30:.2f}"
          f" -> {split['memory']['peak_bytes_est'] / 2**30:.2f} GiB a device")


def test_the_cli_resumes_without_rerunning_an_ok_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "xlstm-125m",
           "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)]
    first = subprocess.run(cmd, cwd=ROOT, env=env, text=True, capture_output=True,
                           timeout=TIMEOUT)
    assert first.returncode == 0, first.stdout + first.stderr
    rec = json.loads((tmp_path / "dryrun.json").read_text())
    key = "xlstm-125m|decode_32k|16x16"
    assert rec[key]["status"] == "ok"
    second = subprocess.run(cmd, cwd=ROOT, env=env, text=True, capture_output=True,
                            timeout=TIMEOUT)
    assert second.returncode == 0 and f"{key} ..." not in second.stdout
    assert json.loads((tmp_path / "dryrun.json").read_text()) == rec


def test_cells_skipped_on_the_cli_are_recorded(tmp_path):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b",
           "--shape", "long_500k", "--mesh", "single", "--out", str(tmp_path)]
    done = subprocess.run(cmd, cwd=ROOT, env=env, text=True, capture_output=True,
                          timeout=TIMEOUT)
    assert done.returncode == 0, done.stdout + done.stderr
    rec = json.loads((tmp_path / "dryrun.json").read_text())
    assert rec["qwen3-4b|long_500k|16x16"]["status"] == "skipped"
