"""Context-parallel attention (the reference's ``"attn_seq"`` rule) in
training, on the CPU, held to the reference's UNSHARDED runs at f32.

* The flash op's plain versions with ``q_offset``: a chunk of C rows at
  offsets 0, mid and T - C of a causal sequence of T = 3C gives the rows
  of the reference's full causal attention (``repro/kernels/ref.py``) and
  their dq; the chunks' dk/dv summed give the full dk/dv (D 64 and 128).
* One spawn of three gloo ranks on ``--mesh 1x3`` (4 query heads, which 3
  does not divide, so the heads stay whole and the query sequence splits):
  one f32 train step of ``qwen3-14b``'s and ``whisper-large-v3``'s smoke
  configs (Qwen3's chunks of 130 rows through the flash op's route, causal
  at offsets 0/130/260; Whisper's encoder of 390 frames through it
  non-causally, its decoder of 48 tokens on the plain route, under
  ``remat="full"``) against the reference's step: loss, ``grad_norm``,
  gradients, parameters and AdamW moments within ``STEP_TOL`` as
  ``tests/test_torch_model_parallel.py`` holds its 1x2 step; the
  collectives a step equal the derivation (a sequence gather a CP layer,
  one more under remat, one fused backward sum a layer); a 2-level V-cycle
  (level 1 keeps 2 heads, still whole on 3) follows the reference's
  ``History``.  Pinned: a sequence that 3 does not divide takes no CP; the
  server's prefill on the mesh takes no CP; and each planted fault of
  ``scripts/cp_gaps.py`` breaks the match.
* A spawn of two ranks on ``--mesh 1x2`` beside it: Qwen3's 4 heads split
  there, so the head split is kept (no sequence gather) and the step still
  matches (the deliberate layout departure of ROADMAP Queue 3).

~60 s of worker time, most of it the reference's jit compiles.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.configs import get_config as jax_get_config
from repro.core import vcycle as jvc
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.kernels.ref import naive_attention as jax_naive_attention
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.bridge import from_reference, to_reference
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention_bwd_torch,
                                                 flash_attention_cuda, flash_attention_torch)
from repro_torch.models.api import build_model
from repro_torch.param import flatten, unflatten
from test_torch_model_parallel import STEP_TOL, _coordinator, _follows
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# seconds a spawn's ranks may take, from the end of the reference's work
# (they share the host with the suite's other workers)
TIMEOUT = 300
STEP_TC = dict(steps=4, warmup_steps=1, peak_lr=1e-3, batch_size=2, seq_len=390, eps=1e-4)
VC_TC = dict(steps=12, warmup_steps=1, peak_lr=3e-3, batch_size=4, seq_len=24, log_every=2,
             eps=1e-4)
VC_ML = dict(n_levels=2, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)
# the V-cycle's losses and final parameters, absolute.  This config (Qwen3's
# rope theta 1e6, peak_lr 3e-3, 21 steps) moves with the order of its f32
# sums: the port's ONE-process run parts from the reference's by 1.9e-6
# (losses) and 1.36e-5 (parameters), the 1x3 CP run from the one-process run
# by 9.5e-7 and 3.1e-6 and from the reference by 9.5e-7 and 1.11e-5
# (measured on the CPU, torch 2.13); each is held within about twice the
# largest of them
VC_TOL = 3e-5
# the kernels' plain versions against the reference's attention: the largest
# gap over max(1, max |want|) (measured: at most 5.2e-7, the chunks' dk/dv
# summed in another order than the whole sequence's)
ATT_TOL = 2e-6
CASES = ("qwen", "whisper", "qwen_s16")
FAULTS = ("offset", "input_sum", "swap")


# ---------------------------------------------------------------------------
# the flash op's plain versions at an offset

def _qkv(D, C=40, H=4, KH=2, seed=0):
    rng = np.random.default_rng(seed)
    T = 3 * C
    q = rng.standard_normal((1, T, H, D)).astype(np.float32)
    k = rng.standard_normal((1, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((1, T, KH, D)).astype(np.float32)
    do = rng.standard_normal((1, T, H, D)).astype(np.float32)
    return q, k, v, do


def _reference_full(q, k, v, do):
    """The reference's causal attention of the whole sequence ([B,T,H,D]
    layout, K/V broadcast over the groups) and its gradients."""
    G = q.shape[2] // k.shape[2]
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))

    def f(q, k, v):
        kh, vh = jnp.repeat(tr(k), G, axis=1), jnp.repeat(tr(v), G, axis=1)
        return jnp.transpose(jax_naive_attention(tr(q), kh, vh, causal=True), (0, 2, 1, 3))

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _gap(got, want) -> float:
    gap = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
    print(f"gap {gap:.2e}")
    return gap


def _chunk(q, k, v, do, off, C):
    t = torch.from_numpy
    qc, doc = t(q[:, off:off + C]).contiguous(), t(do[:, off:off + C]).contiguous()
    out, lse = flash_attention_torch(qc, t(k), t(v), causal=True, q_offset=off)
    dq, dk, dv = flash_attention_bwd_torch(qc, t(k), t(v), out, lse, doc, causal=True,
                                           q_offset=off)
    return out.numpy(), dq.numpy(), dk.numpy(), dv.numpy()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_a_chunk_at_an_offset_gives_the_reference_rows(D, where):
    C = 40
    q, k, v, do = _qkv(D, C)
    out, dq, _, _ = _reference_full(q, k, v, do)
    off = {"first": 0, "mid": C, "last": 2 * C}[where]
    got_out, got_dq, _, _ = _chunk(q, k, v, do, off, C)
    assert _gap(got_out, out[:, off:off + C]) <= ATT_TOL
    assert _gap(got_dq, dq[:, off:off + C]) <= ATT_TOL


@pytest.mark.parametrize("D", [64, 128])
def test_the_chunks_dk_dv_sum_to_the_reference_gradients(D):
    C = 40
    q, k, v, do = _qkv(D, C, seed=1)
    _, _, dk, dv = _reference_full(q, k, v, do)
    parts = [_chunk(q, k, v, do, off, C) for off in (0, C, 2 * C)]
    assert _gap(sum(p[2] for p in parts), dk) <= ATT_TOL
    assert _gap(sum(p[3] for p in parts), dv) <= ATT_TOL
    # the offset moves the mask: offset 0 on the last chunk's rows is another function
    t = torch.from_numpy
    wrong, _ = flash_attention_torch(t(q[:, 2 * C:]).contiguous(), t(k), t(v), causal=True)
    assert np.abs(wrong.numpy() - parts[2][0]).max() > 1e-2
    with pytest.raises(ValueError, match="q_offset"):  # before any device check
        flash_attention_cuda(t(q[:, :C]).contiguous(), t(k), t(v), causal=True,
                             q_offset=2 * C + 1)


# ---------------------------------------------------------------------------
# the spawned ranks

CFG_SRC = '''
def case_cfg(name, jax_side=False):
    if jax_side:
        import jax.numpy as jnp
        from repro.configs import get_config as gc
        f32 = jnp.float32
    else:
        from repro_torch.configs import get_config as gc
        f32 = torch.float32
    if name.startswith("qwen"):
        return gc("qwen3-14b", smoke=True).replace(compute_dtype=f32, attn_impl="blockwise",
                                                   attn_block_k=64)
    if name == "vc":
        return gc("qwen3-14b", smoke=True).replace(compute_dtype=f32, d_model=32, d_ff=96,
                                                   vocab_size=128)
    return gc("whisper-large-v3", smoke=True).replace(compute_dtype=f32, attn_impl="blockwise",
                                                      attn_block_k=64, encoder_seq=390,
                                                      remat="full")


def case_seq(name):
    return {"qwen": 390, "qwen_s16": 16, "whisper": 48}[name]
'''
exec(CFG_SRC)

WORKER = '''
import contextlib, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
from repro_torch.bridge import from_reference
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.distributed import (as_global_batch_fn, gather_global_tree, put_global_tree,
                                     tensor_parallel as tp)
from repro_torch.distributed.sharding import context_parallel_ways, mesh_ctx
from repro_torch.launch.mesh import init_distributed, make_cli_mesh
from repro_torch.launch.serve import make_server
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import build_model, make_train_step, train_state_shardings
from repro_torch.optim import adamw_init
from repro_torch.param import flatten, unflatten
import cp_gaps
''' + CFG_SRC + '''
assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"
mesh = make_cli_mesh(os.environ["MESH"], num_processes=N, device="cpu")
STEP_TC = eval(os.environ["STEP_TC"])


def step_case(name, fault=None):
    cfg = case_cfg(name)
    model = build_model(cfg)
    tc = TrainConfig(**STEP_TC)
    w = np.load(f"{OUT}/{name}_case.npz")
    params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
    batch = {k[2:]: torch.from_numpy(w[k]) for k in w.files if k[:2] == "b/"}
    psh, osh = train_state_shardings(model, tc, mesh)
    local = put_global_tree(params, psh, mesh)
    keys, leaves = list(flatten(local)), list(flatten(local).values())
    for p in leaves:
        p.requires_grad_(True)
    tp.reset_counts()
    with (cp_gaps.plant(fault) if fault else contextlib.nullcontext()):
        with mesh_ctx(mesh, train=True):
            loss, _ = model.loss(local, batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        grad_counts = tp.counts()
        for p in leaves:
            p.requires_grad_(False)
        step = make_train_step(model, tc, mesh=mesh)
        tp.reset_counts()
        local, opt, m = step(local, adamw_init(local, tc), batch)
    rec = {"metrics": {k: float(v) for k, v in m.items()}, "step_counts": tp.counts(),
           "grad_counts": grad_counts}
    if fault is None:
        whole = lambda t, sh: {k: v.detach() for k, v in
                               flatten(gather_global_tree(t, sh, mesh)).items()}
        rec.update(grads=whole(unflatten(dict(zip(keys, grads))), psh),
                   params=whole(local, psh), m=whole(opt["m"], osh["m"]),
                   v=whole(opt["v"], osh["v"]))
    return rec


for name in os.environ["CASES"].split(","):
    torch.save(step_case(name), f"{OUT}/{name}_{os.environ['MESH']}_rank{RANK}.pt")
if os.environ["MESH"] == "1x3":
    torch.save({f: step_case("qwen", f) for f in cp_gaps.FAULTS}, f"{OUT}/faults_rank{RANK}.pt")
    # the server's prefill on the mesh: no context parallelism
    cfg = case_cfg("qwen")
    w = np.load(f"{OUT}/qwen_case.npz")
    params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
    srv = make_server(cfg, batch=2, max_seq=512, page_size=16, device="cpu", mesh=mesh)
    srv.set_params(params)
    tokens = torch.from_numpy(w["b/tokens"][:1].astype(np.int64))
    seen = []
    srv._on_mesh(lambda: seen.append(context_parallel_ways(390)))()
    tp.reset_counts()
    logits, _ = srv.prefill(srv.params, tokens)
    one = lm_lib.lm_forward(params, tokens, cfg, mode="prefill")["logits"][:, -1]
    torch.save({"ways": seen, "counts": tp.counts(),
                "gap": float((logits - one).abs().max())}, f"{OUT}/serve_rank{RANK}.pt")
    # the V-cycle from the reference's init on the reference's batches
    arena = np.load(f"{OUT}/vc_arena.npz")
    INIT = unflatten({k[5:]: arena[k] for k in arena.files if k.startswith("init/")})
    BATCHES = [{k: arena[f"b{g}/{k}"] for k in ("tokens", "labels")} for g in range(21)]
    batch_fn = as_global_batch_fn(
        lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in BATCHES[g].items()},
        mesh)
    vcfg = case_cfg("vc")
    runner = VCycleRunner(vcfg, MultiLevelConfig(**eval(os.environ["VC_ML"])),
                          TrainConfig(**eval(os.environ["VC_TC"])), batch_fn, device="cpu",
                          mesh=mesh)
    params = put_global_tree(from_reference(INIT, vcfg), runner.level_shardings(0)[0], mesh)
    tp.reset_counts()
    out = runner.run(state=VCycleState(), params=params)
    whole = flatten(gather_global_tree(out.params, runner.level_shardings(0)[0], mesh))
    torch.save({"loss": out.history.loss, "step": out.history.step,
                "level": out.history.level, "flops": out.history.flops,
                "gathers": tp.counts()["all_gather"],
                "params": {k: v.detach() for k, v in whole.items()}},
               f"{OUT}/vc_rank{RANK}.pt")
dist.destroy_process_group()
'''


def _finish(procs, what):
    """Wait for the ranks; each must exit 0 (its output in the message)."""
    outs = []
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{text}"


def _start(n, mesh, out, cases):
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(("src", "tests", "scripts")),
               OMP_NUM_THREADS="1", WORLD=str(n), OUT=str(out), MESH=mesh,
               COORD=_coordinator(out, f"spawn_{mesh}"), CASES=",".join(cases), STEP_TC=repr(STEP_TC),
               VC_TC=repr(VC_TC), VC_ML=repr(VC_ML))
    return [subprocess.Popen([sys.executable, "-c", WORKER], cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=dict(env, RANK=str(r))) for r in range(n)]


def _case_batch(name, cfg):
    rng = np.random.default_rng(3)
    S = case_seq(name)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)}
    if name == "whisper":
        out["enc_frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def cp_runs(tmp_path_factory):
    """Write each case's weights and batch and the V-cycle's arena, start
    the 1x3 and 1x2 spawns, compute the reference's steps and V-cycle
    meanwhile, and collect every record."""
    out = tmp_path_factory.mktemp("cp")
    cases = {}
    for name in CASES:
        tcfg = case_cfg(name)
        p = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(1)), tcfg)
        b = _case_batch(name, tcfg)
        np.savez(out / f"{name}_case.npz", **{f"p/{k}": v for k, v in flatten(p).items()},
                 **{f"b/{k}": v for k, v in b.items()})
        cases[name] = (p, b)
    jcfg = case_cfg("vc", jax_side=True)
    chain = JMarkovLM(jcfg.vocab_size)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, VC_TC["batch_size"], VC_TC["seq_len"]))
    batches = [jax.tree.map(np.asarray, sample(g)) for g in range(21)]
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    np.savez(out / "vc_arena.npz", **{f"init/{k}": v for k, v in flatten(init).items()},
             **{f"b{g}/{k}": v for g, b in enumerate(batches) for k, v in b.items()})
    procs3 = _start(3, "1x3", out, CASES)
    procs2 = _start(2, "1x2", out, ("qwen",))
    try:
        want = {}
        for name, (p, b) in cases.items():
            jm, jtc = jax_build_model(case_cfg(name, jax_side=True)), JTC(**STEP_TC)
            jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b)
            step = jax_make_train_step(jm, jtc)
            grads, (p1, o1, m1) = jax.jit(lambda q, o, x: (
                jax.grad(lambda r: jm.loss(r, x)[0])(q), step(q, o, x)))(
                jp, jax_adamw_init(jp, jtc), jb)
            want[name] = {"grads": flatten(jax.tree.map(np.asarray, grads)),
                          "params": flatten(jax.tree.map(np.asarray, p1)),
                          "m": flatten(jax.tree.map(np.asarray, o1["m"])),
                          "v": flatten(jax.tree.map(np.asarray, o1["v"])),
                          "metrics": {k: float(v) for k, v in m1.items()}}
        jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
        ref = jvc.VCycleRunner(jcfg, JML(**VC_ML), JTC(**VC_TC), jbf, seed=0).run(
            state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
        want["vcycle"] = {"loss": ref.history.loss, "step": ref.history.step,
                          "level": ref.history.level, "flops": ref.history.flops,
                          "params": flatten(jax.tree.map(np.asarray, ref.params))}
        # the port's one-process run of it, the 1x3 run's nearer yardstick
        tcfg = case_cfg("vc")
        bf = lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}
        one = VCycleRunner(tcfg, MultiLevelConfig(**VC_ML), TrainConfig(**VC_TC), bf,
                           device="cpu").run(state=VCycleState(),
                                             params=from_reference(init, tcfg))
        want["vcycle_one"] = {"loss": one.history.loss, "step": one.history.step,
                              "level": one.history.level, "flops": one.history.flops,
                              "params": {k: v.detach() for k, v in
                                         flatten(one.params).items()}}
        _finish(procs3, "the 1x3 spawn")
        _finish(procs2, "the 1x2 spawn")
    finally:
        for p in procs3 + procs2:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = lambda tag, n=3: [torch.load(out / f"{tag}_rank{r}.pt", weights_only=False)
                            for r in range(n)]
    return {"want": want, "got": got}


def _share(got, want) -> float:
    """The gap as a share of ``STEP_TOL`` of ``max(1, max |want|)``."""
    want = np.asarray(want, np.float64)
    gap = float(np.abs(np.asarray(got, np.float64) - want).max())
    return gap / (STEP_TOL * max(1.0, float(np.abs(want).max())))


def _worst(rec, want) -> float:
    """The largest share of the tolerance over every compared quantity."""
    worst = 0.0
    for what in ("grads", "params", "m", "v"):
        assert rec[what].keys() == want[what].keys(), what
        for k, v in rec[what].items():
            worst = max(worst, _share(v.numpy(), want[what][k]))
    for k in ("loss", "grad_norm"):
        worst = max(worst, _share(rec["metrics"][k], want["metrics"][k]))
    return worst


def _derived(name) -> dict:
    """Collectives of one train step on 1x3 (the FSDP step; the gradient
    pass alone is this without the clip norm's sum): per CP layer a
    sequence gather (two under remat "full") and one fused backward sum,
    per FFN split over "model" a forward sum and a backward one, and the
    clipping norm's sum over "model"."""
    cfg = case_cfg(name)
    S = case_seq(name)
    cp = S % 3 == 0
    layers = len(cfg.stages[0].pattern) * cfg.stages[0].repeats
    enc = cfg.n_encoder_layers if cfg.encoder_seq % 3 == 0 else 0
    ffn = 2 * layers * (cfg.d_ff % 3 == 0)
    gathers = (layers * cp + enc) * (2 if cfg.remat == "full" else 1)
    return {"all_reduce": layers * cp + enc + ffn + 1, "all_gather": gathers}


@pytest.mark.parametrize("name", CASES)
def test_one_cp_step_on_1x3_matches_the_reference_unsharded_step(cp_runs, name):
    want = cp_runs["want"][name]
    recs = cp_runs["got"](f"{name}_1x3")
    for r, rec in enumerate(recs):
        worst = _worst(rec, want)
        assert worst <= 1.0, (name, r, worst)
        assert rec["metrics"] == recs[0]["metrics"]
    print(f"[{name}] 1x3 step: largest gap {worst:.3e} of its tolerance")


@pytest.mark.parametrize("name", CASES)
def test_the_collectives_a_cp_step_makes(cp_runs, name):
    d = _derived(name)
    for rec in cp_runs["got"](f"{name}_1x3"):
        assert rec["step_counts"] == d, (name, rec["step_counts"], d)
        assert rec["grad_counts"] == dict(d, all_reduce=d["all_reduce"] - 1)
    if name == "qwen_s16":  # 16 rows do not split 3 ways: no sequence gather
        assert d["all_gather"] == 0
    else:
        assert d["all_gather"] > 0


def test_1x2_keeps_the_head_split_and_matches(cp_runs):
    want = cp_runs["want"]["qwen"]
    for rec in cp_runs["got"]("qwen_1x2", 2):
        assert _worst(rec, want) <= 1.0
        # heads split over "model": a sum after wo a layer; the vocabulary-
        # split logits (512 rows split 2 ways) stay split through the loss,
        # so the step gathers nothing
        assert rec["step_counts"]["all_gather"] == 0


def test_each_planted_fault_breaks_the_match(cp_runs):
    want = cp_runs["want"]["qwen"]["metrics"]
    for rec in cp_runs["got"]("faults"):
        for fault in FAULTS:
            m = rec[fault]["metrics"]
            gap = max(_share(m["loss"], want["loss"]), _share(m["grad_norm"], want["grad_norm"]))
            assert gap > 10.0, (fault, gap)


def test_the_servers_prefill_on_the_mesh_takes_no_cp(cp_runs):
    for rec in cp_runs["got"]("serve"):
        assert rec["ways"] == [1]
        assert rec["counts"]["all_gather"] == 0  # no sequence gather (vocabulary whole)
        assert rec["gap"] <= 1e-5


def test_cp_vcycle_on_1x3_follows_the_reference_history(cp_runs):
    want, one = cp_runs["want"]["vcycle"], cp_runs["want"]["vcycle_one"]
    _follows(one, want, VC_TOL, "one process")
    for r, rec in enumerate(cp_runs["got"]("vc")):
        _follows(rec, one, VC_TOL, f"1x3 CP V-cycle rank {r} against one process")
        _follows(rec, want, VC_TOL, f"1x3 CP V-cycle rank {r}")
        assert rec["gathers"] > 0
