"""The vocabulary-parallel training loss: on a "model" axis the logits stay
split as each process's block of vocabulary columns through the loss (the
reference's ``lm_loss`` keeps its ``act_vocab`` sharding), held to the
reference's UNSHARDED step at f32.

* ``lm_loss`` on one process with ``vocab_axes`` set but no mesh equals the
  plain loss (the split form's arithmetic with one block).
* Spawns of gloo ranks on ``--mesh 1x2`` and ``--mesh 2x2`` (the FSDP step,
  data and "model" split together on 2x2): one f32 train step of
  ``tiny_dense`` untied and tied, ``tiny_moe`` (experts and the vocabulary
  on "model") and ``tiny_mla`` with the MTP head, each with ``z_loss`` 0
  and 1e-2, on batches whose labels are -1 at a fifth of the positions.
  Loss, ``ce``, ``mtp_ce``, ``moe_aux``, ``grad_norm``, the gradients (the
  step's own, as AdamW receives them), parameters and AdamW moments lie
  within ``STEP_TOL`` of ``max(1, max |want|)`` of the reference's
  ``make_train_step``.  No collective of the step gathers logits: every
  ``all_gather_cat`` of the step is recorded, and none concatenates a
  vocabulary; the collectives a step are pinned (the loss's max and sum per
  cross-entropy, nothing gathered).
* ``Model.forward_logits`` on the mesh still gathers the logits whole, by
  name, and equals the reference's forward.

~60 s of worker time (two spawns beside the reference's eight jit
compiles).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTC
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.bridge import to_reference
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import build_model
from repro_torch.param import flatten
from test_torch_model_parallel import STEP_TOL, _coordinator
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300
CASES = ("dense", "tied", "moe", "mla")
Z_LOSS = (0.0, 1e-2)
STEP_TC = dict(steps=4, warmup_steps=1, peak_lr=1e-3, batch_size=4, seq_len=16, eps=1e-4)
MESHES = {"1x2": 2, "2x2": 4}

# either side (the ranks run this too)
CFG_SRC = '''
def case_cfg(name, jax_side=False):
    if jax_side:
        import jax.numpy as jnp
        from repro.config import BlockSpec, ModelConfig, Stage, uniform_stages
        f32 = jnp.float32
    else:
        from repro_torch.config import BlockSpec, ModelConfig, Stage, uniform_stages
        f32 = torch.float32
    base = dict(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=256, stages=uniform_stages(3, BlockSpec("attn", "dense")),
                qk_norm=True, remat="none", attn_impl="plain", compute_dtype=f32)
    if name == "dense":
        base.update(tie_embeddings=False)
    elif name == "moe":
        base.update(name="t-moe", family="moe", n_experts=4, moe_top_k=2, moe_d_ff=64,
                    n_shared_experts=1,
                    stages=(Stage((BlockSpec("attn", "dense"),), 1),
                            Stage((BlockSpec("attn", "moe"),), 2)))
    elif name == "mla":
        base.update(name="t-mla", family="moe", attn_type="mla", q_lora_rank=32,
                    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16, qk_norm=False, n_kv_heads=4, mtp_depth=1)
    return ModelConfig(**base)
'''
exec(CFG_SRC)

WORKER = '''
import os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
from repro_torch.bridge import from_reference
from repro_torch.config import TrainConfig
from repro_torch.distributed import (as_global_batch_fn, fsdp, gather_global_tree,
                                     put_global_tree, tensor_parallel as tp)
from repro_torch.distributed.sharding import mesh_ctx
from repro_torch.launch.mesh import init_distributed, make_cli_mesh
from repro_torch.models import api
from repro_torch.models.api import build_model, make_train_step, train_state_shardings
from repro_torch.optim import adamw_init
from repro_torch.param import flatten, unflatten
''' + CFG_SRC + '''
assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"
mesh = make_cli_mesh(os.environ["MESH"], num_processes=N, device="cpu")
STEP_TC = eval(os.environ["STEP_TC"])

gathers = []  # the gathered dimension's size of every all_gather_cat
_gather = tp.all_gather_cat


def recording_gather(x, dim=-1, axes=tp.MODEL):
    out = _gather(x, dim, axes)
    gathers.append(out.shape[dim])
    return out


tp.all_gather_cat = recording_gather
seen = {}
_update = api.adamw_update


def recording_update(params, grads, opt_state, tc, **kw):
    seen["grads"] = {k: g.detach().clone() for k, g in flatten(grads).items()}
    return _update(params, grads, opt_state, tc, **kw)


api.adamw_update = recording_update


def load(name):
    w = np.load(f"{OUT}/{name}_case.npz")
    cfg = case_cfg(name)
    params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
    batch = {k[2:]: torch.from_numpy(w[k].astype(np.int64)) for k in w.files if k[:2] == "b/"}
    return cfg, params, as_global_batch_fn(lambda g: batch, mesh)(0)  # this data row's rows


for name in os.environ["CASES"].split(","):
    cfg, params, batch = load(name)
    model = build_model(cfg)
    for z in eval(os.environ["Z_LOSS"]):
        tc = TrainConfig(**STEP_TC, z_loss=z)
        psh, osh = train_state_shardings(model, tc, mesh)
        local = put_global_tree(params, psh, mesh)
        gathers.clear()
        tp.reset_counts()
        local, opt, m = make_train_step(model, tc, mesh=mesh)(local, adamw_init(local, tc), batch)
        whole = lambda t, sh: {k: v.detach() for k, v in
                               flatten(gather_global_tree(t, sh, mesh)).items()}
        rec = {"metrics": {k: float(v) for k, v in m.items()}, "counts": tp.counts(),
               "gathers": list(gathers), "padded_vocab": cfg.padded_vocab,
               "grads": whole(unflatten(seen["grads"]), psh), "params": whole(local, psh),
               "m": whole(opt["m"], osh["m"]), "v": whole(opt["v"], osh["v"])}
        torch.save(rec, f"{OUT}/{name}_z{z}_{os.environ['MESH']}_rank{RANK}.pt")

# the whole logits, gathered by name, as a distillation loss reads them
cfg, params, batch = load("tied")
model = build_model(cfg)
psh, _ = train_state_shardings(model, TrainConfig(**STEP_TC), mesh)
local = put_global_tree(params, psh, mesh)
gathers.clear()
with torch.no_grad(), mesh_ctx(mesh, train=True), fsdp.fsdp_ctx(mesh):
    logits = model.forward_logits(local, batch)
torch.save({"logits": logits, "gathers": list(gathers)},
           f"{OUT}/logits_{os.environ['MESH']}_rank{RANK}.pt")
dist.destroy_process_group()
'''


def _case_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels = np.where(rng.random((4, 16)) < 0.2, -1, labels).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _start(mesh, out):
    n = MESHES[mesh]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(("src", "tests")), OMP_NUM_THREADS="1",
               WORLD=str(n), OUT=str(out), MESH=mesh, COORD=_coordinator(out, f"spawn_{mesh}"),
               CASES=",".join(CASES), STEP_TC=repr(STEP_TC), Z_LOSS=repr(Z_LOSS))
    return [subprocess.Popen([sys.executable, "-c", WORKER], cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=dict(env, RANK=str(r))) for r in range(n)]


def _finish(procs, what):
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


@pytest.fixture(scope="module")
def vp_runs(tmp_path_factory):
    """Write each case's weights (the port's init) and batch, start both
    spawns, compute the reference's steps meanwhile, collect the records."""
    out = tmp_path_factory.mktemp("vp")
    cases = {}
    for i, name in enumerate(CASES):
        tcfg = case_cfg(name)
        p = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(1)), tcfg)
        b = _case_batch(tcfg, 7 + i)
        np.savez(out / f"{name}_case.npz", **{f"p/{k}": v for k, v in flatten(p).items()},
                 **{f"b/{k}": v for k, v in b.items()})
        cases[name] = (p, b)
    procs = {mesh: _start(mesh, out) for mesh in MESHES}
    try:
        want = {}
        for name, (p, b) in cases.items():
            jm = jax_build_model(case_cfg(name, jax_side=True))
            jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b)
            for z in Z_LOSS:
                jtc = JTC(**STEP_TC, z_loss=z)
                step = jax_make_train_step(jm, jtc)
                grads, (p1, o1, m1) = jax.jit(lambda q, o, x: (
                    jax.grad(lambda r: jm.loss(r, x, z_loss=z)[0])(q), step(q, o, x)))(
                    jp, jax_adamw_init(jp, jtc), jb)
                want[name, z] = {"grads": flatten(jax.tree.map(np.asarray, grads)),
                                 "params": flatten(jax.tree.map(np.asarray, p1)),
                                 "m": flatten(jax.tree.map(np.asarray, o1["m"])),
                                 "v": flatten(jax.tree.map(np.asarray, o1["v"])),
                                 "metrics": {k: float(v) for k, v in m1.items()}}
            if name == "tied":
                want["logits"] = np.asarray(jax.jit(jm.forward_logits)(jp, jb))
        for mesh, ps in procs.items():
            _finish(ps, f"the {mesh} spawn")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    got = lambda tag, mesh: [torch.load(out / f"{tag}_{mesh}_rank{r}.pt", weights_only=False)
                             for r in range(MESHES[mesh])]
    return {"want": want, "got": got}


def _share(got, want) -> float:
    """The gap as a share of ``STEP_TOL`` of ``max(1, max |want|)``."""
    want = np.asarray(want, np.float64)
    gap = float(np.abs(np.asarray(got, np.float64) - want).max())
    return gap / (STEP_TOL * max(1.0, float(np.abs(want).max())))


def test_the_split_form_on_one_block_is_the_plain_loss():
    """``lm_loss`` with ``vocab_axes`` outside a mesh context: one block of
    the whole vocabulary, the max and sums over a group of one process are
    identities -- so the split arithmetic itself (max, exp-sum, masked
    pick, ``lse = max + log(sum)``) must give the plain loss, its metrics
    and its gradient."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_cli_mesh
    from repro_torch.distributed.sharding import mesh_ctx

    cfg = case_cfg("mla")
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 16, cfg.padded_vocab, generator=g, dtype=torch.float64)
    mtp = torch.randn(2, 16, cfg.padded_vocab, generator=g, dtype=torch.float64)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    labels[0, :5] = -1
    own = not dist.is_initialized()
    mesh = make_cli_mesh("1x1", device="cpu")
    try:
        for z in Z_LOSS:
            res = []
            for axes in ((), ("model",)):
                lg, mt = logits.clone().requires_grad_(True), mtp.clone().requires_grad_(True)
                with mesh_ctx(mesh, train=True):
                    loss, m = lm_lib.lm_loss(lg, labels, cfg, torch.tensor(0.5, dtype=lg.dtype),
                                             mt, labels.roll(-1, 1), z_loss=z, vocab_axes=axes)
                loss.backward()
                res.append(({k: float(v.detach()) for k, v in m.items()}, lg.grad, mt.grad))
            (m0, g0, h0), (m1, g1, h1) = res
            assert m0.keys() == m1.keys() and {"ce", "mtp_ce", "loss"} <= m0.keys()
            for k in m0:
                assert abs(m0[k] - m1[k]) <= 1e-12 * max(1.0, abs(m0[k])), (z, k)
            torch.testing.assert_close(g1, g0, rtol=0, atol=1e-15)
            torch.testing.assert_close(h1, h0, rtol=0, atol=1e-15)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("z", Z_LOSS, ids=["z0", "z1e-2"])
@pytest.mark.parametrize("name", CASES)
def test_one_step_on_the_mesh_matches_the_reference_unsharded_step(vp_runs, name, z, mesh):
    want = vp_runs["want"][name, z]
    recs = vp_runs["got"](f"{name}_z{z}", mesh)
    cfg = case_cfg(name)
    keys = {"loss", "ce", "grad_norm"} | ({"mtp_ce"} if cfg.mtp_depth else set()) | \
        ({"moe_aux"} if cfg.n_experts else set())
    worst = 0.0
    for r, rec in enumerate(recs):
        assert keys <= rec["metrics"].keys() and keys <= want["metrics"].keys()
        for k in keys:
            share = _share(rec["metrics"][k], want["metrics"][k])
            assert share <= 1.0, (name, z, mesh, r, k, share)
        for what in ("grads", "params", "m", "v"):
            assert rec[what].keys() == want[what].keys(), what
            for k, v in rec[what].items():
                share = _share(v.numpy(), want[what][k])
                worst = max(worst, share)
                assert share <= 1.0, (name, z, mesh, r, what, k, share)
        assert rec["metrics"] == recs[0]["metrics"]
    if z:  # the z-loss term moved the loss
        assert want["metrics"]["loss"] > vp_runs["want"][name, 0.0]["metrics"]["loss"]
    print(f"[{name} z={z} {mesh}] largest gap {worst:.3e} of its tolerance")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CASES)
def test_the_step_gathers_no_logits(vp_runs, name, mesh):
    """Every gather a step makes is recorded: none concatenates the padded
    vocabulary.  The MoE router's logits gather over its 4 experts (one a
    MoE layer); nothing else is gathered.  The loss adds a max and one sum
    over "model" per cross-entropy (two with the MTP head)."""
    cfg = case_cfg(name)
    moe_layers = sum(st.repeats for st in cfg.stages for b in st.pattern if b.ffn == "moe")
    for z in Z_LOSS:
        for rec in vp_runs["got"](f"{name}_z{z}", mesh):
            assert rec["padded_vocab"] not in rec["gathers"], rec["gathers"]
            assert rec["gathers"] == [cfg.n_experts] * moe_layers, rec["gathers"]
            assert rec["counts"]["all_gather"] == moe_layers


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_logits_gathers_them_whole_by_name(vp_runs, mesh):
    want = vp_runs["want"]["logits"]
    for r, rec in enumerate(vp_runs["got"]("logits", mesh)):
        assert rec["gathers"] == [case_cfg("tied").padded_vocab]
        # a data coordinate's rows: all 4 on 1x2, 2 each on 2x2 (data-major ranks)
        rows = slice(None) if mesh == "1x2" else slice(2 * (r // 2), 2 * (r // 2) + 2)
        got = rec["logits"].numpy()
        assert got.shape == want[rows].shape
        assert _share(got, want[rows]) <= 1.0
