"""Decode on sequence-split dense caches (the reference's ``"cache_seq"``
rule, flash-decode context parallelism), held to the reference's
UNSHARDED prefill and ``make_serve_step`` at f32.

Inside ``mesh_ctx(mesh, dense_serving=True)`` a process holds positions
``[c T/M, (c+1) T/M)`` of every K/V head (MLA: of the latent and rope
strips) on "model" coordinate c.  One spawn per mesh runs, on gloo ranks:

* the prefill on the mesh, whose caches must be each rank's chunk of the
  reference's prefill caches;
* ``DECODE_STEPS`` decode steps from the reference's prefill caches (padded
  to ``T`` and cut to each rank's chunk) on the reference's token stream,
  crossing a chunk boundary; each step's logits must lie within
  ``LOGIT_TOL`` of the reference's.

Cases: a GQA config on 1x2 (heads and K/V heads split) and on 1x4 (its 2
K/V heads do not divide 4: the K/V projections stay whole), and an MLA
config on 1x2; and on 2x2 an MoE config whose 2 experts split over
"data" alone, their hidden dim over "model" (``SERVE_RULES``' layout where
the experts are too few for both axes).  Each decode step gathers q (and K/V where they split) and
the partial outputs whole over "model": two all-gathers a layer (one where
nothing is split), and one sum a layer for the row-parallel ``wo``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.api import build_model as jax_build_model
from repro.models.api import make_prefill_step as jax_prefill
from repro.models.api import make_serve_step as jax_serve
from repro_torch.param import flatten
from test_torch_model_parallel import _coordinator
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # the suite's other workers share the host
B, PROMPT, T, DECODE_STEPS = 2, 8, 24, 8  # positions 8..15 cross the chunk edge at 12
# the decode logits against the reference's, max abs over max(1, max |logit|):
# the chunks' partial softmaxes merge in another order than one softmax
LOGIT_TOL = 1e-6
# the mesh prefill's cache chunks against the reference's, max abs over
# max(1, max |value|): the K/V come from the sharded layers' sums and the
# local heads' products (measured 1.4e-6 at values near 2 on 1x2)
CACHE_TOL = 1e-5
CASES = {"gqa_1x2": ("1x2", "gqa"), "gqa_1x4": ("1x4", "gqa"), "mla_1x2": ("1x2", "mla"),
         "moe_2x2": ("2x2", "moe")}

# the tiny GQA and MLA configs of ``helpers`` at f32, built field for field on
# either side (the ranks run this too)
CFG_SRC = '''
def case_cfg(kind, jax_side=False):
    if jax_side:
        import jax.numpy as jnp
        from repro.config import BlockSpec, ModelConfig, uniform_stages
        f32 = jnp.float32
    else:
        from repro_torch.config import BlockSpec, ModelConfig, uniform_stages
        f32 = torch.float32
    base = dict(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=256, stages=uniform_stages(3, BlockSpec("attn", "dense")),
                qk_norm=True, remat="none", attn_impl="plain", compute_dtype=f32)
    if kind == "mla":
        base.update(name="t-mla", family="moe", attn_type="mla", q_lora_rank=32,
                    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16, qk_norm=False, n_kv_heads=4)
    if kind == "moe":  # 2 experts: SERVE_RULES put them on "data", their d_ff on "model"
        base.update(name="t-moe", family="moe", n_experts=2, moe_top_k=1, moe_d_ff=64,
                    n_shared_experts=1, stages=uniform_stages(2, BlockSpec("attn", "moe")))
    return ModelConfig(**base)
'''

WORKER = '''
import os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
KIND, MESH = os.environ["KIND"], os.environ["MESH"]
B, T, PROMPT = (int(os.environ[k]) for k in ("B", "T", "PROMPT"))
from repro_torch.bridge import from_reference
from repro_torch.distributed import put_global_tree, tensor_parallel as tp
from repro_torch.distributed.sharding import local_slices, logical_spec, mesh_ctx, param_shardings
from repro_torch.launch.dryrun import serve_rules
from repro_torch.launch.mesh import init_distributed, make_cli_mesh
from repro_torch.models.api import build_model, make_prefill_step, make_serve_step
from repro_torch.param import flatten, unflatten
''' + CFG_SRC + '''
assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"
mesh = make_cli_mesh(MESH, num_processes=N, device="cpu")
cfg = case_cfg(KIND)
model = build_model(cfg)
w = np.load(f"{OUT}/{KIND}_case.npz")
params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
rules = serve_rules()
local = put_global_tree(params, param_shardings(model.specs(), mesh, rules), mesh)
rows = local_slices((B,), logical_spec((B,), ("batch",), mesh, rules), mesh)[0]  # this rank's
with mesh_ctx(mesh, dense_serving=True):
    _, pre = make_prefill_step(model)(local, torch.from_numpy(w["prompt"][rows].astype(np.int64)))
caches = unflatten({k[2:]: torch.from_numpy(np.array(w[k])) for k in w.files if k[:2] == "c/"})
caches = put_global_tree(caches, param_shardings(model.cache_specs(B, T), mesh, rules), mesh)
step = make_serve_step(model)
logits, counts = [], []
for i, tok in enumerate(w["stream"]):
    tp.reset_counts()
    tok = torch.from_numpy(tok[rows].astype(np.int64))
    pos = torch.full(tok.shape, PROMPT + i, dtype=torch.long)
    with mesh_ctx(mesh, dense_serving=True):
        lg, caches = step(local, caches, tok[:, None], pos)
    logits.append(lg.clone())
    counts.append(tp.counts())
torch.save({"rows": (rows.start, rows.stop),
            "prefill": {k: v.clone() for k, v in flatten(pre).items()},
            "local_shapes": {k: tuple(v.shape) for k, v in flatten(caches).items()},
            "logits": logits, "counts": counts}, f"{OUT}/{KIND}_{MESH}_rank{RANK}.pt")
dist.destroy_process_group()
'''
exec(CFG_SRC)


def _start(mesh, kind, out):
    n = int(mesh.split("x")[0]) * int(mesh.split("x")[1])
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", WORLD=str(n), OUT=str(out),
               MESH=mesh, KIND=kind, COORD=_coordinator(out, f"spawn_{mesh}_{kind}"),
               B=str(B), T=str(T),
               PROMPT=str(PROMPT))
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


def _reference(kind, out):
    """The reference's params, prompt, prefill caches (padded to T) and the
    logits of each decode step on its own greedy stream; written for the
    ranks."""
    cfg = case_cfg(kind, jax_side=True)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    last, pre = jax.jit(jax_prefill(jm))(params, jnp.asarray(prompt))
    pad = lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, T - c.shape[2])] + [(0, 0)] * (c.ndim - 3))
    caches = jax.tree.map(pad, pre)
    serve = jax.jit(jax_serve(jm))
    tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
    stream, logits = [], []
    for i in range(DECODE_STEPS):
        stream.append(tok)
        lg, caches = serve(params, caches, jnp.asarray(tok)[:, None],
                           jnp.full((B,), PROMPT + i, jnp.int32))
        logits.append(np.asarray(lg))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    np.savez(out / f"{kind}_case.npz",
             **{f"p/{k}": np.asarray(v) for k, v in flatten(params).items()},
             **{f"c/{k}": np.asarray(v) for k, v in flatten(jax.tree.map(pad, pre)).items()},
             prompt=prompt, stream=np.stack(stream))
    return {"prefill": {k: np.asarray(v) for k, v in flatten(pre).items()}, "logits": logits}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cache_seq")
    want = {kind: _reference(kind, out) for kind in ("gqa", "mla", "moe")}
    procs = {name: _start(mesh, kind, out) for name, (mesh, kind) in CASES.items()}
    try:
        for name, ps in procs.items():
            _finish(ps, name)
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    got = {}
    for name, (mesh, kind) in CASES.items():
        n = int(mesh.split("x")[0]) * int(mesh.split("x")[1])
        got[name] = [torch.load(out / f"{kind}_{mesh}_rank{r}.pt", weights_only=False)
                     for r in range(n)]
    return want, got


@pytest.mark.parametrize("name", list(CASES))
def test_decode_on_a_split_cache_matches_the_reference(runs, name):
    want, got = runs
    kind = CASES[name][1]
    for rec in got[name]:
        assert len(rec["logits"]) == DECODE_STEPS
        for lg, ref in zip(rec["logits"], want[kind]["logits"]):
            ref = ref[slice(*rec["rows"])]
            scale = max(1.0, float(np.abs(ref).max()))
            assert float(np.abs(lg.numpy() - ref).max()) / scale <= LOGIT_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_chunk_of_every_head(runs, name):
    """The caches a rank decodes on are T / M positions of every K/V head,
    and the mesh prefill leaves it its chunk of the reference's."""
    want, got = runs
    mesh, kind = CASES[name]
    n = int(mesh.split("x")[1])
    cfg = case_cfg(kind, jax_side=True)
    for r, rec in enumerate(got[name]):
        m = r % n  # the rank's "model" coordinate
        for k, shape in rec["local_shapes"].items():
            assert shape[2] == T // n, (k, shape)
            if kind != "mla":
                assert shape[3] == cfg.n_kv_heads
        for k, v in rec["prefill"].items():
            c = PROMPT // n
            ref = want[kind]["prefill"][k][:, slice(*rec["rows"]), m * c:(m + 1) * c]
            assert v.shape == ref.shape
            scale = max(1.0, float(np.abs(ref).max()))
            assert float(np.abs(v.numpy() - ref).max()) / scale <= CACHE_TOL, k


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] != "moe"])
def test_the_collectives_a_decode_step_makes(runs, name):
    """Per layer: one gather of q (with K/V where they split; none where
    no head splits), one of the partials, one sum for ``wo``; then the
    vocabulary-parallel embedding's sum and the logits' gather."""
    _, got = runs
    mesh, kind = CASES[name]
    n = int(mesh.split("x")[1])
    cfg = case_cfg(kind, jax_side=True)
    layers = cfg.n_layers
    heads_split = cfg.n_heads % n == 0
    ffn_split = cfg.d_ff % n == 0
    want = {"all_gather": layers * (1 + heads_split) + 1,
            "all_reduce": layers * (heads_split + ffn_split) + 1}
    for rec in got[name]:
        for c in rec["counts"]:
            assert c == want, (name, c, want)
