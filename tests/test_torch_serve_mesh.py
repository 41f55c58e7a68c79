"""Serving on a mesh beyond the greedy ``1xM`` server: the speculative policy
on ``--mesh 1x2`` and the paged server on a "data" axis (``2x1``, ``2x2``),
on spawned gloo ranks on the CPU, held to the reference's UNSHARDED servers
at f32.

* Spawn A, two ranks: on 1x2, the speculative policy (k 3, a width-only
  draft, on weights whose draft is function-identical to the full model,
  so most drafts are accepted) serves ``tiny_dense`` and ``tiny_moe``: the
  streams, ``stats()`` (but the host-time fields) and accepted tokens equal
  the reference's unsharded speculative server's, and the streams equal
  greedy decode's, before and after a hot swap that re-projects the draft
  across the ranks.  Then on 2x1 (a "data" axis of two), ``tiny_moe``
  (its 4 experts split over ("model", "data")) and ``tiny_dense`` (no
  collective at all) give the reference's unsharded paged streams.
  On 1x2 also the greedy paged server on ``tiny_dense``.
* Spawn B, four ranks on 2x2: ``tiny_moe`` gives the reference's streams
  before and after a hot swap; process (d, m) holds expert block ``m*2 + d``
  (model-major), the dropped-routing tally is kept by block 0 alone, and a
  router gather in global rank order (data-major) breaks the prefill
  logits.
* On 1x2 and 2x2, each rank records the shapes ``all_gather_cat`` returns
  in every serving step: the prefill's and the prefix-reuse extend's
  logits are gathered as ``[B, V]``, the last position's block only (the
  reference keeps them split), and gathering position 0's block instead
  (a planted fault) breaks the 2x2 streams.
* On 2x1 and 2x2 a ``ManifestWatcher`` with the server's shardings lands
  the swapped-in weights from a checkpoint as each rank's blocks.

The traffic is ``tests/test_torch_tensor_parallel.py``'s (six prompts, two
sharing a 16-token prefix; ``batch=3, max_seq=48, page_size=8``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_dense, tiny_moe
from repro.config import MultiLevelConfig as JML
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SpeculativePolicy as JaxSpeculativePolicy
from repro.launch.serve import make_server as jax_make_server

from repro_torch.checkpoint import CheckpointManager
from repro_torch.param import flatten, tree_map
from test_torch_model_parallel import _coordinator
from test_torch_speculative import TIMES, _width_consistent_params
from test_torch_ssm import one_thread  # noqa: F401 (autouse)
from test_torch_tensor_parallel import LOGIT_TOL, SHARED_SRC, _prompts

ROOT = os.path.join(os.path.dirname(__file__), "..")
# seconds a spawn's ranks may take, from the end of the reference's work
# (they share the host with the suite's other workers)
TIMEOUT = 300
KW = dict(batch=3, max_seq=48, page_size=8)
NAMES = ("dense", "moe")
MAX_NEW = 6

WORKER = '''
import os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.config import MultiLevelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import init_distributed, make_cli_mesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.serve import ManifestWatcher, Request, SpeculativePolicy, make_server
from repro_torch.layers.ffn import count_dropped
from repro_torch.models import api
from repro_torch.param import flatten, unflatten
RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
KW = dict(batch=3, max_seq=48, page_size=8, device="cpu")
''' + SHARED_SRC + '''
assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"


# every serving step's kind, tokens' shape and the shapes all_gather_cat
# returned inside it (the prefill's and the extend's logits: [B, V])
STEPS, ACTIVE = [], []
_gather = tp.all_gather_cat


def recording_gather(x, dim=-1, axes=tp.MODEL):
    y = _gather(x, dim, axes)
    if ACTIVE:
        ACTIVE[-1][2].append(tuple(y.shape))
    return y


tp.all_gather_cat = recording_gather


def recorded(step, kind):
    def run(params, *args, **kw):
        tokens = args[0] if kind.endswith("prefill") else args[1]
        name = kind if kind.endswith(("prefill", "verify")) else \
            kind + ("decode" if tokens.shape[1] == 1 else "extend")
        ACTIVE.append((name, tuple(tokens.shape), []))
        try:
            return step(params, *args, **kw)
        finally:
            STEPS.append(ACTIVE.pop())

    return run


def first_position(out):
    """A planted fault: the logits of position 0 gathered, not the last's."""
    first = out["logits"][:, 0, :]
    return tp.all_gather_cat(first, dim=-1, axes=out["vocab_axes"]) if out["vocab_axes"] \
        else first


def weights(name):
    w = np.load(f"{OUT}/{name}_w.npz")
    return [unflatten({k[3:]: torch.from_numpy(w[k]) for k in w.files if k[:3] == p})
            for p in ("p0/", "p1/")]


def serve(name, mesh, speculative=False):
    cfg = _torch_cfg(name)
    pol = (SpeculativePolicy(k=3, ml=MultiLevelConfig(), draft_width=True, draft_depth=False)
           if speculative else "greedy")
    srv = make_server(cfg, engine="paged", policy=pol, mesh=mesh, **KW)
    srv.prefill, srv.paged_step = recorded(srv.prefill, "prefill"), recorded(srv.paged_step, "")
    if speculative:
        p = srv.policy
        p.draft_prefill, p.draft_step, p.verify = (
            recorded(p.draft_prefill, "draft_prefill"), recorded(p.draft_step, "draft_"),
            recorded(p.verify, "verify"))
    prompts = _prompts(cfg.vocab_size)
    rec = {}
    for i, (base, tree) in enumerate(zip((0, 100), weights(name))):
        srv.set_params(tree)
        if speculative:
            srv.policy.on_reset(srv)
        tp.reset_counts()
        STEPS.clear()
        with count_dropped() as tally:
            done = srv.run([Request(base + j, p, 6) for j, p in enumerate(prompts)])
        rec[f"steps{i}"] = list(STEPS)
        rec[f"counts{i}"] = tp.counts()
        rec[f"streams{i}"] = {r.rid: r.out for r in done if r.rid >= base}
        rec[f"stats{i}"] = srv.stats()
        rec[f"tally{i}"] = tally.counts()
        logits, _ = srv.prefill(srv.params, torch.from_numpy(prompts[4][None]))
        rec[f"logits{i}"] = logits[0].numpy()
    rec["leaves"] = {k: v.clone() for k, v in flatten(srv.params).items()}
    rec["coord"] = tuple(mesh.get_coordinate())
    if not speculative:  # the swapped-in weights again, through a watcher with the layout
        watcher = ManifestWatcher(CheckpointManager(f"{OUT}/{name}_ckpt"), like=srv.params,
                                  shardings=srv._param_shardings, mesh=mesh)
        step, landed = watcher.poll()
        rec["watcher"] = step == 1 and all(torch.equal(flatten(landed)[k], v)
                                           for k, v in flatten(srv.params).items())
    if speculative:
        rec["draft"] = {k: tuple(v.shape) for k, v in flatten(srv.policy.draft_params).items()}
        rec["draft_pools"] = {k: tuple(v.shape) for k, v in
                              flatten(srv.policy.draft_pages).items()}
    return rec


for step in os.environ["PLAN"].split(";"):
    mesh_spec, names, kind = step.split(":")
    mesh = make_cli_mesh(mesh_spec, num_processes=N, device="cpu")
    for name in names.split(","):
        rec = serve(name, mesh, speculative=kind == "spec")
        torch.save(rec, f"{OUT}/{kind}_{mesh_spec}_{name}_rank{RANK}.pt")
    if kind == "fault":  # the router's blocks gathered in global rank order
        orig = tp.axes_group
        tp.axes_group = lambda axes=tp.MODEL: (orig(axes)[0], None)
        rec = serve("moe", mesh)
        tp.axes_group = orig
        torch.save(rec, f"{OUT}/rankorder_{mesh_spec}_moe_rank{RANK}.pt")
        last = api._last_logits  # the prefill's and the extend's position 0 gathered
        api._last_logits = first_position
        rec = serve("moe", mesh)
        api._last_logits = last
        torch.save(rec, f"{OUT}/firstpos_{mesh_spec}_moe_rank{RANK}.pt")
dist.destroy_process_group()
'''


def _jax_cfg(name):
    return (tiny_moe if name == "moe" else tiny_dense)(compute_dtype=jnp.float32)


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


def _start(n, plan, out):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(("src", "tests")), OMP_NUM_THREADS="1",
               WORLD=str(n), OUT=str(out), COORD=_coordinator(out, f"spawn_{n}"), PLAN=plan)
    return [subprocess.Popen([sys.executable, "-c", WORKER], cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=dict(env, RANK=str(r))) for r in range(n)]


def _reference(name, weights, speculative):
    """The reference's unsharded server on ``weights`` (before and after the
    swap): streams, stats and the prefill logits of ``prompts[4]``."""
    pol = (JaxSpeculativePolicy(k=3, ml=JML(), draft_width=True, draft_depth=False)
           if speculative else "greedy")
    ref = jax_make_server(_jax_cfg(name), engine="paged", policy=pol, **KW)
    prompts = _prompts(ref.cfg.vocab_size)
    w = {}
    for i, (base, tree) in enumerate(zip((0, 100), weights)):
        ref.set_params(jax.tree.map(jnp.asarray, tree))
        if speculative:
            ref.policy.on_reset(ref)
        done = ref.run([JaxRequest(base + j, p, MAX_NEW) for j, p in enumerate(prompts)])
        w[f"streams{i}"] = {r.rid: r.out for r in done if r.rid >= base}
        w[f"stats{i}"] = ref.stats()
        logits, _ = ref.prefill(ref.params, jnp.asarray(prompts[4][None], jnp.int32),
                                None, None)
        w[f"logits{i}"] = np.asarray(logits[0])
    return w


@pytest.fixture(scope="module")
def mesh_serve(tmp_path_factory):
    out = tmp_path_factory.mktemp("sm")
    weights = {}
    for name in NAMES:
        rng = np.random.default_rng(7 + NAMES.index(name))
        p0 = _width_consistent_params(_jax_cfg(name), JML())
        p1 = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
                          p0)
        weights[name] = (p0, p1)
        CheckpointManager(str(out / f"{name}_ckpt")).save(
            1, {"params": tree_map(torch.from_numpy, p1)}, meta={"step": 1})
        np.savez(out / f"{name}_w.npz", **{f"p{i}/{k}": v for i, t in enumerate((p0, p1))
                                          for k, v in flatten(t).items()})
    procs_a = _start(2, "1x2:dense,moe:spec;1x2:dense:greedy;2x1:moe,dense:greedy", out)
    procs_b = _start(4, "2x2:moe:fault", out)
    try:
        want = {(name, spec): _reference(name, weights[name], spec)
                for name in NAMES for spec in (False, True)}
        _finish(procs_a, "spawn A (1x2, 2x1)")
        _finish(procs_b, "spawn B (2x2)")
    finally:
        for p in procs_a + procs_b:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = lambda tag, n: [torch.load(out / f"{tag}_rank{r}.pt", weights_only=False)
                          for r in range(n)]
    return {"want": want, "got": got, "weights": weights}


def _drop_times(stats):
    return {k: v for k, v in stats.items() if k not in TIMES}


@pytest.mark.parametrize("name", NAMES)
def test_speculative_on_1x2_equals_the_reference_and_greedy(mesh_serve, name):
    spec, greedy = mesh_serve["want"][(name, True)], mesh_serve["want"][(name, False)]
    for i in (0, 1):  # before and after the hot swap
        assert spec[f"streams{i}"] == greedy[f"streams{i}"]  # lossless, in the reference
        for rec in mesh_serve["got"](f"spec_1x2_{name}", 2):
            assert rec[f"streams{i}"] == spec[f"streams{i}"], (name, i)
            got = {k: v for k, v in _drop_times(rec[f"stats{i}"]).items()
                   if k in spec[f"stats{i}"]}
            assert got == _drop_times(spec[f"stats{i}"]), (name, i)
    assert spec["stats0"]["accepted_tokens"] > 0


def test_the_draft_is_laid_out_on_the_mesh(mesh_serve):
    recs = mesh_serve["got"]("spec_1x2_dense", 2)
    draft, pools = recs[0]["draft"], recs[0]["draft_pools"]
    # the draft's 2 query heads and 1 K/V head: the heads split, K/V whole
    assert draft["stages/stage_0/b0/mixer/wq"][2] == 1
    assert all(shape[3] == 1 for shape in pools.values())
    assert recs[1]["draft"] == draft


@pytest.mark.parametrize("case", ["1x2_dense", "2x1_moe", "2x1_dense", "2x2_moe"])
def test_dxm_streams_equal_the_reference_unsharded_streams(mesh_serve, case):
    mesh, name = case.split("_")
    want = mesh_serve["want"][(name, False)]
    n = 4 if mesh == "2x2" else 2
    kind = "fault" if mesh == "2x2" else "greedy"
    for rec in mesh_serve["got"](f"{kind}_{case}", n):
        assert rec["watcher"], case  # a checkpoint lands as this rank's blocks
        for i in (0, 1):
            assert rec[f"streams{i}"] == want[f"streams{i}"], (case, i, rec["coord"])
            w = want[f"logits{i}"]
            gap = np.abs(rec[f"logits{i}"] - w).max() / max(1.0, np.abs(w).max())
            assert gap <= LOGIT_TOL, (case, i, gap)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_experts_lie_in_model_major_blocks(mesh_serve, mesh):
    n = 4 if mesh == "2x2" else 2
    D, M = int(mesh[0]), int(mesh[2])
    whole = flatten(mesh_serve["weights"]["moe"][1])
    key = "stages/stage_1/b0/ffn/w_gate"
    X = whole[key].shape[1]
    xl = X // (D * M)
    kind = "fault" if mesh == "2x2" else "greedy"
    blocks = set()
    for rec in mesh_serve["got"](f"{kind}_{mesh}_moe", n):
        d, m = rec["coord"]
        b = m * D + d
        blocks.add(b)
        assert np.array_equal(rec["leaves"][key].numpy(), whole[key][:, b * xl:(b + 1) * xl])
        # the dropped-routing tally: block 0 alone keeps it
        assert bool(rec["tally0"]) == (b == 0), (rec["coord"], rec["tally0"])
    assert blocks == set(range(D * M))


def test_2x1_dense_makes_no_collective(mesh_serve):
    for rec in mesh_serve["got"]("greedy_2x1_dense", 2):
        assert rec["counts0"] == rec["counts1"] == {"all_reduce": 0, "all_gather": 0}
        assert rec["stats0"]["mesh"] == "2x1"
        assert rec["stats0"]["pool_bytes_global"] == rec["stats0"]["pool_bytes_local"]


def test_a_router_gather_in_global_rank_order_breaks_the_match(mesh_serve):
    want = mesh_serve["want"][("moe", False)]["logits0"]
    gaps = [np.abs(rec["logits0"] - want).max() / max(1.0, np.abs(want).max())
            for rec in mesh_serve["got"]("rankorder_2x2_moe", 4)]
    assert min(gaps) > 100 * LOGIT_TOL, gaps


@pytest.mark.parametrize("case", ["spec_1x2_dense", "spec_1x2_moe", "greedy_1x2_dense",
                                  "fault_2x2_moe"])
def test_the_prefill_and_the_extend_gather_the_last_position_only(mesh_serve, case):
    """The vocabulary stays split over "model" through the prefill and the
    prefix-reuse extend up to their last position: the logits' one gather
    a step is ``[B, V]`` (the verify step alone gathers every position)."""
    n = 4 if "2x2" in case else 2
    V = _jax_cfg(case.split("_")[-1]).padded_vocab
    for rec in mesh_serve["got"](case, n):
        for i in (0, 1):
            steps = rec[f"steps{i}"]
            kinds = {kind for kind, _, _ in steps}
            spec = case.startswith("spec")  # its main model decodes through verify
            assert {"prefill", "extend", "verify" if spec else "decode"} <= kinds, (case, kinds)
            assert spec <= ("draft_prefill" in kinds), (case, kinds)
            for kind, shape, gathers in steps:
                logits = [g for g in gathers if g[-1] == V]
                want = [shape + (V,)] if kind == "verify" else [(shape[0], V)]
                assert logits == want, (case, rec["coord"], kind, shape, gathers)
            assert rec[f"stats{i}"]["prefill_tokens_saved"] > 0


def test_the_first_position_gathered_breaks_the_streams(mesh_serve):
    """A planted fault, position 0's block gathered where the last one's
    is: the gathers keep their shape, the streams leave the reference's."""
    want = mesh_serve["want"][("moe", False)]
    V = _jax_cfg("moe").padded_vocab
    for rec in mesh_serve["got"]("firstpos_2x2_moe", 4):
        for i in (0, 1):
            assert all(g[-1] != V or g == (shape[0], V) for kind, shape, gathers in
                       rec[f"steps{i}"] for g in gathers)
            assert rec[f"streams{i}"] != want[f"streams{i}"], (i, rec["coord"])
