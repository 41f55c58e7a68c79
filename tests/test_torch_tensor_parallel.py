"""The "model" axis for serving: tensor- and expert-parallel paged decode on
a ``--mesh 1x2`` of processes, on the CPU.

* Spec parity: ``param_shardings`` and ``serve_shardings`` (the parameter
  and page-pool spec trees and the merged rules) equal the reference's
  ``logical_spec`` under the reference's merged serving rules, for every
  registered config, at the meshes 1x2, 2x2 and 1x16 (plain axis/shape
  objects: the rules need no devices).
* One spawn of two gloo ranks on a 1x2 mesh (``make_cli_mesh``) serves
  ``helpers.tiny_dense``, ``tiny_dense(n_kv_heads=1)`` (``heads`` split while
  ``kv_heads`` stay whole, so ``wk``/``wv`` and the pools replicate beside
  sharded leaves), ``tiny_moe`` (experts split) and ``tiny_mla`` at f32,
  on the reference test's traffic (``tests/test_serve.py``'s mesh case:
  shared prefixes, ``batch=3, max_seq=48, page_size=8``).  Each must emit
  the reference's UNSHARDED ``PagedServer`` streams token for token on both
  ranks, before and after a ``set_params`` hot swap; the GQA pools hold
  KH/2 heads a rank (MLA's latent pools and the n_kv_heads=1 pools whole);
  the last-position prefill logits lie within ``LOGIT_TOL`` of the
  reference's; every decode tick makes the derived collectives;
  ``put_global_tree`` / ``gather_global_tree`` round-trip the global
  weights bit for bit; and a ``ManifestWatcher`` with the server's
  shardings lands the swapped-in weights from a checkpoint as each rank's
  blocks.  The reference's own mesh test fails under jax 0.9, so the
  sharded server is held to the reference's unsharded one, which
  ``tests/test_torch_serve.py`` also pins.  The reference's servers build
  in this process and in one helper process at once.
* The slots engine's refusal of a mesh, and what replaced the other two
  refusals: the speculative policy and a "data" axis build on a mesh (their
  streams are held to the reference in ``tests/test_torch_serve_mesh.py``),
  and only an expert layout the MoE cannot compute is refused.

The same equality on the card (two ranks sharing it over gloo) is
``tests/test_torch_gpu.py::test_mesh_streams_equal_one_process_on_the_card``.
"""
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_dense, tiny_mla, tiny_moe
from repro.configs import ASSIGNED
from repro.configs import PAPER_CONFIGS as J_PAPER
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import make_server as jax_make_server
from repro.models.api import build_model as jax_build_model
from repro.models.api import serve_shardings as jax_serve_shardings
from repro.param import is_spec as j_is_spec

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.serve import make_server
from repro_torch.models.api import build_model, serve_shardings
from repro_torch.param import flatten, is_spec as t_is_spec, tree_map
from test_torch_model_parallel import _coordinator
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 120
ARCHS = list(ASSIGNED) + list(J_PAPER)
MESHES = [(1, 2), (2, 2), (1, 16)]
# the sharded prefill's last-position logits against the reference's, max abs
# over max(1, max |logit|): both sum the same f32 products in other orders
# (measured: at most 2.8e-7 over the four configs, before and after the swap)
LOGIT_TOL = 1e-6


def _ns_mesh(dims):
    axes = ("data", "model")
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _leaves(tree, is_leaf):
    out = {}

    def rec(t, path):
        if is_leaf(t):
            out[path] = t
        else:
            for k, v in t.items():
                rec(v, f"{path}/{k}")

    rec(tree, "")
    return out


@pytest.fixture(scope="module")
def ref_merged_rules():
    """The reference's merged serving rules, from its own ``serve_shardings``
    on a one-device mesh."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return jax_serve_shardings(jax_build_model(jax_get_config("tinyllama-1.1b")), mesh)[2]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_shardings_match_the_reference(arch, ref_merged_rules):
    tm, jm = build_model(get_config(arch)), jax_build_model(jax_get_config(arch))
    trees = [(jm.specs(), tm.specs(), "params")]
    try:
        trees.append((jm.paged_cache_specs(33, 16), tm.paged_cache_specs(33, 16), "pools"))
        paged = True
    except NotImplementedError:  # recurrent, cross and encoder blocks do not page
        paged = False
    n = 0
    for dims in MESHES:
        mesh = _ns_mesh(dims)
        psh, csh, merged = serve_shardings(tm, mesh, n_pages=33 if paged else None,
                                           page_size=16)
        assert merged == ref_merged_rules
        assert (csh is None) == (not paged)
        for jt, tt, what in trees:
            got = _leaves(psh if what == "params" else csh, lambda x: isinstance(x, tuple))
            plain = _leaves(tsh.param_shardings(tt, mesh, merged),
                            lambda x: isinstance(x, tuple))
            jl, tl = _leaves(jt, j_is_spec), _leaves(tt, t_is_spec)
            assert got.keys() == jl.keys() == tl.keys() == plain.keys()
            for k, s in jl.items():
                want = tuple(jsh.logical_spec(s.shape, s.axes, mesh, ref_merged_rules))
                assert got[k] == plain[k] == want, (dims, what, k)
                n += 1
    assert n > 0


def test_local_slices_cut_blocks_major_to_minor():
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 4})
    shape, spec = (16, 8, 3), (("model", "data"), "data", None)
    seen = set()
    for d in range(2):
        for m in range(4):
            sl = tsh.local_slices(shape, spec, mesh, coord=(d, m))
            assert sl[0] == slice((m * 2 + d) * 2, (m * 2 + d + 1) * 2)
            assert sl[1] == slice(d * 4, (d + 1) * 4) and sl[2] == slice(0, 3)
            seen.add((sl[0].start, sl[1].start))
    assert len(seen) == 8
    assert tsh.split_factors(spec, mesh) == (8, 2, 1)
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_slices((6,), ("model",), mesh, coord=(0, 0))


def test_mesh_is_refused_by_the_slots_engine_and_the_speculative_policy():
    """The slots engine refuses a mesh.  The speculative policy and a
    "data" axis no longer do: on plain axis objects (coordinate 0, no
    process group) a speculative server lays out its draft and pool, and a
    2x1 server holds the weights whole (replicated over "data"); experts
    that only a "data" axis divides are refused by name."""
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=torch.float32)
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="paged engine"):
        make_server(cfg, engine="slots", mesh=mesh, device="cpu")
    one = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 1})
    srv = make_server(cfg, policy="speculative", mesh=one, device="cpu", batch=2, max_seq=32,
                      page_size=8)
    assert srv.policy.draft_params and srv.policy._pool_sh is not None
    wide = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 1})
    srv = make_server(cfg, mesh=wide, device="cpu", batch=2, max_seq=32, page_size=8)
    specs = flatten(srv.model.specs())
    assert all(tuple(v.shape) == specs[k].shape for k, v in flatten(srv.params).items())
    moe6 = _torch_cfg("moe").replace(n_experts=6)  # 6 experts: ("model", "data") -> "data"
    square = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="only experts over"):
        make_server(moe6, mesh=square, device="cpu", batch=2, max_seq=32, page_size=8)


# ---------------------------------------------------------------------------
# one spawn of two gloo ranks: every config on a 1x2 mesh

CASES = ("dense", "kv1", "moe", "mla")
KV1 = dict(n_kv_heads=1)


def _jax_cfg(name):
    if name == "moe":
        return tiny_moe(compute_dtype=jnp.float32)
    if name == "mla":
        return tiny_mla(compute_dtype=jnp.float32)
    return tiny_dense(compute_dtype=jnp.float32, **(KV1 if name == "kv1" else {}))


# ``helpers``' tiny configs built field for field on the port's side, and the
# reference mesh test's prompts (four short ones and a pair sharing a
# 16-token prefix: the second runs the extend step); the ranks run this too
SHARED_SRC = textwrap.dedent("""
    def _torch_cfg(name):
        from repro_torch.config import BlockSpec, ModelConfig, Stage, uniform_stages
        base = dict(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab_size=256,
                    stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                    remat="none", attn_impl="plain", compute_dtype=torch.float32)
        if name == "kv1":
            base.update(n_kv_heads=1)
        elif name == "moe":
            base.update(name="t-moe", family="moe", n_experts=4, moe_top_k=2, moe_d_ff=64,
                        n_shared_experts=1,
                        stages=(Stage((BlockSpec("attn", "dense"),), 1),
                                Stage((BlockSpec("attn", "moe"),), 2)))
        elif name == "mla":
            base.update(name="t-mla", family="moe", attn_type="mla", q_lora_rank=32,
                        kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, qk_norm=False, n_kv_heads=4)
        return ModelConfig(**base)


    def _prompts(vocab):
        rng = np.random.default_rng(1)
        shared = rng.integers(0, vocab, size=16)
        prompts = [rng.integers(0, vocab, size=int(n)) for n in rng.integers(4, 14, size=4)]
        prompts += [np.concatenate([shared, rng.integers(0, vocab, size=3 + i)])
                    for i in range(2)]
        return prompts
""")
exec(SHARED_SRC)


def _derived_collectives(cfg: ModelConfig, m: int = 2) -> dict:
    """Collectives one decode step makes on a "model" axis of ``m``: the
    embedding's sum and the logits' gather (vocabulary split), a sum per
    attention layer (heads split), per dense FFN (columns split), and per
    MoE layer the router's gather (experts split) and one sum."""
    ar = ag = 0
    if cfg.padded_vocab % m == 0:
        ar, ag = 1, 1
    for st in cfg.stages:
        for bs in st.pattern * st.repeats:
            ar += cfg.n_heads % m == 0
            if bs.ffn == "moe":
                ag += cfg.n_experts % m == 0
                ar += 1
            else:
                ar += cfg.d_ff % m == 0
    return {"all_reduce": ar, "all_gather": ag}


WORKER = textwrap.dedent("""
    import os
    import time
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.distributed import (gather_global_tree, put_global_tree,
                                         tensor_parallel as tp)
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.serve import ManifestWatcher, Request, make_server
    from repro_torch.param import flatten, unflatten
    RANK, OUT = int(os.environ["RANK"]), os.environ["OUT"]
""") + SHARED_SRC + textwrap.dedent("""
    assert init_distributed(os.environ["COORD"], 2, RANK, device="cpu") == "gloo"
    mesh = make_cli_mesh("1x2", num_processes=2, device="cpu")
    for name in os.environ["CASES"].split(","):
        cfg = _torch_cfg(name)
        deadline = time.time() + 100
        while not os.path.exists(f"{OUT}/{name}_w.npz"):  # the reference saves it
            assert time.time() < deadline, f"no weights for {name}"
            time.sleep(0.05)
        w = np.load(f"{OUT}/{name}_w.npz")
        trees = [unflatten({k[3:]: torch.from_numpy(w[k]) for k in w.files if k[:3] == p})
                 for p in ("p0/", "p1/")]
        prompts = _prompts(cfg.vocab_size)
        srv = make_server(cfg, engine="paged", batch=3, max_seq=48, page_size=8,
                          device="cpu", mesh=mesh)
        ticks = []
        decode_once = srv.decode_once

        def counted():
            tp.reset_counts()
            out = decode_once()
            ticks.append(tp.counts())
            return out

        srv.decode_once = counted
        rec = {}
        for i, (base, tree) in enumerate(zip((0, 100), trees)):
            srv.set_params(tree)  # the global tree, cut to this rank's blocks
            back = flatten(gather_global_tree(srv.params, srv._param_shardings, mesh))
            again = flatten(put_global_tree(tree, srv._param_shardings, mesh))
            rec[f"roundtrip{i}"] = (
                all(torch.equal(back[k], v) for k, v in flatten(tree).items())
                and all(torch.equal(again[k], v) for k, v in flatten(srv.params).items()))
            done = srv.run([Request(base + j, p, 6) for j, p in enumerate(prompts)])
            rec[f"streams{i}"] = {r.rid: r.out for r in done if r.rid >= base}
            logits, _ = srv.prefill(srv.params, torch.from_numpy(prompts[4][None]))
            rec[f"logits{i}"] = logits[0].numpy()
        # the swapped-in weights again, from a checkpoint through a watcher
        # with the server's shardings: each leaf lands as this rank's block
        watcher = ManifestWatcher(CheckpointManager(f"{OUT}/{name}_ckpt"), like=srv.params,
                                  shardings=srv._param_shardings, mesh=mesh)
        step, landed = watcher.poll()
        rec["watcher"] = step == 1 and all(
            torch.equal(flatten(landed)[k], v) for k, v in flatten(srv.params).items())
        rec["ticks"] = ticks
        rec["pools"] = {k: tuple(v.shape) for k, v in flatten(srv.pages).items()}
        rec["leaves"] = {k: tuple(v.shape) for k, v in flatten(srv.params).items()}
        rec["stats"] = srv.stats()
        torch.save(rec, f"{OUT}/{name}_rank{RANK}.pt")
    dist.destroy_process_group()
""")


# the reference's servers build and compile in two processes at once: this
# one and a helper (``REF_HELPER``) that takes ``HELPER_CASES``
HELPER_CASES = ("moe",)
REF_HELPER = textwrap.dedent("""
    import os, sys, torch
    import test_torch_tensor_parallel as t
    out = os.environ["OUT"]
    for name in t.HELPER_CASES:
        ref, swap_in = t._reference_server(name, out)
        torch.save(t._reference_run(name, ref, swap_in), os.path.join(out, f"{name}_want.pt"))
""")


def _reference_server(name, out):
    """The reference's unsharded server for case ``name``, after its weights
    (the server's init, and for the hot swap that init moved by seeded noise
    of 0.02) are saved for the ranks: ``{name}_w.npz``, which appears whole
    and last, and the swapped-in weights as a checkpoint."""
    rng = np.random.default_rng(42 + CASES.index(name))
    ref = jax_make_server(_jax_cfg(name), engine="paged", batch=3, max_seq=48, page_size=8)
    p0 = jax.tree.map(np.asarray, ref.params)
    p1 = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype), p0)
    CheckpointManager(os.path.join(out, f"{name}_ckpt")).save(
        1, {"params": tree_map(torch.from_numpy, p1)}, meta={"step": 1})
    part = os.path.join(out, f"{name}_w.part.npz")
    np.savez(part, **{f"p{i}/{k}": v for i, t in enumerate((p0, p1))
                      for k, v in flatten(t).items()})
    os.replace(part, os.path.join(out, f"{name}_w.npz"))
    return ref, p1


def _reference_run(name, ref, swap_in) -> dict:
    """The reference server's streams and the last-position logits of its
    own prefill of ``prompts[4]`` (a shape its run compiled), before and
    after the hot swap."""
    prompts = _prompts(ref.cfg.vocab_size)
    w = {}
    for i, base in enumerate((0, 100)):
        if i:
            ref.set_params(jax.tree.map(jnp.asarray, swap_in))
        done = ref.run([JaxRequest(base + j, p, 6) for j, p in enumerate(prompts)])
        w[f"streams{i}"] = {r.rid: r.out for r in done if r.rid >= base}
        logits, _ = ref.prefill(ref.params, jnp.asarray(prompts[4][None], jnp.int32),
                                None, None)
        w[f"logits{i}"] = np.asarray(logits[0])
    return w


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Start the reference's helper, save this process's cases' weights,
    start the two ranks (each waits for a case's weights), serve the
    reference's unsharded streams and prefill logits meanwhile, then
    collect every record."""
    out = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(("src", "tests")), OMP_NUM_THREADS="1",
               OUT=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", REF_HELPER], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    want = {}
    try:
        refs = {name: _reference_server(name, str(out))
                for name in CASES if name not in HELPER_CASES}
        coord = _coordinator(out, "spawn_1x2")
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(env, RANK=str(rank), COORD=coord, CASES=",".join(CASES))))
        want = {name: _reference_run(name, *ref) for name, ref in refs.items()}
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for who, p, text in zip(("the reference's helper", "rank 0", "rank 1"), procs, outs):
        assert p.returncode == 0, f"{who} failed:\n{text}"
    for name in HELPER_CASES:
        want[name] = torch.load(out / f"{name}_want.pt", weights_only=False)
    got = {name: [torch.load(out / f"{name}_rank{r}.pt", weights_only=False)
                  for r in range(2)] for name in CASES}
    return want, got


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_streams_equal_the_reference_unsharded_streams(mesh_run, name):
    want, got = mesh_run
    for i in (0, 1):  # before and after the hot swap
        for rank in range(2):
            assert got[name][rank][f"streams{i}"] == want[name][f"streams{i}"], (name, i, rank)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_logits_match_the_reference(mesh_run, name):
    want, got = mesh_run
    for i in (0, 1):
        w = want[name][f"logits{i}"]
        for rank in range(2):
            gap = np.abs(got[name][rank][f"logits{i}"] - w).max() / max(1.0, np.abs(w).max())
            assert gap <= LOGIT_TOL, (name, i, rank, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_pools_and_weights_are_really_sharded(mesh_run, name):
    _, got = mesh_run
    cfg = _torch_cfg(name)
    rec = got[name][0]
    assert got[name][1]["pools"] == rec["pools"]
    whole = {k: s.shape for k, s in flatten(build_model(cfg).paged_cache_specs(19, 8)).items()}
    assert rec["pools"].keys() == whole.keys()
    for k, shape in rec["pools"].items():
        if cfg.attn_type == "mla" or name == "kv1":  # no head axis, or one head: whole
            assert shape == whole[k], k
        else:  # [layers, n_pages, page_size, KH / 2, D]
            assert shape == whole[k][:3] + (cfg.n_kv_heads // 2,) + whole[k][4:], k
    leaves = rec["leaves"]
    mixer = "stages/stage_0/b0/mixer/"
    q = leaves[mixer + ("wq_b" if cfg.attn_type == "mla" else "wq")]
    assert q[2] == cfg.n_heads // 2
    assert leaves["embed/tok"][0] == cfg.padded_vocab // 2
    if name == "kv1":  # kv_heads stay whole beside the split heads
        assert leaves[mixer + "wk"][2] == 1
    if name == "moe":  # the experts split, and so do the router's columns
        assert leaves["stages/stage_1/b0/ffn/w_gate"][1] == cfg.n_experts // 2
        assert leaves["stages/stage_1/b0/ffn/router"][2] == cfg.n_experts // 2
    st = rec["stats"]
    assert st["mesh"] == "1x2"
    whole = st["pool_bytes_global"] == st["pool_bytes_local"]
    assert whole == (cfg.attn_type == "mla" or name == "kv1")
    assert rec["roundtrip0"] and rec["roundtrip1"]
    assert rec["watcher"] and got[name][1]["watcher"]


@pytest.mark.parametrize("name", list(CASES))
def test_every_decode_tick_makes_the_derived_collectives(mesh_run, name):
    _, got = mesh_run
    want = _derived_collectives(_torch_cfg(name))
    for rank in range(2):
        ticks = got[name][rank]["ticks"]
        assert ticks and all(t == want for t in ticks), (name, rank, want, ticks[:3])
    assert want["all_reduce"] == 7 and want["all_gather"] == (3 if name == "moe" else 1)
