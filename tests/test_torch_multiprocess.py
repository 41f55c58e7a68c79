"""The port's data parallelism across spawned gloo processes on the CPU
(three spawns, each with its own timeout).

* ``ef_int8_psum`` over 2 ranks against the reference's under
  ``jax.vmap(axis_name="pod")``: the reduced sums bit for bit (the int32
  payload sums times the shared scale), the residuals within 1 ulp of each
  leaf's target magnitude, and exactly two collectives per call; the
  process count and index of ``distributed/multiprocess.py``.
* ``HierarchicalInt8EF.reduce`` over 4 ranks on a 2x2x1 ("pod", "data",
  "model") mesh against the reference's under vmaps over "pod" and "data".
* A 2-process ``--mesh 2x1`` V-cycle of ``helpers.mp_arena``'s problem (tiny
  dense, f32, batch 4, 12 steps), dense and int8_ef, each against the
  port's 1-process run of the same reduction on the same global stream
  (dense: the plain step, which the dense step at world 1 equals; int8_ef:
  a 1x1 mesh), losses and final parameters within bounds set from the
  measured gaps (printed), and the two ranks' parameters bit-identical.

The reference's own multi-process tests fail under jax 0.9.0, so the
2-process runs are held against the port's 1-process run, which
``tests/test_torch_resume.py`` holds against the reference.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import ef_int8_psum as jax_ef_int8_psum
from repro.distributed.reduce import HierarchicalInt8EF as JaxHierarchicalInt8EF
from test_torch_model_parallel import _coordinator

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 120
# bounds on the 2-process V-cycle's largest loss and parameter gaps to the
# 1-process run of the same reduction, about 3.6x the measured gaps: dense
# sums the two halves' f32 gradients in another order (loss 4.77e-7,
# parameters 2.76e-6); int8_ef quantizes each half on its own (3.43e-4,
# 8.30e-4)
GAP_BOUND = {"dense": 1e-5, "int8_ef": 3e-3}


PRELUDE = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
""")


# seeded per-rank gradients and EF residuals of three leaves at other
# magnitudes (numpy); the workers run the same source
GRADS_SRC = textwrap.dedent("""
    def _grads(rank):
        rng = np.random.default_rng(100 + rank)
        g = {"a": rng.standard_normal((16, 8)) * 0.3, "b": rng.standard_normal(32) * 2.0,
             "c": rng.standard_normal((4, 4, 4)) * 1e-3}
        e = {k: rng.standard_normal(v.shape) * 0.002 * np.abs(v).max() for k, v in g.items()}
        return ({k: v.astype(np.float32) for k, v in g.items()},
                {k: v.astype(np.float32) for k, v in e.items()})
""")
exec(GRADS_SRC)


def _spawn(body: str, n: int, out_dir, **env):
    """Run ``body`` after ``PRELUDE`` and ``GRADS_SRC`` in ``n`` processes;
    every rank must exit 0
    within ``TIMEOUT`` seconds."""
    src = PRELUDE + GRADS_SRC + textwrap.dedent(body)
    procs = []
    for rank in range(n):
        wenv = dict(os.environ, PYTHONPATH="src" + os.pathsep + "tests", OMP_NUM_THREADS="1",
                    RANK=str(rank), WORLD=str(n), OUT=str(out_dir), **env)
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=wenv, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs




def _ulp_close(got, want, target):
    """Within 1 ulp of the magnitude of ``target`` (each leaf's)."""
    ulp = np.spacing(np.float32(np.abs(target).max()))
    assert np.abs(got - want).max() <= ulp


def test_ef_int8_psum_over_two_and_hierarchical_reduce_over_four_ranks(tmp_path):
    # 2 ranks: ef_int8_psum on the default group
    _spawn("""
    dist.init_process_group("gloo", init_method=f"file://{OUT}/store2", rank=RANK,
                            world_size=N)
    from repro_torch.distributed import compression as C
    g, e = _grads(RANK)
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda t, *a, **k: (calls.append(str(k.get("op"))), real(t, *a, **k))[1]
    out, new_e = C.ef_int8_psum({k: torch.from_numpy(v) for k, v in g.items()},
                                {k: torch.from_numpy(v) for k, v in e.items()})
    dist.all_reduce = real
    assert len(calls) == 2 and C.ef_psum_calls() == 1, calls
    np.savez(f"{OUT}/psum{RANK}.npz", **{"out_" + k: v.numpy() for k, v in out.items()},
             **{"ef_" + k: v.numpy() for k, v in new_e.items()})
    from repro_torch.distributed import multiprocess as M
    assert (M.process_count(), M.process_index(), M.is_primary()) == (N, RANK, RANK == 0)
    dist.destroy_process_group()
    """, 2, tmp_path)
    gs, es = zip(*(_grads(r) for r in range(2)))
    stack = lambda trees: {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}
    jout, jef = jax.vmap(lambda g, e: jax_ef_int8_psum(g, e, "pod"), axis_name="pod")(
        stack(gs), stack(es))
    for r in range(2):
        got = np.load(tmp_path / f"psum{r}.npz")
        for k in gs[0]:
            assert np.array_equal(got["out_" + k], np.asarray(jout[k][r])), (r, k)
            _ulp_close(got["ef_" + k], np.asarray(jef[k][r]), gs[r][k] + es[r][k])

    # 4 ranks on 2x2x1: mean within "data", int8 + EF across "pod"
    _spawn("""
    dist.init_process_group("gloo", init_method=f"file://{OUT}/store4", rank=RANK,
                            world_size=N)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import make_grad_reduce
    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    gr = make_grad_reduce("int8_ef", mesh)
    assert (gr.dcn_axis, gr.ici_axes, gr.dcn_size) == ("pod", ("data",), 2)
    g, e = _grads(RANK)
    out, new_e = gr.reduce({k: torch.from_numpy(v) for k, v in g.items()},
                           {k: torch.from_numpy(v)[None] for k, v in e.items()})
    np.savez(f"{OUT}/hier{RANK}.npz", **{"out_" + k: v.numpy() for k, v in out.items()},
             **{"ef_" + k: v.numpy() for k, v in new_e.items()})
    dist.destroy_process_group()
    """, 4, tmp_path)
    gs, es = zip(*(_grads(r) for r in range(4)))
    g4 = {k: jnp.asarray(np.stack([[gs[2 * p + d][k] for d in range(2)] for p in range(2)]))
          for k in gs[0]}
    e4 = {k: jnp.asarray(np.stack([[es[2 * p + d][k][None] for d in range(2)]
                                   for p in range(2)])) for k in es[0]}
    jgr = JaxHierarchicalInt8EF(data_axes=("pod", "data"), dcn_axis="pod", ici_axes=("data",),
                                dcn_size=2)
    jout, jef = jax.vmap(jax.vmap(jgr.reduce, axis_name="data"), axis_name="pod")(g4, e4)
    for r in range(4):
        p, d = divmod(r, 2)
        got = np.load(tmp_path / f"hier{r}.npz")
        for k in gs[0]:
            assert np.array_equal(got["out_" + k], np.asarray(jout[k][p, d])), (r, k)
            target = np.asarray(g4[k][p]).mean(0) / 2 + es[r][k]
            _ulp_close(got["ef_" + k], np.asarray(jef[k][p, d]), target)


WORKER_VCYCLE = """
    import dataclasses
    from repro_torch.config import (BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig,
                                    uniform_stages)
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.launch.train import train_vcycle_ckpt
    from repro_torch.param import flatten
    assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"
    mesh = make_cli_mesh("2x1", num_processes=N, device="cpu")
    cfg = ModelConfig(name="t-dense", family="dense", d_model=32, n_heads=4, n_kv_heads=2,
                      d_ff=64, vocab_size=128,
                      stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                      remat="none", attn_impl="plain", compute_dtype=torch.float32)
    tc = TrainConfig(steps=12, warmup_steps=1, peak_lr=3e-4, batch_size=4, seq_len=16,
                     log_every=2)
    ml = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)
    from repro_torch.distributed import gather_global_tree
    from repro_torch.models.api import build_model, train_state_shardings
    for comp in ("dense", "int8_ef"):
        t = dataclasses.replace(tc, grad_compression=comp)
        out = train_vcycle_ckpt(cfg, ml, t, ckpt=None, ckpt_every=0, verbose=False,
                                device="cpu", mesh=mesh)
        psh = train_state_shardings(build_model(cfg), t, mesh)[0]  # FSDP blocks: gathered
        torch.save({"params": flatten(gather_global_tree(out.params, psh, mesh)),
                    "loss": out.history.loss}, f"{OUT}/{comp}{RANK}.pt")
    dist.destroy_process_group()
"""


def test_two_process_vcycle_matches_the_single_process_run(tmp_path):
    from repro_torch.config import MultiLevelConfig, TrainConfig
    from repro_torch.launch.mesh import make_cli_mesh
    from repro_torch.launch.train import train_vcycle_ckpt
    from repro_torch.param import flatten
    from test_torch_distributed import MLKW, _port_cfg

    _spawn(WORKER_VCYCLE, 2, tmp_path, COORD=_coordinator(tmp_path, "vcycle"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tc = TrainConfig(steps=12, warmup_steps=1, peak_lr=3e-4, batch_size=4, seq_len=16,
                         log_every=2)
        one = {}
        for comp, mesh in (("dense", None), ("int8_ef", "1x1")):
            if mesh is not None:
                mesh = make_cli_mesh(mesh, num_processes=1, device="cpu")
            try:
                one[comp] = train_vcycle_ckpt(
                    _port_cfg(), MultiLevelConfig(**MLKW),
                    dataclasses.replace(tc, grad_compression=comp if mesh else "none"),
                    ckpt=None, ckpt_every=0, verbose=False, device="cpu", mesh=mesh)
            finally:
                if mesh is not None:
                    torch.distributed.destroy_process_group()
    finally:
        torch.set_num_threads(n)
    for comp in ("dense", "int8_ef"):
        want = flatten(one[comp].params)
        r0, r1 = (torch.load(tmp_path / f"{comp}{r}.pt") for r in range(2))
        assert r0["params"].keys() == want.keys()
        for k in want:
            assert torch.equal(r0["params"][k], r1["params"][k]), (comp, k)
        assert r0["loss"] == r1["loss"]
        assert len(r0["loss"]) == len(one[comp].history.loss)
        loss_gap = np.abs(np.asarray(r0["loss"]) - np.asarray(one[comp].history.loss)).max()
        param_gap = max((r0["params"][k] - want[k]).abs().max().item() for k in want)
        print(f"[2-process {comp}] loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
        bound = GAP_BOUND[comp]
        assert loss_gap <= bound and param_gap <= bound, (comp, loss_gap, param_gap)
