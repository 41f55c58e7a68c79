"""Context-parallel training's tolerance on the card: the gap of a 1x3 step's
first loss and grad norm from one process's, clean and with planted faults.

``chip_smoke.py`` phase 40(c) holds a context-parallel (CP) step on a
``--mesh 1x3`` to one process's step within ``CP_TOL``.  This script
measures the gap that tolerance has to sit between, at phase 40(c)'s cut of
Qwen3-14B (full width, one layer, bf16 state, batch 1 x 3072):

  * clean: the 1x3 CP step against the same step on one process;
  * three planted faults, each a context manager of :func:`plant`:
    ``offset`` (every chunk's causal mask starts at row 0, as if the query
    offset were dropped), ``input_sum`` (the layer's input enters the split
    region without its backward sum, so K/V's and q's input gradients stay
    one chunk's partial) and ``swap`` (chunks 0 and 1 exchanged in the
    sequence gather).

The tolerance lies between the clean gap and the least planted fault.
``tests/test_torch_context_parallel.py`` plants the same faults on the CPU
and shows each breaks the match with the reference.

Run on the card (three processes share it over gloo; ~3 min held)::

    python3 scripts/cp_gaps.py            # prints one JSON line per case

``--cpu`` runs the same cases at a narrow width on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys

import torch

FAULTS = ("offset", "input_sum", "swap")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@contextlib.contextmanager
def plant(fault: str):
    """Patch one planted fault into context-parallel attention (the
    module-level functions it calls), restored on exit."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.layers import attention as A

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
    mod, name = (A, "run_attention") if fault == "offset" else (
        tp, "enter_split_all" if fault == "input_sum" else "all_gather_cat")
    orig = getattr(mod, name)

    def offset(q, k, v, cfg, *, q_offset=0, q_positions=None, **kw):
        return orig(q, k, v, cfg, q_offset=0, **kw,
                    q_positions=None if q_positions is None else q_positions - q_offset)

    def input_sum(xs, axes=tp.MODEL):
        return [xs[0]] + orig(list(xs[1:]), axes)

    def swap(x, dim=-1, axes=tp.MODEL):
        y = orig(x, dim, axes)
        if dim != 1:
            return y
        c = x.shape[1]
        idx = torch.cat([torch.arange(c, 2 * c), torch.arange(c),
                         torch.arange(2 * c, y.shape[1])]).to(y.device)
        return y.index_select(1, idx)

    setattr(mod, name, {"offset": offset, "input_sum": input_sum, "swap": swap}[fault])
    try:
        yield
    finally:
        setattr(mod, name, orig)


def cut_config(cpu: bool):
    """Phase 40(c)'s Qwen3-14B cut: full width, one layer, bf16 parameters
    (or the smoke widths at f32 with ``cpu``)."""
    from repro_torch.config import BlockSpec, uniform_stages
    from repro_torch.configs import get_config

    if cpu:
        return get_config("qwen3-14b", smoke=True).replace(
            compute_dtype=torch.float32, attn_impl="blockwise", attn_block_k=64,
            stages=uniform_stages(1, BlockSpec("attn", "dense")))
    return get_config("qwen3-14b").replace(
        param_dtype=torch.bfloat16, stages=uniform_stages(1, BlockSpec("attn", "dense")))


RANK_SRC = r"""
import json, os, sys, torch
sys.path.insert(0, os.path.join(os.environ["ROOT"], "scripts"))
import cp_gaps as G
from repro_torch.config import TrainConfig
from repro_torch.distributed import put_global_tree
from repro_torch.launch.mesh import init_distributed, make_cli_mesh, rank_device
from repro_torch.models.api import build_model, make_train_step, train_state_shardings
from repro_torch.optim import adamw_init
rank, n, cpu = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["CPU"] == "1"
dev = torch.device("cpu") if cpu else rank_device("cuda", rank)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = G.cut_config(cpu)
S = 390 if cpu else 3072
tc = TrainConfig(steps=4, warmup_steps=1, peak_lr=1e-4, batch_size=1, seq_len=S,
                 eps=1e-4, opt_dtype=torch.float32 if cpu else torch.bfloat16)
model = build_model(cfg)
gen = torch.Generator(device=dev).manual_seed(0)
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=g).to(dev),
         "labels": torch.randint(0, cfg.vocab_size, (1, S), generator=g).to(dev)}
mesh = None
if n > 1:
    init_distributed(os.environ["COORD"], n, rank, device=dev)
    mesh = make_cli_mesh(f"1x{n}", num_processes=n, device=dev)
out = {}
for case in ("clean",) + (G.FAULTS if n > 1 else ()):
    params = model.init(gen.manual_seed(0))
    if mesh is not None:
        params = put_global_tree(params, train_state_shardings(model, tc, mesh)[0], mesh)
    opt = adamw_init(params, tc)
    step = make_train_step(model, tc, mesh=mesh)
    with (G.plant(case) if case != "clean" else G.contextlib.nullcontext()):
        m = step(params, opt, batch)[2]
    out[case] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del params, opt, step
    torch.cuda.empty_cache()
if rank == 0:
    print("CP_GAPS " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(n: int, cpu: bool) -> dict:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), ROOT=ROOT, WORLD=str(n),
               CPU="1" if cpu else "0", COORD=f"127.0.0.1:{port}", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SRC], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} of {n} failed:\n{text[-3000:]}"
           for r, (p, text) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise SystemExit("\n".join(bad))
    line = next(x for x in outs[0].splitlines() if x.startswith("CP_GAPS "))
    return json.loads(line[len("CP_GAPS "):])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the smoke widths on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("cp_gaps.py needs a CUDA card (or --cpu)")
    one = _run(1, args.cpu)["clean"]
    mesh = _run(3, args.cpu)
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    for case, m in mesh.items():
        print(json.dumps({"case": case, "loss": m["loss"], "grad_norm": m["grad_norm"],
                          "loss_gap": abs(m["loss"] - one["loss"]),
                          "grad_norm_gap": abs(m["grad_norm"] - one["grad_norm"]),
                          # relative, as phase 40(c) holds them
                          "rel_gaps": [abs(m[k] - one[k]) / abs(one[k])
                                       for k in ("loss", "grad_norm")],
                          "one_process": one}))


if __name__ == "__main__":
    main()
