"""The tolerance of ``chip_smoke.py`` phase 39(a) and (b): how far a GPT-Base
train step on a ``--mesh 2x1`` of two processes sharing the card (FSDP, the
weights gathered per layer or once a step) lands from one process's step on
the same weights and global batch, clean and with planted faults.

    python3 scripts/fsdp_gaps.py          # on the card; ~3 min

One process takes two steps here (the launcher's init and batches of
``chip_smoke.FSDP_ARGS``: GPT-Base at full width, all 12 layers, bf16,
remat "full", 2 x 1024); two ranks take the same steps on a 2x1 mesh, a row
each, once clean per gather mode (per layer, ``pregather_params``) and once
per planted fault of the per-layer mode:

* ``no-division``: the reduce-scatter's sums not divided by the data axes'
  size (every split leaf's gradient doubled);
* ``block-order``: the first gather of each step (the embedding, the head
  and the final norm) concatenates its blocks in the wrong order (each
  leaf's halves swapped along its ``embed`` dim; swapped in every layer
  alike, the halves would only permute the residual stream's basis);
* ``layer-unreduced``: the first reduce-scatter of each backward (the last
  layer's) skipped, each rank keeping its own block of its own gradient.

Each prints the relative gaps of the first step's loss and grad_norm and of
the second step's loss.  (A layer's gather skipped in the remat backward
could only reuse the forward's gathered weights, the same values: it shows
in the collective counts ``chip_smoke.py`` pins, not in these gaps.)
"""
import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as C  # noqa: E402

FAULTS = ("clean", "pregather", "no-division", "block-order", "layer-unreduced")


def _setup(dev, pregather=False):
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, init_train_state

    cfg = C._paper("gpt-base")
    tc = C.train_mesh_tc(C.FSDP_ARGS)
    tc = dataclasses.replace(tc, pregather_params=pregather)
    model = build_model(cfg)
    params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
    return model, tc, params, opt, make_batch_fn(cfg, tc, device=dev)


def _plant(fault):
    from repro_torch.distributed import fsdp

    if fault == "no-division":
        rs = fsdp.reduce_scatter_flat
        fsdp.reduce_scatter_flat = lambda w, d, m, a: [2 * x for x in rs(w, d, m, a)]
    elif fault == "block-order":
        whole, calls = fsdp._whole, {"n": 0}

        def planted(flat, n, shapes, dims):
            calls["n"] += 1
            if calls["n"] == 1:  # the step's first gather: the leaves outside the stacks
                flat = flat.view(n, -1).flip(0).reshape(-1)
            return whole(flat, n, shapes, dims)

        fsdp._whole = planted
        return calls
    elif fault == "layer-unreduced":
        rs, calls = fsdp.reduce_scatter_flat, {"n": 0}

        def planted(wholes, dims, mesh, axes):
            calls["n"] += 1
            if calls["n"] > 1:
                return rs(wholes, dims, mesh, axes)
            rank = torch.distributed.get_rank()
            return [g.narrow(d, rank * (g.shape[d] // 2), g.shape[d] // 2).contiguous()
                    for g, d in zip(wholes, dims)]

        fsdp.reduce_scatter_flat = planted
        return calls
    return None


def rank_main(rank, coordinator, fault, out):
    from repro_torch.distributed import put_global_tree
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.launch.train import make_driver_batch_fn
    from repro_torch.models.api import make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_distributed(coordinator, 2, rank, device=dev)
    mesh = make_cli_mesh("2x1", num_processes=2, device=dev)
    model, tc, params, _, _ = _setup(dev, pregather=fault == "pregather")
    params = put_global_tree(params, train_state_shardings(model, tc, mesh)[0], mesh)
    batch_fn = make_driver_batch_fn(model.cfg, tc, mesh, device=dev)
    calls = _plant(fault)
    step = make_train_step(model, tc, mesh=mesh)
    opt, got = adamw_init(params, tc), []
    for i in range(2):
        if calls is not None:
            calls["n"] = 0
        params, opt, m = step(params, opt, batch_fn(i))
        got.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    torch.save(got, out)
    torch.distributed.destroy_process_group()


def main():
    from repro_torch.models.api import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(C.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip())
    C.build_phase()
    model, tc, params, opt, batch_fn = _setup(dev)
    step = make_train_step(model, tc)
    one = []
    for i in range(2):
        params, opt, m = step(params, opt, batch_fn(i))
        one.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    del params, opt
    torch.cuda.empty_cache()
    print(f"one process: {one}")
    rel = lambda a, b: abs(a - b) / abs(b)
    tmp = tempfile.mkdtemp(prefix="fsdp_gaps_")
    for fault in FAULTS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        outs = [os.path.join(tmp, f"{fault}_{r}.pt") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), coord, fault,
                                   outs[r]], cwd=ROOT) for r in range(2)]
        codes = [p.wait(timeout=600) for p in procs]
        if codes != [0, 0]:
            raise SystemExit(f"{fault}: ranks exited {codes}")
        got = [torch.load(o) for o in outs]
        for o in outs:
            os.remove(o)
        if fault in ("clean", "pregather"):
            assert got[0] == got[1], got
        g = got[0]
        print(f"[{fault}] first loss {rel(g[0]['loss'], one[0]['loss']):.3e}, first grad_norm "
              f"{rel(g[0]['grad_norm'], one[0]['grad_norm']):.3e}, second loss "
              f"{rel(g[1]['loss'], one[1]['loss']):.3e}, second grad_norm "
              f"{rel(g[1]['grad_norm'], one[1]['grad_norm']):.3e}  (ranks {got})", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    if "--rank" in sys.argv:
        i = sys.argv.index("--rank")
        rank_main(int(sys.argv[i + 1]), *sys.argv[i + 2:i + 5])
    else:
        main()
