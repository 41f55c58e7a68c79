"""The tolerance of ``chip_smoke.py`` phase 38(a): how far a GPT-Base train
step on a ``--mesh 1x2`` of two processes sharing the card lands from one
process's step on the same weights and batch, clean and with planted faults.

    python3 scripts/train_mesh_gaps.py          # on the card; ~2 min

One process takes two steps here (the launcher's init and batches of
``chip_smoke.TRAIN_MESH_ARGS``, GPT-Base at full width, bf16); two ranks
take the same steps on a 1x2 mesh, once clean and once per planted fault:

* ``entry-layer0-ffn``: layer 0's FFN input skips its backward sum
  (``tp.enter_split``'s second call of the forward, after layer 0's
  attention input, is the identity);
* ``entry-all``: every backward sum skipped;
* ``norm-local``: the clipping norm not summed over "model".

Each prints the relative gaps of the first step's loss and grad_norm and of
the second step's loss.  The forward is untouched by these faults, so the
first loss agrees in all of them; grad_norm and the second loss carry them.
``remat`` is "none" here (the same bits as "full": ``chip_smoke.py`` phase
33), so each call of the forward builds the graph its backward runs.
"""
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

FAULTS = ("clean", "entry-layer0-ffn", "entry-all", "norm-local")


def _setup(dev):
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, init_train_state

    cfg = C._paper("gpt-base").replace(remat="none")
    tc = C.train_mesh_tc(C.TRAIN_MESH_ARGS)
    model = build_model(cfg)
    params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
    return model, tc, params, opt, make_batch_fn(cfg, tc, device=dev)


def _plant(fault):
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import api

    if fault.startswith("entry"):
        enter, calls = tp.enter_split, {"n": 0}

        def planted(x):
            calls["n"] += 1
            if fault == "entry-all" or calls["n"] == 2:  # attention 0, then FFN 0
                return x
            return enter(x)

        tp.enter_split = planted
        return calls
    if fault == "norm-local":  # the train step's only use of tp: the norm's sum
        api.tp = type("tp", (), {"all_reduce_sum": staticmethod(lambda t: t)})()
    return None


def rank_main(rank, coordinator, fault, out):
    from repro_torch.distributed import make_grad_reduce, put_global_tree
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.models.api import make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_distributed(coordinator, 2, rank, device=dev)
    mesh = make_cli_mesh("1x2", num_processes=2, device=dev)
    model, tc, params, _, batch_fn = _setup(dev)
    params = put_global_tree(params, train_state_shardings(model, tc, mesh)[0], mesh)
    calls = _plant(fault)
    step = make_train_step(model, tc, grad_reduce=make_grad_reduce("none", mesh), mesh=mesh)
    opt, got = adamw_init(params, tc), []
    for i in range(2):
        if calls is not None:
            calls["n"] = 0
        params, opt, _, m = step(params, opt, None, batch_fn(i))
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
    tmp = tempfile.mkdtemp(prefix="train_mesh_gaps_")
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
        if fault == "clean":  # a planted fault may part the ranks' replicated leaves
            assert got[0] == got[1], got
        g = got[0]
        print(f"[{fault}] first loss {rel(g[0]['loss'], one[0]['loss']):.3e}, first grad_norm "
              f"{rel(g[0]['grad_norm'], one[0]['grad_norm']):.3e}, second loss "
              f"{rel(g[1]['loss'], one[1]['loss']):.3e}  (ranks {got})", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    if "--rank" in sys.argv:
        i = sys.argv.index("--rank")
        rank_main(int(sys.argv[i + 1]), *sys.argv[i + 2:i + 5])
    else:
        main()
