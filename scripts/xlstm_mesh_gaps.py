"""The tolerance of ``chip_smoke.py`` phase 39(c)'s xLSTM check: how far two
train steps of xLSTM-125m cut to one mLSTM and one sLSTM block
(``chip_smoke._family_cuts``: full width, 2 x 32) on a ``--mesh 1x2`` of two
processes sharing the card land from one process's steps, beside how far
one process lands from itself when only its summation order changes, and
how far planted split faults land.

    python3 scripts/xlstm_mesh_gaps.py          # on the card; ~2 min
    python3 scripts/xlstm_mesh_gaps.py --cpu    # d_model 64, gloo on the CPU, to try it

At f32 and at f64 (the phase's dtype), one process takes the two steps
clean (the yardstick) and perturbed by rounding alone:

* ``head-order``: each xLSTM mixer computed as the two halves of its heads,
  summed: the 1x2 split's arithmetic on one process (``w_down``'s
  contraction and the input's gradient summed in two parts);
* ``norm-order``: the clipping norm's float32 sum of squares (the
  reference's, ``optim/adamw.py``) taken over the leaves in reverse order,
  as 1x2 sums it in another order;
* ``ulp32``: every ``w_down`` scaled by 1 + float32's machine epsilon
  before the first step (AdamW updates in float32 at either dtype);
* ``ulp64`` (f64 only): the same by float64's epsilon.

Two ranks on 1x2 then take the same steps clean at both dtypes, and at f64
once per planted fault:

* ``slstm-no-enter``: the sLSTM's ``enter_split`` dropped (its input's
  gradient not summed over "model": the layers below get one rank's part);
* ``mlstm-no-enter``: the same in the mLSTM;
* ``slstm-heads-swapped``: each rank's two sLSTM heads read out through
  each other's ``w_down`` rows.

Each line prints the relative gaps of the first step's loss and grad_norm
and of the second step's loss and grad_norm against the clean one process
of its dtype.
"""
import os
import socket
import subprocess
import sys
import tempfile
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as C  # noqa: E402

MESH_RUNS = (("f32", "clean"), ("f64", "clean"), ("f64", "slstm-no-enter"),
             ("f64", "mlstm-no-enter"), ("f64", "slstm-heads-swapped"))


def _config(dtype: str, cpu: bool):
    """Phase 39(c)'s xLSTM cut and TrainConfig at ``dtype`` (``--cpu``: at
    d_model 64 and a 512-token vocabulary)."""
    import dataclasses

    cfg, tc = C._family_cuts()["xlstm"]
    if cpu:
        cfg = cfg.replace(d_model=64, vocab_size=512)
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    return cfg.replace(compute_dtype=dt, param_dtype=dt), dataclasses.replace(tc, opt_dtype=dt)


def _head_dims(kind, cfg):
    from repro_torch.layers import ssm

    specs = ssm.MIXERS[kind][0](cfg)
    return {k: s.axes.index("heads") for k, s in specs.items() if "heads" in s.axes}


def _plant(fault: str, cfg) -> None:
    """Replace the xLSTM mixers in ``layers/ssm.py``'s table for ``fault``."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.layers import ssm

    if fault == "head-order":
        # one process, as two model ranks: tp's split test passes for a
        # half, its collectives are identities and the halves are summed here
        shim = types.SimpleNamespace(is_split=lambda local, whole: local != whole,
                                     enter_split=lambda x: x, all_reduce_sum=lambda x: x)
        ssm.tp = shim
        for kind in ("mlstm", "slstm"):
            specs, cache, apply = ssm.MIXERS[kind]
            dims = _head_dims(kind, cfg)

            def halves(p, x, cfg_, cache=None, return_state=False, apply=apply, dims=dims):
                ys = []
                for h in range(2):
                    part = {k: v.narrow(dims[k], h * v.shape[dims[k]] // 2,
                                        v.shape[dims[k]] // 2) if k in dims else v
                            for k, v in p.items()}
                    ys.append(apply(part, x, cfg_, cache, return_state)[0])
                return ys[0] + ys[1], None

            ssm.MIXERS[kind] = (specs, cache, halves)
    elif fault.endswith("-no-enter"):
        kind = fault.split("-")[0]
        specs, cache, apply = ssm.MIXERS[kind]

        def dropped(*a, apply=apply, **k):
            saved, tp.enter_split = tp.enter_split, lambda x: x
            try:
                return apply(*a, **k)
            finally:
                tp.enter_split = saved

        ssm.MIXERS[kind] = (specs, cache, dropped)
    elif fault == "slstm-heads-swapped":
        specs, cache, apply = ssm.MIXERS["slstm"]

        def swapped(p, *a, **k):
            return apply(dict(p, w_down=p["w_down"].flip(0)), *a, **k)

        ssm.MIXERS["slstm"] = (specs, cache, swapped)


def _steps(dev, cfg, tc, mesh=None, ulp=None):
    """``chip_smoke._family_steps``, with every ``w_down`` scaled by 1 +
    ``ulp`` after the seeded init when it is given."""
    if ulp is None:
        return C._family_steps(dev, cfg, tc, mesh)
    from repro_torch.models import api
    from repro_torch.param import flatten

    init = api.Model.init

    def scaled(self, gen):
        params = init(self, gen)
        for k, w in flatten(params).items():
            if k.endswith("mixer/w_down"):
                w.mul_(1 + ulp)
        return params

    api.Model.init = scaled
    try:
        return C._family_steps(dev, cfg, tc, mesh)
    finally:
        api.Model.init = init


def _reversed_norm(dev, cfg, tc):
    """One process's steps with the clipping norm summed in reverse order."""
    from repro_torch.optim import adamw

    sum_squares = adamw.sum_squares
    adamw.sum_squares = lambda gs, device: sum_squares(list(gs)[::-1], device)
    try:
        return C._family_steps(dev, cfg, tc)
    finally:
        adamw.sum_squares = sum_squares


def rank_main(rank, coordinator, out, cpu):
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.layers import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    init_distributed(coordinator, 2, rank, device=dev)
    mesh = make_cli_mesh("1x2", num_processes=2, device=dev)
    table = dict(ssm.MIXERS)
    got = {}
    for dtype, fault in MESH_RUNS:
        cfg, tc = _config(dtype, cpu)
        _plant(fault, cfg)
        got[f"{dtype} {fault}"] = _steps(dev, cfg, tc, mesh)
        ssm.MIXERS.update(table)
    torch.save(got, out)
    torch.distributed.destroy_process_group()


def main(cpu: bool):
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.layers import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if not cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    tmp = tempfile.mkdtemp(prefix="xlstm_mesh_gaps_")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), coord, outs[r]]
                              + (["--cpu"] if cpu else []), cwd=ROOT, env=env)
             for r in range(2)]
    try:
        table = dict(ssm.MIXERS)
        one = {}
        for dtype in ("f32", "f64"):
            cfg, tc = _config(dtype, cpu)
            one[f"{dtype} clean"] = _steps(dev, cfg, tc)
            one[f"{dtype} norm-order"] = _reversed_norm(dev, cfg, tc)
            one[f"{dtype} ulp32"] = _steps(dev, cfg, tc, ulp=torch.finfo(torch.float32).eps)
            if dtype == "f64":
                one[f"{dtype} ulp64"] = _steps(dev, cfg, tc, ulp=torch.finfo(torch.float64).eps)
            _plant("head-order", cfg)
            one[f"{dtype} head-order"] = _steps(dev, cfg, tc)
            ssm.MIXERS.update(table)
            ssm.tp = tp
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if codes != [0, 0]:
        raise SystemExit(f"the ranks exited {codes}")
    ranks = [torch.load(o) for o in outs]
    for o in outs:
        os.remove(o)
    os.rmdir(tmp)
    rel = lambda a, b: abs(a - b) / abs(b)
    rows = [(f"one process, {k}", v) for k, v in one.items() if not k.endswith("clean")]
    rows += [(f"1x2, {k}", v) for k, v in ranks[0].items()]
    for name, got in rows:
        base = one[name.split(", ")[1].split()[0] + " clean"]
        gaps = [rel(got[i][m], base[i][m]) for i in range(2) for m in ("loss", "grad_norm")]
        print(f"[{name}] first loss {gaps[0]:.3e}, first grad_norm {gaps[1]:.3e}, second "
              f"loss {gaps[2]:.3e}, second grad_norm {gaps[3]:.3e}", flush=True)
    for k in ranks[0]:
        if k.endswith("clean"):
            assert ranks[0][k] == ranks[1][k], (k, ranks[0][k], ranks[1][k])
    print("one process, clean: " + "; ".join(
        f"{k}: " + ", ".join(f"{s['loss']:.9g}/{s['grad_norm']:.9g}" for s in v)
        for k, v in one.items() if k.endswith("clean")))


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    if "--rank" in sys.argv:
        i = sys.argv.index("--rank")
        rank_main(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3], cpu)
    else:
        main(cpu)
