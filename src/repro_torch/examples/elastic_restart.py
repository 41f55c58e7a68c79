"""Fault-tolerance demo, three acts:

1. plain training: checkpoint, simulate preemption, resume onto a mesh
   layout (``CheckpointManager.restore(shardings=, mesh=)``: the checkpoint
   holds logical arrays, so the layout at restore may differ from the one
   that saved);
2. V-cycle training: SIGKILL-style preemption in the middle of the upward
   sweep, then auto-resume at the exact (phase, level, step) -- the pending
   de-coalesce/interpolate transition replays deterministically, with the
   resumed run on a mesh (``train_vcycle_ckpt(mesh=)``);
3. multi-process: a real 2-process V-cycle run of the launcher (``--mesh
   2x1``, a localhost coordinator, coordinated checkpoints), preempted by a
   SIGTERM to ONE process -- the drain flag all-reduces, so both save the
   same step and exit 0 -- then resumed by a SINGLE process (checkpoints are
   process-count-elastic).

One process per device: acts 1 and 2 run on a 1x1 mesh of this process,
act 3's two processes share the card (or the CPU with ``--device cpu``).
The checkpoints go under the temporary directory (``TMPDIR``).

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import torch
import torch.distributed as dist

import repro_torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.vcycle import VCycleRunner
from repro_torch.device import default_device
from repro_torch.examples import Printer
from repro_torch.launch.mesh import make_cli_mesh
from repro_torch.launch.train import make_batch_fn, make_vcycle_save_cb, train_vcycle_ckpt
from repro_torch.models.api import (build_model, init_train_state, make_train_step,
                                    train_state_shardings)


def ckpt_dirs() -> Dict[str, str]:
    """The three acts' checkpoint directories, under the temporary one."""
    tmp = tempfile.gettempdir()
    return {k: os.path.join(tmp, f"elastic_demo_{k}ckpt") for k in ("", "vcycle_", "mp_")}


class Preempted(RuntimeError):
    """Stand-in for a SIGKILL: aborts the process mid-training."""


def _gen(dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0)


def act_plain(dev, pr: Printer) -> Dict:
    ckpt = ckpt_dirs()[""]
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    tc = TrainConfig(steps=12, warmup_steps=1, batch_size=4, seq_len=32, log_every=2)
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    step = make_train_step(model, tc)
    cm = CheckpointManager(ckpt)

    params, opt = init_train_state(model, tc, _gen(dev))
    pr.say("== phase 1: train 6 steps on 'mesh A' then checkpoint ==")
    for i in range(6):
        params, opt, m = step(params, opt, batch_fn(i))
    cm.save(6, {"params": params, "opt": opt}, meta={"step": 6})
    pr.say(f"checkpointed at step 6 (loss {float(m['loss']):.4f})")

    pr.say("== simulated preemption: process state dropped ==")
    del params, opt

    pr.say("== phase 2: resume onto a different mesh layout ==")
    # one process per device: this process's mesh is 1x1; the mechanism is the
    # same for any DxM -- pass the target layout and restore() cuts each
    # process's blocks from the logical arrays
    mesh_b = make_cli_mesh("1x1", device=dev)
    p0, o0 = init_train_state(model, tc, _gen(dev))
    psh, osh = train_state_shardings(model, tc, mesh_b)
    restored, meta = cm.restore({"params": p0, "opt": o0}, device=dev,
                                shardings={"params": psh, "opt": osh}, mesh=mesh_b)
    params, opt = restored["params"], restored["opt"]
    shape = dict(zip(mesh_b.mesh_dim_names, mesh_b.shape))
    pr.say(f"resumed from step {meta['step']} onto mesh {shape}")
    for i in range(meta["step"], tc.steps):
        params, opt, m = step(params, opt, batch_fn(i))
    pr.say(f"finished at step {tc.steps} (loss {float(m['loss']):.4f}) -- "
           "deterministic data sharding made the resumed stream identical")
    return {"loss": float(m["loss"]), "resumed_from": meta["step"]}


def act_vcycle(dev, pr: Printer) -> Dict:
    ckpt = ckpt_dirs()["vcycle_"]
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    tc = TrainConfig(steps=12, warmup_steps=1, batch_size=2, seq_len=16, log_every=4)
    ml = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)
    cm = CheckpointManager(ckpt)

    pr.say("== phase 1: V-cycle, checkpoint every 2 steps, die mid-upward-sweep ==")
    runner = VCycleRunner(cfg, ml, tc, make_batch_fn(cfg, tc, device=dev), seed=0,
                          verbose=True, device=dev)
    save_cb = make_vcycle_save_cb(cm, schedule=runner.plan)
    killed_at = None

    def killing_cb(state, params, opt_state):
        nonlocal killed_at
        save_cb(state, params, opt_state)
        if state.phase == "up":
            killed_at = state.global_step
            raise Preempted(f"preempted at global step {state.global_step}")

    try:
        runner.run(ckpt_cb=killing_cb, ckpt_every=2)
    except Preempted as e:
        cm.wait()  # a real SIGKILL relies on atomic publish instead
        pr.say(f"== {e}; restarting fresh ==")

    pr.say("== phase 2: auto-resume picks up inside the upward sweep, and "
           "re-shards onto a mesh while doing it ==")
    # the checkpoint was written unsharded, the resumed run is on a mesh:
    # params, opt and the stashed params_before_* trees land on its level
    # layouts (1x1 for one process; the launcher's `--mesh 2x1` does the
    # same after a `--mesh 1x2` save)
    mesh = make_cli_mesh("1x1", device=dev)
    out = train_vcycle_ckpt(cfg, ml, tc, ckpt=cm, ckpt_every=4, mesh=mesh, device=dev)
    pr.say(f"finished: final loss {out.history.loss[-1]:.4f}, "
           f"total FLOPs {out.total_flops:.3e}")
    return {"killed_at": killed_at, "final_loss": out.history.loss[-1],
            "total_flops": out.total_flops, "steps": len(out.history.loss)}


def _launcher(device) -> List[str]:
    ckpt = ckpt_dirs()["mp_"]
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "tinyllama-1.1b", "--smoke", "--vcycle", "--levels", "2",
            "--steps", "40", "--batch", "4", "--seq", "16", "--f32",
            "--ckpt-dir", ckpt, "--ckpt-every", "1000"]
    if device is not None:
        args += ["--device", str(device)]
    return args


def _env() -> Dict[str, str]:
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path else ""))


def act_multiprocess(device, pr: Printer) -> Dict:
    ckpt = ckpt_dirs()["mp_"]
    shutil.rmtree(ckpt, ignore_errors=True)
    pr.say("== phase 1: 2-process V-cycle (localhost coordinator), SIGTERM "
           "delivered to process 1 only ==")
    coord = f"{ckpt}.coord"  # process 0 writes the port it binds here
    if os.path.exists(coord):
        os.remove(coord)
    mp = ["--mesh", "2x1", "--coordinator", f"file://{coord}", "--num-processes", "2"]
    logs = [f"{ckpt}.rank{i}.log" for i in (0, 1)]
    os.makedirs(ckpt, exist_ok=True)
    procs = []
    for i in (0, 1):
        with open(logs[i], "w") as lf:
            procs.append(subprocess.Popen(_launcher(device) + mp + ["--process-id", str(i)],
                                          env=_env(), stdout=lf, stderr=subprocess.STDOUT))
    # wait until training is demonstrably stepping (past the first segment),
    # so the SIGTERM lands mid-cycle with the preemption handler installed
    try:
        deadline = time.time() + 240
        while time.time() < deadline and all(p.poll() is None for p in procs):
            with open(logs[0]) as f:
                if "coalescing" in f.read():
                    break
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)  # ONE process gets the notice...
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:  # a wedged drain must not leave orphans training
            if p.poll() is None:
                p.kill()
                p.wait()
    # ...and the all-reduced drain flag makes BOTH save the same step + exit 0
    drains = []
    for i, p in enumerate(procs):
        with open(logs[i]) as f:
            out = f.read()
        drain = [ln for ln in out.splitlines() if "[preempt]" in ln]
        drains.append(drain[-1] if drain else "")
        pr.say(f"process {i}: exit {p.returncode}; " + (drain[-1] if drain else "(no drain line)"))

    pr.say("== phase 2: the 2-process checkpoint resumes under ONE process ==")
    res = subprocess.run(_launcher(device), env=_env(), capture_output=True, text=True,
                         timeout=480)
    resumed = []
    for ln in res.stdout.splitlines():
        if "resumed at phase=" in ln or "total training FLOPs" in ln:
            pr.say(ln)
            resumed.append(ln)
    meta = (CheckpointManager(ckpt_dirs()["mp_"]).latest() or {}).get("meta", {})
    return {"exit_codes": [p.returncode for p in procs], "drains": drains,
            "resume_rc": res.returncode, "resumed": resumed, "final_phase": meta.get("phase"),
            "resume_output": res.stdout + res.stderr}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    pr = Printer()
    own_group = not dist.is_initialized()
    try:
        pr.out["plain"] = act_plain(dev, pr)
        pr.out["vcycle"] = act_vcycle(dev, pr)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    pr.out["multiprocess"] = act_multiprocess(args.device, pr)
    return pr.out


if __name__ == "__main__":
    main()
