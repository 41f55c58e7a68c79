"""The dry run: what every production cell costs one rank, with no card and
nothing allocated (the counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell and each production mesh
(16x16 = 256 devices, and 2x16x16 = 512 with a leading "pod" axis;
``launch/mesh.py::make_production_mesh``), this builds the real step --
the FSDP ``train_step`` (gradients, AdamW, grad-accum microbatches) for
train shapes, ``prefill_step`` / ``serve_step`` for inference shapes --
on meta tensors holding one rank's blocks of the parameters, optimizer
state, batch and caches, and runs it once under
``launch/op_cost.py::OpCounter`` over PyTorch's fake process group.  The
hand-written kernels run as their meta forms and report their costs
(``kernels/dispatch.py``'s ``meta`` backend).  Each cell's record holds the
memory summary (whether the rank's peak fits the H100's 80 GiB), the
collectives, the three-term roofline on H100 rates (``launch/analysis.py``)
and the parameter count, and is appended to a resumable JSON.

Layouts are the reference's: training and prefill place parameters under
the training ``RULES`` (FSDP over the data axes, tensor and expert
parallel over "model"; prefill gathers each layer's weights); decode places
them under ``SERVE_RULES`` and splits the dense caches' sequence over
"model" (``mesh_ctx(dense_serving=True)``).  The numbers are rank 0's: the
ranks of a layout do the same work, except where a rank's block differs
(the shared expert's partial on data coordinate 0 when experts split over
("model", "data")).

Usage (each mesh in a process of its own, as the fake group is global)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--out dryrun_out]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import ASSIGNED, cell_is_skipped, get_config
from repro_torch.core import flops as flops_lib
from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import RULES, SERVE_RULES, mesh_ctx, mesh_shape
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.analysis import collective_stats, memory_summary, roofline
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.api import (build_model, make_prefill_step, make_serve_step,
                                    make_train_step, train_state_specs)

DEFAULT_OUT = "dryrun_out"
MESH_NAMES = {False: "16x16", True: "2x16x16"}


def serve_rules() -> Dict[str, Any]:
    """The decode cells' rules: ``RULES`` overlaid with ``SERVE_RULES``
    (dense caches keep ``"cache_seq": "model"``, their heads whole)."""
    return dict(RULES, **SERVE_RULES)


def lower_cell(arch: str, shape: ShapeConfig, mesh, *, cfg: Optional[ModelConfig] = None,
               verbose: bool = True) -> Dict[str, Any]:
    """Run one cell's step once on ``mesh`` under the counter, as the rank
    this process plays in it; returns its record.  ``cfg`` replaces the
    arch's registered config (a reduced one, in tests)."""
    cfg = specs_lib.model_config_for(get_config(arch) if cfg is None else cfg, shape)
    tc = specs_lib.train_config_for(cfg, shape)
    model = build_model(cfg)
    pspecs = model.specs()
    n_dev = math.prod(mesh_shape(mesh).values())
    rules = serve_rules() if shape.kind == "decode" else RULES
    params = specs_lib.local_tree(pspecs, mesh, rules, dtype=cfg.param_dtype)
    counter = OpCounter()
    t0 = time.time()
    if shape.kind == "train":
        _, o_specs = train_state_specs(model, tc)
        opt = {"m": specs_lib.local_tree(o_specs["m"], mesh, rules, dtype=tc.opt_dtype),
               "v": specs_lib.local_tree(o_specs["v"], mesh, rules, dtype=tc.opt_dtype),
               "count": 0}
        batch, axes = specs_lib.train_inputs(cfg, shape, tc.grad_accum)
        batch = specs_lib.local_tree(batch, mesh, rules, axes=axes)
        step = make_train_step(model, tc, mesh=mesh)
        counter.add_arguments(params, opt, batch)
        with counter:
            out = step(params, opt, batch)
        tokens = shape.global_batch * shape.seq_len
        model_flops = flops_lib.model_flops_reference(cfg, pspecs, tokens, train=True)
    elif shape.kind == "prefill":
        batch, axes = specs_lib.prefill_inputs(cfg, shape)
        batch = specs_lib.local_tree(batch, mesh, rules, axes=axes)
        step = make_prefill_step(model)
        counter.add_arguments(params, batch)
        with counter, fsdp.fsdp_ctx(mesh), mesh_ctx(mesh, dense_serving=True):
            out = step(params, batch["tokens"], batch.get("img_embeds"),
                       batch.get("enc_frames"))
        tokens = shape.global_batch * shape.seq_len
        model_flops = flops_lib.model_flops_reference(cfg, pspecs, tokens, train=False)
    else:  # decode
        toks, pos, cache_specs = specs_lib.decode_inputs(cfg, shape)
        caches = specs_lib.local_tree(cache_specs, mesh, rules, dtype=cfg.compute_dtype)
        toks = specs_lib.local_tree(toks, mesh, rules, axes=("batch", "seq"))
        pos = specs_lib.local_tree(pos, mesh, rules, axes=("batch",))
        step = make_serve_step(model)
        counter.add_arguments(params, caches, toks, pos)
        with counter, mesh_ctx(mesh, dense_serving=True):
            out = step(params, caches, toks, pos)
        tokens = shape.global_batch  # one new token per sequence
        model_flops = flops_lib.model_flops_reference(cfg, pspecs, tokens, train=False)
    counter.finish(out)
    del out
    trace_s = time.time() - t0
    rl = roofline(counter, n_dev, model_flops)
    colls = collective_stats(counter)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": "x".join(map(str, mesh_shape(mesh).values())),
        "rank": dist.get_rank(), "status": "ok", "trace_s": round(trace_s, 1),
        "memory": memory_summary(counter), "collectives": colls, "roofline": rl.to_dict(),
        "params": flops_lib.total_params(pspecs),
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
    }
    if verbose:
        mem = rec["memory"]
        print(f"  memory: peak {mem['peak_bytes_est'] / 2**30:.2f} GiB a device "
              f"(arguments {mem['argument_bytes'] / 2**30:.2f}), fits {mem['fits']}")
        print(f"  cost: flops={counter.flops:.3e} bytes={counter.bytes:.3e}")
        tally = {k: (v["count"], f"{v['bytes']:.2e}B") for k, v in colls.items()}
        print(f"  collectives: {tally}")
        print(f"  roofline: compute={rl.t_compute * 1e3:.1f}ms memory={rl.t_memory * 1e3:.1f}ms "
              f"collective={rl.t_collective * 1e3:.1f}ms -> {rl.bottleneck}-bound, "
              f"useful={rl.useful_flops_ratio:.2f} frac={rl.roofline_fraction:.2f}", flush=True)
    return rec


def _load(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def run_mesh(multi_pod: bool, archs, shapes, path: str, force: bool):
    """Every selected cell of one mesh in this process; returns (ok, skipped,
    failed) counts.  ``path`` is read and rewritten after every cell, so an
    interrupted run resumes where it stopped."""
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = MESH_NAMES[multi_pod]
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for sname in shapes:
            key = f"{arch}|{sname}|{mesh_name}"
            results = _load(path)
            skip = cell_is_skipped(arch, sname)
            if skip:
                results[key] = {"status": "skipped", "reason": skip}
                n_skip += 1
            elif results.get(key, {}).get("status") == "ok" and not force:
                n_ok += 1
                continue
            else:
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, SHAPES[sname], mesh)
                    results[key] = rec
                    n_ok += 1
                    print(f"[dryrun] {key} OK (trace {rec['trace_s']}s)", flush=True)
                except Exception as e:  # noqa: BLE001 -- a failure is the cell's record
                    results[key] = {"status": "fail", "error": f"{type(e).__name__}: {e}",
                                    "traceback": traceback.format_exc()[-2000:]}
                    n_fail += 1
                    print(f"[dryrun] {key} FAIL: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
    return n_ok, n_skip, n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "dryrun.json")
    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.mesh == "both":  # one process per mesh: the fake group is process-global
        rc = 0
        for m in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", args.arch,
                   "--shape", args.shape, "--mesh", m, "--out", args.out] + (
                       ["--force"] if args.force else [])
            rc = max(rc, subprocess.call(cmd))
        raise SystemExit(rc)
    n_ok, n_skip, n_fail = run_mesh(args.mesh == "multi", archs, shapes, path, args.force)
    print(f"[dryrun] done: ok={n_ok} skip={n_skip} fail={n_fail} -> {path}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
