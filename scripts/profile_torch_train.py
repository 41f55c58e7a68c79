#!/usr/bin/env python3
"""Where a training step's time goes on the card (PyTorch/CUDA port).

One of the paper's models as ``chip_smoke.py`` trains it
(``chip_smoke.train_setup``), at every level of its V-cycle (``--model``):

  * ``gpt-base`` (phase 7): 12 layers, d_model 768, batch 8, seq 1024,
    2 levels;
  * ``bert-large`` (phase 8): 24 layers, d_model 1024, MLM batches of 8 at
    seq 512, the 3 levels of the paper's Table 4;
  * ``deit-b`` (phase 9): 12 layers, d_model 768, 64 images of 197 tokens,
    2 levels, peak rate 6.25e-5;
  * ``xlstm-125m`` (phase 19): 12 recurrent layers (mLSTM, one sLSTM per
    six), d_model 768, batch 8 at ``chip_smoke.XLSTM_TRAIN``'s sequence, 2
    levels (a step issues hundreds of thousands of small kernels: profile
    it with ``--steps 1``).

All at bf16 compute, f32 master weights, ``remat="full"``, on the family's
own batches (``launch/train.py::make_batch_fn``).  For each level: two
warm-up steps, then ``--steps`` steps with the host clock around
each (every step ends in a host read of its loss, so the step is complete
when the clock stops), then the same number of steps under
``torch.profiler``, whose tracing slows the host, so only device times are
read from it.  Batches are drawn before the clock starts.  Also times the
two transitions between levels 0 and 1 (coalesce; de-coalesce +
interpolate).  Prints:

  * host wall per step (mean, p50, p90) and tokens/s (images/s for
    DeiT), unprofiled;
  * device kernel time per step by category (the flash forward, dq and
    dk/dv kernels, matrix products, copies and casts, reductions, other
    elementwise kernels) and the top kernels, and the device time of one
    AdamW update alone;
  * the device's busy share: kernel time (union of intervals) over the
    unprofiled wall of as many steps;
  * peak ``max_memory_allocated`` per level.

One JSON line at the end carries the same numbers.  Needs one CUDA card:

    python3 scripts/profile_torch_train.py [--model bert-large]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the setups phases 7-9 train)

CATEGORIES = (("flash_attention_fwd", r"flash_fwd_(mma_)?kernel"),
              ("flash_attention_bwd_dq", r"flash_bwd_dq_(mma_)?kernel"),
              ("flash_attention_bwd_dkv", r"flash_bwd_dkv_(mma_)?kernel"),
              ("matmul", r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitK"),
              ("copy_and_cast", r"copy_kernel|cat_|CatArray"),
              ("reduction", r"reduce_kernel|softmax|logsumexp"),
              ("other_elementwise", r"."))


def _busy_us(events) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if e > end:  # union of kernel intervals
            busy += e - max(s, end)
            end = e
    return busy


def profile_level(model, tc, batches, dev, steps: int):
    from repro_torch.models.api import make_train_step
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.param import flatten, unflatten

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params, tc)
    step = make_train_step(model, tc)
    for i in range(2):  # warm-up: first launches, allocator growth
        params, opt, m = step(params, opt, batches[i])
        float(m["loss"])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i % len(batches)])
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(steps):
            params, opt, m = step(params, opt, batches[i % len(batches)])
            float(m["loss"])
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # the optimizer alone, on this level's parameters (device time)
    grads = {k: torch.zeros_like(v) for k, v in flatten(params).items()}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    adamw_update(params, unflatten(grads), opt, tc)
    ev1.record()
    ev1.synchronize()
    by_name, by_cat = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_cat[next(c for c, pat in CATEGORIES if re.search(pat, e.name))] += us
    a = np.asarray(walls) * 1e3
    vit = model.cfg.family == "vit"
    per_step = tc.batch_size if vit else tc.batch_size * tc.seq_len
    return params, {
        "step_ms": {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                    "p90": float(np.percentile(a, 90)), "n": len(a)},
        "images_per_s" if vit else "tokens_per_s": per_step / (a.mean() / 1e3),
        "kernel_ms_per_step": sum(by_cat.values()) / 1e3 / steps,
        "kernel_ms_per_step_by_category": {k: v / 1e3 / steps for k, v in by_cat.items()},
        "kernels_per_step": len(kernels) / steps,
        "adamw_update_ms": ev0.elapsed_time(ev1),
        "device_busy_share_of_wall": _busy_us(kernels) / 1e3 / float(a.sum()),
        "peak_max_memory_allocated_gib": peak / 2**30,
        "top_kernels_ms_per_step": [(k, v / 1e3 / steps) for k, v in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", choices=("gpt-base", "bert-large", "deit-b", "xlstm-125m"),
                    default="gpt-base")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import operators as ops
    from repro_torch.core.plans import build_plan
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, ml, tc = chip_smoke.train_setup(args.model)
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    batches = [batch_fn(g) for g in range(4)]
    cfgs = [cfg]
    for _ in range(ml.n_levels - 1):
        cfgs.append(build_plan(cfgs[-1], ml).small_cfg)
    plan = build_plan(cfg, ml)
    result = {"device": torch.cuda.get_device_name(0), "model": args.model, "levels": {}}
    params0 = None
    unit = "images_per_s" if cfg.family == "vit" else "tokens_per_s"
    for level, c in enumerate(cfgs):
        params, r = profile_level(build_model(c), tc, batches, dev, args.steps)
        params0 = params if level == 0 else params0
        result["levels"][level] = r
        print(f"[profile] {args.model} level {level} ({c.n_layers}L d_model {c.d_model}): "
              f"step {r['step_ms']} ms, {r[unit]:.1f} {unit}, device kernel time "
              f"{r['kernel_ms_per_step']:.2f} ms/step by category "
              f"{r['kernel_ms_per_step_by_category']}, {r['kernels_per_step']:.0f} kernels per "
              f"step, one AdamW update {r['adamw_update_ms']:.2f} ms, busy "
              f"{r['device_busy_share_of_wall']:.3f} of the wall, peak "
              f"{r['peak_max_memory_allocated_gib']:.2f} GiB", flush=True)
    specs = build_model(cfg).specs()
    down = ops.make_coalesce_fn(specs, cfg, ml, plan=plan)
    up = ops.make_decoalesce_fn(specs, cfg, ml, plan=plan)
    walls = defaultdict(list)
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        small = down(params0)
        torch.cuda.synchronize(dev)
        walls["coalesce_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ops.interpolate(params0, up(small), ml.alpha)
        torch.cuda.synchronize(dev)
        walls["decoalesce_interpolate_ms"].append((time.perf_counter() - t0) * 1e3)
    result["transitions"] = {k: v for k, v in walls.items()}
    print(f"[profile] transitions (3 runs each, host wall): {result['transitions']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
