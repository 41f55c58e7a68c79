#!/usr/bin/env python3
"""Where the serving path's time goes on the card (PyTorch/CUDA port).

Serves ``chip_smoke.py``'s phase-4 traffic (TinyLlama-1.1B, 22 layers, bf16
compute, batch 8, 16 requests of 40..1536 prompt tokens, 32 new tokens each)
three times: once to warm up; once with the host clock around every prefill,
extend and decode step (each ends in a host read of the argmax, so the step
is complete when the clock stops); once under ``torch.profiler``, whose
tracing slows the host several-fold, so only device times are read from it.
With ``--policy speculative`` (phase 13's traffic, at ``make_server``'s
default ``draft_k`` of 4) the clock also stands around each draft prefill,
draft step and verify step.  Prints:

  * host wall time per step kind (count, total, mean, p50, p90), unprofiled,
    and the policy's stats (rounds, accept rate, draft/verify split);
  * device kernel time by category (the flash forward, paged decode's split
    and merge bodies together, matrix products, everything else) and the top
    kernels by name, from the profiled run;
  * the device's busy share: kernel time over the unprofiled run's wall.

One JSON line at the end carries the same numbers.  Needs one CUDA card:

    python3 scripts/profile_torch_serve.py [--policy speculative]
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

CATEGORIES = (("flash_attention_fwd", r"flash_fwd_(mma_)?kernel"),
              ("paged_attention_decode", r"paged_decode_(split|merge)_kernel"),
              ("matmul", r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitK"),
              ("other", r"."))


def _stats(xs):
    a = np.asarray(xs) * 1e3
    return {"n": len(a), "total_ms": float(a.sum()), "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)), "p90_ms": float(np.percentile(a, 90))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", choices=("greedy", "speculative"), default="greedy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_server

    dev = torch.device("cuda", 0)
    cfg = get_config("tinyllama-1.1b")
    srv = make_server(cfg, batch=8, max_seq=2048, page_size=16, policy=args.policy,
                      device=dev)
    walls = defaultdict(list)

    def timed(kind, fn):
        def step(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.argmax(out[0], -1).cpu()  # what the engine reads next
            walls[kind(a)].append(time.perf_counter() - t0)
            return out
        return step

    srv.prefill = timed(lambda a: "prefill", srv.prefill)
    srv.paged_step = timed(lambda a: "decode" if a[2].shape[1] == 1 else "extend",
                           srv.paged_step)
    if args.policy == "speculative":
        pol = srv.policy
        pol.draft_prefill = timed(lambda a: "draft_prefill", pol.draft_prefill)
        pol.draft_step = timed(lambda a: "draft", pol.draft_step)
        pol.verify = timed(lambda a: "verify", pol.verify)
    traffic = lambda: cs._requests(cs.BF16_LENGTHS, 32, cfg.vocab_size, cs.BF16_SHARED)
    srv.run(traffic())  # warm-up: first launches, allocator
    srv.reset()
    walls.clear()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = srv.run(traffic())
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    steps = {k: _stats(v) for k, v in walls.items()}
    policy_stats = srv.stats()
    srv.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        srv.run(traffic())
        torch.cuda.synchronize(dev)
    profiled_wall = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_cat, spans = defaultdict(float), defaultdict(float), []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        cat = next(c for c, pat in CATEGORIES if re.search(pat, e.name))
        by_cat[cat] += us
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):  # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    kernel_ms = sum(by_cat.values()) / 1e3
    result = {
        "device": torch.cuda.get_device_name(0), "policy": args.policy, "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall, "steps": steps,
        "stats": policy_stats,
        "profiled_wall_s": profiled_wall, "kernel_ms": kernel_ms,
        "kernel_ms_by_category": {k: v / 1e3 for k, v in by_cat.items()},
        "device_busy_share_of_wall": busy / 1e6 / wall,
        "top_kernels_ms": {k: v / 1e3 for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }
    print(f"[profile] {len(done)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.1f} tok/s) unprofiled; {profiled_wall:.3f}s profiled")
    for k, v in steps.items():
        print(f"[profile] host wall per {k} step: {v}")
    print(f"[profile] stats {policy_stats}")
    print(f"[profile] device kernel time {kernel_ms:.1f} ms by category: "
          f"{result['kernel_ms_by_category']}")
    print(f"[profile] device busy {result['device_busy_share_of_wall']:.3f} of the "
          f"unprofiled wall")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
