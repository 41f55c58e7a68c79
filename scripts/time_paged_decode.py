#!/usr/bin/env python3
"""Device time of the paged-decode kernel of one or more source trees, side
by side on one card, and of each CUDA kernel it launches.

Each ``SRC`` is a directory holding a ``repro_torch`` package (default: this
repository's ``src``), for example an unpacked earlier commit's ``src``.
Each is run in a process of its own, in the order given, so list them in
turns (``A B B A``) to compare two.  Every run builds that tree's kernels,
then times ``paged_attention_decode_cuda`` with ``chip_smoke.time_ms``
(device time, L2 flushed) at ``chip_smoke.py`` phase 5's shapes: the middle
decode tick of phase 4 (B = 8, KH = 4, G = 8, D = 64, P = 16, M = 128, its
lengths), one sequence at 2047 positions and eight at 2048, bf16, int64
tables whose padding points at a NaN page; each output is held to the plain
version.  Then ``torch.profiler`` records 10 more calls, each after the same
L2 flush and device spin, and the mean duration of each kernel the call
launched is reported by name (the flush and the spin left out).  Needs one
CUDA card:

    python3 scripts/time_paged_decode.py [SRC ...]

Prints one JSON line per run and, last, one with each tree's mean per shape.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# lengths of chip_smoke.py phase 4's middle decode tick (PERF.md, section 6)
SHAPES = {"middle tick": [401, 1301, 1101, 258, 65, 1235, 91, 701],
          "B=1 len 2047": [2047], "B=8 len 2048": [2048] * 8}


def run_one(src: str) -> dict:
    """Times of the tree under ``src``, imported before chip_smoke puts this
    repository's ``src`` on the path."""
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.kernels import paged_attention as pa

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    res = {"src": src, "package": os.path.dirname(pa.__file__)}
    for name, lengths in SHAPES.items():
        q, kp, vp, bt, bt_poisoned, ln = cs.paged_inputs(dev, torch.bfloat16, lengths, gen)
        got = pa.paged_attention_decode_cuda(q, kp, vp, bt_poisoned, ln)
        err = (got.float() - pa.paged_attention_decode_torch(q, kp, vp, bt, ln).float()
               ).abs().max().item()
        cs.check(err <= cs.TOL[torch.bfloat16], f"{src} {name}: max|err| {err}")
        call = lambda: pa.paged_attention_decode_cuda(q, kp, vp, bt_poisoned, ln)
        res[name] = cs.time_ms(call, dev)
        res[name + " kernels_us"] = kernel_means(call, dev)
    return res


def kernel_means(call, dev, iters=10) -> dict:
    """Mean device duration (us) of each kernel ``call`` launches, by name
    up to its template arguments, under ``torch.profiler``."""
    import re

    import torch
    import chip_smoke as cs

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            call()
        torch.cuda.synchronize(dev)
    total = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not re.search(
                r"FillFunctor|spin_kernel", e.name):
            name = re.sub(r"^void ", "", e.name.replace("(anonymous namespace)::", ""))
            head, _, args = name.split("(")[0].partition("<")
            total[(head.split("::")[-1] + ("<" + args if args else ""))[:80]] += \
                e.time_range.elapsed_us()
    return {k: v / iters for k, v in total.items()}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_paged_decode: needs a CUDA card", file=sys.stderr)
        return 1
    times = defaultdict(lambda: defaultdict(list))
    for src in argv or [os.path.join(ROOT, "src")]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", src],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        for name in SHAPES:
            times[src][name].append(res[name])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mean_ms": {
        src: {k: sum(v) / len(v) for k, v in by.items()} for src, by in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
