#!/usr/bin/env python3
"""Where a checkpoint's time goes, for one or more source trees side by side
on one card: GPT-Base's level-0 train state (123.7 M f32 parameters, AdamW
moments ``m`` and ``v`` filled with random values so no two leaves share
content, and ``count``: 1.48 GB in 57 tensors), as ``chip_smoke.py``
phase 11 saves it at level 0.

Each ``SRC`` is a directory holding a ``repro_torch`` package (default: this
repository's ``src``).  Each is run in a process of its own, in the order
given, so list them in turns (``A B B A``) to compare two.  Per run, three
repetitions into a fresh directory under ``$TMPDIR`` of:

* ``snapshot_s``: every leaf copied off the card (``store.as_host_leaf``);
* ``digest_s``: every leaf's blake2b digest (``store.leaf_digest``);
* ``write_s``: every leaf's npy object written into the pool
  (``ObjectStore.put``);
* ``save_s``: a whole blocking ``CheckpointManager.save`` of the state into
  another fresh directory (the three stages, the manifest and the publish);
* ``restore_s``: ``CheckpointManager.restore`` of that save onto like-trees
  on the card, synchronised.

Each restored leaf is held to the saved one bit for bit.  Needs one CUDA
card:

    python3 scripts/time_checkpoint.py [SRC ...]

Prints one JSON line per run and, last, one with each tree's mean per stage.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("snapshot_s", "digest_s", "write_s", "save_s", "restore_s")


def run_one(src: str, reps: int = 3) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import store as store_lib
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, init_train_state
    from repro_torch.param import flatten, tree_map

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt = init_train_state(build_model(get_config("gpt-base")), TrainConfig(), gen)
    rand = lambda t: torch.randn(t.shape, generator=gen, device=dev, dtype=t.dtype) * 1e-3
    opt = {"m": tree_map(rand, opt["m"]), "v": tree_map(lambda t: rand(t).abs(), opt["v"]),
           "count": 25}
    state = {"params": params, "opt": opt}
    leaves = [v for v in flatten(state).values() if isinstance(v, torch.Tensor)]
    res = {"src": src, "package": os.path.dirname(store_lib.__file__),
           "bytes": sum(t.numel() * t.element_size() for t in leaves), "leaves": len(leaves)}
    for stage in STAGES:
        res[stage] = []
    for _ in range(reps):
        root = tempfile.mkdtemp(prefix="time_checkpoint_")
        try:
            torch.cuda.synchronize(dev)
            t0 = time.time()
            host = [store_lib.as_host_leaf(t) for t in leaves]
            res["snapshot_s"].append(time.time() - t0)
            t0 = time.time()
            digests = [store_lib.leaf_digest(a) for a in host]
            res["digest_s"].append(time.time() - t0)
            pool = store_lib.ObjectStore(os.path.join(root, "pool"))
            t0 = time.time()
            for d, a in zip(digests, host):
                pool.put(d, a)
            res["write_s"].append(time.time() - t0)
            del host
            mgr = CheckpointManager(os.path.join(root, "ckpt"))
            torch.cuda.synchronize(dev)
            t0 = time.time()
            mgr.save(1, state, meta={"step": 1}, blocking=True)
            res["save_s"].append(time.time() - t0)
            like = {"params": tree_map(torch.zeros_like, params),
                    "opt": {"m": tree_map(torch.zeros_like, opt["m"]),
                            "v": tree_map(torch.zeros_like, opt["v"]), "count": 0}}
            t0 = time.time()
            out, _ = mgr.restore(like)
            torch.cuda.synchronize(dev)
            res["restore_s"].append(time.time() - t0)
            got, want = flatten(out), flatten(state)
            for k, v in want.items():
                ok = got[k] == v if not isinstance(v, torch.Tensor) else torch.equal(got[k], v)
                if not ok:
                    raise RuntimeError(f"{src}: restored leaf {k} differs from the saved one")
            del out, like
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_checkpoint: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    srcs = sys.argv[1:] or [os.path.join(ROOT, "src")]
    runs = []
    for src in srcs:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", src],
                             capture_output=True, text=True, check=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    means = defaultdict(dict)
    for r in runs:
        for stage in STAGES:
            means[r["src"]].setdefault(stage, []).extend(r[stage])
    print(json.dumps({src: {stage: sum(v) / len(v) for stage, v in d.items()}
                      for src, d in means.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
