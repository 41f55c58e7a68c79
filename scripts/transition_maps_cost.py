#!/usr/bin/env python3
"""Host cost of the V-cycle's transitions at Jamba-1.5-Large's widths, for
one or more source trees of the port.

Builds Jamba-1.5-Large's training cut (blocks b2-b3 at full width: d 8192,
d_ff 24576, Mamba d_inner 16384, 2 experts; 3.46 G parameters) on the card,
then times one coalescing (``make_coalesce_fn``) and one de-coalescing plus
interpolation (``make_decoalesce_fn``, ``interpolate``), each wall with the
card synchronised, and reads the process's peak resident host memory
(``ru_maxrss``) after the init and after each transition.  The width maps a
transition builds on the host (dense n x n/2 f64 matrices, four per axis)
show in that peak.  Each tree runs in a fresh process, in the order given,
so a tree's maps do not stay cached for the next; pass the trees as parent,
change, change, parent to compare two commits on one card.

    python3 scripts/transition_maps_cost.py OLD/src src src OLD/src

Prints one JSON line per run and needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time


def _rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def child(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.config import BlockSpec, ModelConfig, MultiLevelConfig, Stage
    from repro_torch.core import operators as ops
    from repro_torch.models.api import build_model

    dev = torch.device("cuda", 0)
    # Jamba-1.5-Large's widths (src/repro/configs/jamba_1_5_large_398b.py),
    # blocks b2-b3 of its period (Mamba + dense FFN, attention + MoE), 2 experts
    cfg = ModelConfig(name="jamba-1.5-large-398b b2-b3", family="hybrid", d_model=8192,
                      n_heads=64, n_kv_heads=8, d_ff=24576, vocab_size=65536,
                      stages=(Stage((BlockSpec("mamba", "dense"), BlockSpec("attn", "moe")),
                                    1),),
                      n_experts=2, moe_top_k=2, moe_d_ff=24576, mamba_d_state=16,
                      mamba_d_conv=4, mamba_expand=2, tie_embeddings=False)
    ml = MultiLevelConfig()
    model = build_model(cfg)
    specs = model.specs()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    out = {"tree": src, "init_peak_rss_gib": _rss_gib()}
    t0 = time.time()
    small = ops.make_coalesce_fn(specs, cfg, ml)(params)
    torch.cuda.synchronize(dev)
    out.update(down_s=time.time() - t0, down_peak_rss_gib=_rss_gib())
    t0 = time.time()
    de = ops.make_decoalesce_fn(specs, cfg, ml)(small)
    new = ops.interpolate(params, de, ml.alpha)
    torch.cuda.synchronize(dev)
    out.update(up_s=time.time() - t0, up_peak_rss_gib=_rss_gib(),
               n_params=sum(v.numel() for v in _leaves(params)),
               n_leaves=len(_leaves(new)),
               cuda_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for src in sys.argv[1:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src],
                           capture_output=True, text=True, timeout=900)
        sys.stderr.write(r.stderr[-2000:])
        if r.returncode:
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
