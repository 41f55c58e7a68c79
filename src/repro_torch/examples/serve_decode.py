"""Serve a small model with batched requests + continuous batching.

Exercises the decode path at smoke scale: paged KV cache with block tables
and prefix reuse (default), or the dense-slot engine (``--engine slots``;
required for SSM/hybrid mixers like Jamba).  With ``--policy speculative``
the paged engine self-drafts k tokens per tick from the coalesced level-1
projection of its own weights and verifies them in one batched full-model
step (lossless for greedy decode).  ``--mesh DxM`` shards the paged decode
step (model-sharded K/V page pools) over D*M processes, one per device, each
running the same command with its own ``--process-id``; ``--reload-from``
polls a trainer's checkpoint dir for live weight reloads -- swaps land at
tick boundaries, never dropping in-flight requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --engine slots
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --policy speculative
    for i in 0 1; do PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --mesh 1x2 --num-processes 2 --process-id $i --coordinator 127.0.0.1:PORT & done
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --reload-from CKPT_DIR
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch jamba-1.5-large-398b --engine slots --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.device import default_device
from repro_torch.distributed.multiprocess import is_primary
from repro_torch.examples import Printer
from repro_torch.launch.serve import ManifestWatcher, PagedServer, Request, make_server


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--engine", choices=["paged", "slots"], default="paged")
    ap.add_argument("--policy", choices=["greedy", "speculative"], default="greedy")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--mesh", default="",
                    help="DxM serving mesh, e.g. 1x2 (paged engine only): one process "
                         "per device, --num-processes D*M")
    ap.add_argument("--coordinator", default="127.0.0.1:9876",
                    help="host:port of process 0's process-group store (several "
                         "processes), or file://PATH: process 0 binds a free port "
                         "and writes it there")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--reload-from", default="",
                    help="checkpoint dir to poll for live weight reloads "
                         "(a trainer's --ckpt-dir)")
    ap.add_argument("--poll-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    pr = Printer()

    mesh, own_group = None, False
    if args.mesh:
        from repro_torch.launch.mesh import init_distributed, make_cli_mesh, rank_device

        own_group = not dist.is_initialized()
        if args.num_processes > 1:
            dev = rank_device(dev, args.process_id)
            init_distributed(args.coordinator, args.num_processes, args.process_id,
                             device=dev)
        mesh = make_cli_mesh(args.mesh, num_processes=args.num_processes, device=dev)
    try:
        cfg = get_config(args.arch, smoke=True)
        primary = is_primary()
        say = pr.say if primary else (lambda text="": None)
        say(f"serving {cfg.name} (smoke config), engine={args.engine}, "
            f"policy={args.policy}, continuous batch={args.batch}"
            + (f", mesh={args.mesh}" if args.mesh else ""))
        srv = make_server(cfg, engine=args.engine, batch=args.batch, max_seq=96,
                          page_size=args.page_size, policy=args.policy,
                          draft_k=args.draft_k, device=dev, mesh=mesh)
        watcher = None
        if args.reload_from:
            mgr = CheckpointManager(args.reload_from)
            watcher = ManifestWatcher(mgr, like=srv.params,
                                      shardings=getattr(srv, "_param_shardings", None),
                                      mesh=mesh)
            srv.attach_watcher(watcher, poll_every=args.poll_every)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=rng.integers(4, 16)),
                        max_new=args.max_new) for i in range(args.requests)]
        t0 = time.time()
        done = srv.run(reqs)
        if srv.device.type == "cuda":
            torch.cuda.synchronize(srv.device)
        dt = time.time() - t0
        tok = sum(len(r.out) for r in done)
        say(f"{len(done)}/{args.requests} requests served, {tok} tokens, "
            f"{tok/dt:.1f} tok/s on {srv.device.type.upper()}")
        if isinstance(srv, PagedServer):
            say(f"  pages: peak {srv.pages_in_use_peak}/{srv.alloc.pool.capacity}, "
                f"prefill tokens saved by prefix reuse: {srv.prefill_tokens_saved}")
            if args.policy == "speculative":
                st = srv.stats()
                say(f"  speculative: accept={st['accept_rate']:.2f} over "
                    f"{st['drafted_tokens']} drafted tokens "
                    f"(draft {st['draft_time_s']:.2f}s / verify {st['verify_time_s']:.2f}s)")
        if watcher is not None:
            say(f"  reloads: {srv.reloads} swaps, steps_seen={watcher.steps_seen}, "
                f"skipped={watcher.steps_skipped}, last={watcher.last_reload_stats}")
        for r in done[:4]:
            say(f"  req {r.rid}: {len(r.prompt)} prompt toks -> {r.out[:10]}")
        pr.out.update(served=len(done), tokens=tok, tok_per_s=tok / dt, stats=srv.stats(),
                      outs={r.rid: list(r.out) for r in done},
                      reloads=getattr(srv, "reloads", 0))
        return pr.out
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
