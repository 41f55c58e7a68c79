#!/usr/bin/env python3
"""How far the mesh's bf16 logits lie from one process's, and how far a
planted tensor-parallel fault moves them: the readings behind
``chip_smoke.py``'s ``MESH_BF16_LOGIT_TOL`` (phase 37(a)).

TinyLlama-1.1B at full width, bf16, serves ``chip_smoke.py``'s phase-4
traffic on one process, recording the first decode tick's logits, tokens
and positions (``bf16_phase(first_tick=)``; once more at 2 new tokens, which
must give the same first tick).  Then two processes share the card on a 1x2
mesh (gloo): the serving CLI's ``main`` as phase 37 starts it, and fresh
servers on the same mesh at 2 new tokens, clean and with one fault planted
at a time on both ranks (a patch of this process's functions; nothing on
disk changes):

* ``kv_all`` / ``kv_first`` / ``kv_mid`` / ``kv_last``: each query group
  reads the other local K/V head in every layer, or in one layer only;
* ``emb_unmasked``: the vocabulary-parallel lookup without its mask, so
  every rank adds a row for every token.

Each first tick is held to the one process's by ``chip_smoke._tick_gap``
(max abs difference over max(1, max |logit|), over the rows whose token
and position agree).  Needs one CUDA card:

    python3 scripts/mesh_logit_gaps.py

Prints one line per rank and run: the gap and the rows compared.
"""
from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (phase 4's traffic and the mesh run)

RUNS = ("fresh", "kv_all", "kv_first", "kv_mid", "kv_last", "emb_unmasked")


def _planted_kv(orig, layers, n_layers):
    """``_paged_gqa_attention`` with the local K/V heads reversed in
    ``layers`` (the layer is the call's index within a step)."""
    calls = [0]

    def run(qg, ck, cv, cfg, **kw):
        i = calls[0] % n_layers
        calls[0] += 1
        if i in layers:
            ck, cv = ck.flip(2).contiguous(), cv.flip(2).contiguous()
        return orig(qg, ck, cv, cfg, **kw)

    return run


def _unmasked_embedding(table, tokens, vocab):
    from repro_torch.distributed import tensor_parallel as tp

    v_local = table.shape[0]
    if not tp.is_split(v_local, vocab):
        return torch.nn.functional.embedding(tokens, table)
    t = (tokens - tp.model_rank() * v_local).clamp(0, v_local - 1)
    return tp.all_reduce_sum(torch.nn.functional.embedding(t, table))


def rank_main(rank: int, coordinator: str, out: str) -> int:
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import serve as S
    from repro_torch.layers import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    srv, _, _ = S.main(["--arch", "tinyllama-1.1b", "--no-smoke", "--mesh", "1x2",
                        "--num-processes", "2", "--process-id", str(rank), "--coordinator",
                        coordinator, "--batch", "8", "--max-seq", "2048", "--page-size", "16",
                        "--requests", "0"])
    dev, mesh, full = srv.device, srv.mesh, srv.cfg
    L = full.n_layers
    rec = {"cli": cs._mesh_run(srv, cs._requests(cs.BF16_LENGTHS, 32, full.vocab_size,
                                                 cs.BF16_SHARED), dev)["first_tick"]}
    del srv
    cs._free()
    attend, lookup = A._paged_gqa_attention, tp.vocab_embedding
    layers = {"kv_all": set(range(L)), "kv_first": {0}, "kv_mid": {L // 2}, "kv_last": {L - 1}}
    try:
        for name in RUNS:
            A._paged_gqa_attention = (_planted_kv(attend, layers[name], L) if name in layers
                                      else attend)
            tp.vocab_embedding = _unmasked_embedding if name == "emb_unmasked" else lookup
            s = S.make_server(full, mesh=mesh, batch=8, max_seq=2048, page_size=16, device=dev)
            rec[name] = cs._mesh_run(s, cs._requests(cs.BF16_LENGTHS, 2, full.vocab_size,
                                                     cs.BF16_SHARED), dev)["first_tick"]
            del s
            cs._free()
    finally:
        A._paged_gqa_attention, tp.vocab_embedding = attend, lookup
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_logit_gaps: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.build_phase()
    full = get_config("tinyllama-1.1b")
    want, short = {}, {}
    cs.bf16_phase(dev, full, cs.BF16_LENGTHS, cs.BF16_SHARED, first_tick=want)
    cs.bf16_phase(dev, full, cs.BF16_LENGTHS, cs.BF16_SHARED, max_new=2, first_tick=short,
                  tag="bf16-2")
    print(f"one process, 2 against 32 new tokens: gap {cs._tick_gap(short, want)}", flush=True)
    cs._free()
    out = tempfile.mkdtemp(prefix="mesh_logit_gaps_")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    logs = [os.path.join(out, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 f"127.0.0.1:{port}", out], cwd=ROOT, env=env, stdout=lf,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    code = 0
    for r, p in enumerate(procs):
        if p.returncode:
            print(f"rank {r} exited {p.returncode}:\n{open(logs[r]).read()[-3000:]}")
            code = 1
            continue
        rec = torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
        for name, tick in rec.items():
            gap, rows = cs._tick_gap(tick, want)
            print(f"rank {r} {name}: gap {gap:.6e} over {rows} rows", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return code


if __name__ == "__main__":
    if "--rank" in sys.argv:
        i = sys.argv.index("--rank")
        sys.exit(rank_main(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3]))
    sys.exit(main())
