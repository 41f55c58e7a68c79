#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build   -- compile ``src/repro_torch/csrc/*.cu`` for sm_90a and print
                each kernel's registers, shared memory and spills.
  2. kernels -- each CUDA kernel against its plain PyTorch version on the
                card, TF32 off: f32 within 1e-4, bf16 within 2e-2 of the
                plain version fed the same bf16 inputs.
  3. f32     -- TinyLlama-1.1B at full width, 2 layers, f32: the same 8
                requests through ``make_server`` with the ``cuda`` and the
                ``torch`` kernel backends must give identical token streams.
  4. bf16    -- TinyLlama-1.1B as configured (22 layers, bf16 compute), 16
                requests of 40..1536 prompt tokens, two pairs sharing a
                256-token prefix: every request completes, logits are finite,
                and the kernels' launch counts match the path's structure.
  5. timing  -- each kernel timed with CUDA events at phase 4's shapes,
                beside its bound, its plain version and a library yardstick.

The line before the last is a JSON object with one entry per kernel, the
card's name and power limit precede it, and the last line is the device
record ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: build


def build_phase() -> None:
    from repro_torch.kernels import build

    t0 = time.time()
    path, text = build.build()
    per_kernel = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_fwd_kernel|paged_decode_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                          m.group(1))
            name = (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'},{k.group(3)}>"
                    if k else m.group(1))
            per_kernel[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            per_kernel[name]["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            per_kernel[name]["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            per_kernel[name]["static_smem"] = int(s.group(1)) if s else 0
    check(any("flash_fwd_kernel" in n for n in per_kernel)
          and any("paged_decode_kernel" in n for n in per_kernel),
          f"ptxas reported no kernels:\n{text}")
    log(f"[build] {path.name} in {time.time() - t0:.1f}s; " + "; ".join(
        f"{n} regs={v.get('regs')} static_smem={v.get('static_smem')} "
        f"spill(st/ld)={v.get('spill')}" for n, v in per_kernel.items()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _randn(shape, dtype, dev, gen):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def paged_inputs(dev, dtype, lengths, gen, *, KH=4, G=8, D=64, P=16, M=128):
    """q, pools with one spare NaN page, the clean tables (padding -> page 0)
    and the kernel's tables (padding -> the NaN page), lengths."""
    B = len(lengths)
    N = B * M + 1
    q = _randn((B, KH, G, D), dtype, dev, gen)
    k_pages = _randn((N + 1, P, KH, D), dtype, dev, gen)
    v_pages = _randn((N + 1, P, KH, D), dtype, dev, gen)
    k_pages[N] = float("nan")  # never referenced by a valid position
    v_pages[N] = float("nan")
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    tables = torch.zeros((B, M), dtype=torch.int64)
    for b, n in enumerate(lengths):
        used = -(-n // P)
        tables[b, :used] = perm[b * M:b * M + used]
    poisoned = tables.clone()
    for b, n in enumerate(lengths):
        poisoned[b, -(-n // P):] = N
    ln = torch.tensor(lengths, dtype=torch.int64)
    return q, k_pages, v_pages, tables.to(dev), poisoned.to(dev), ln.to(dev)


def kernel_phase(dev) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(S, S, True, dt) for S in (640, 1031, 2048)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(640, 1031, False, torch.float32), (640, 1031, False, torch.bfloat16)]
    for S, T, causal, dt in cases:
        q = _randn((1, S, 32, 64), dt, dev, gen)
        k = _randn((1, T, 4, 64), dt, dev, gen)
        v = _randn((1, T, 4, 64), dt, dev, gen)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
        want, want_lse = fa.flash_attention_torch(q, k, v, causal=causal)
        torch.cuda.synchronize(dev)
        err = (out.float() - want.float()).abs().max().item()
        lerr = (lse - want_lse).abs().max().item()
        log(f"[kernels] flash S={S} T={T} causal={causal} {str(dt)[6:]}: "
            f"max|out err|={err:.3e} max|lse err|={lerr:.3e}")
        check(err <= TOL[dt] and lerr <= 1e-4,
              f"flash kernel disagrees with its plain version: {err} / {lerr}")
    lengths = [0, 1, 15, 16, 17, 777, 2048, 100]
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, bt_poisoned, ln = paged_inputs(dev, dt, lengths, gen)
        out = pa.paged_attention_decode_cuda(q, kp, vp, bt_poisoned, ln)
        want = pa.paged_attention_decode_torch(q, kp, vp, bt, ln)
        torch.cuda.synchronize(dev)
        err = (out.float() - want.float()).abs().max().item()
        log(f"[kernels] paged lengths={lengths} {str(dt)[6:]}: max|err|={err:.3e} "
            f"(padding entries point at a NaN page)")
        check(torch.isfinite(out).all().item() and err <= TOL[dt],
              f"paged kernel disagrees with its plain version: {err}")
        check(out[0].abs().max().item() == 0.0, "a length-0 row is not exact zeros")


# ---------------------------------------------------------------------------
# phases 3-4: the serving path


def _requests(lengths, max_new, vocab, shared=()):
    """Requests with random prompts; ``shared`` lists (first, second) index
    pairs whose prompts share a 256-token prefix."""
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, size=n) for n in lengths]
    for a, b in shared:
        prompts[b][:256] = prompts[a][:256]
    return [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]


def _reset_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    fa.flash_attention_cuda.launches = 0
    pa.paged_attention_decode_cuda.launches = 0


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    return fa.flash_attention_cuda.launches, pa.paged_attention_decode_cuda.launches


def f32_phase(dev, cfg, lengths, backends=("cuda", "torch")) -> None:
    from repro_torch.launch.serve import make_server

    streams = {}
    for backend in backends:
        srv = make_server(cfg.replace(kernel_backend=backend), batch=4, max_seq=1024,
                          device=dev)
        _reset_counters()
        done = srv.run(_requests(lengths, 8, cfg.vocab_size))
        counts = _counters()
        streams[backend] = {r.rid: r.out for r in done}
        log(f"[f32] backend={backend}: {len(done)} requests, launches "
            f"(flash, paged)={counts}, stats={srv.stats()}")
        check(len(done) == len(lengths) and not srv.rejected, "f32 run lost requests")
        if backend == "cuda":
            check(min(counts) > 0, f"f32 run did not reach both kernels: {counts}")
        del srv
    check(streams[backends[0]] == streams[backends[1]],
          f"token streams differ between backends: {streams}")
    log(f"[f32] streams identical across {backends}: {streams[backends[0]]}")


def bf16_phase(dev, cfg, lengths, shared, max_new=32, max_seq=2048):
    """Serve the traffic; returns the recorded decode inputs and counts."""
    from repro_torch.launch.serve import make_server

    srv = make_server(cfg, batch=8, max_seq=max_seq, page_size=16, device=dev)
    reqs = _requests(lengths, max_new, cfg.vocab_size, shared)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    decode_inputs = []
    prefill, paged_step = srv.prefill, srv.paged_step

    def prefill_checked(params, tokens):
        nonlocal finite
        logits, caches = prefill(params, tokens)
        finite = finite & torch.isfinite(logits).all()
        return logits, caches

    def paged_checked(params, pages, tokens, positions, tables):
        nonlocal finite
        logits, pages = paged_step(params, pages, tokens, positions, tables)
        finite = finite & torch.isfinite(logits).all()
        if tokens.shape[1] == 1:
            decode_inputs.append((tables.cpu(), (positions[:, 0] + 1).cpu()))
        return logits, pages

    srv.prefill, srv.paged_step = prefill_checked, paged_checked
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    _reset_counters()
    t0 = time.time()
    done = srv.run(reqs)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = _counters()
    tokens = sum(len(r.out) for r in done)
    warm = {b for _, b in shared}
    cold_long = sum(1 for i, n in enumerate(lengths)
                    if i not in warm and n > max(128, cfg.attn_block_k))
    n_layers = cfg.n_layers
    log(f"[bf16] {len(done)} requests, {tokens} tokens in {wall:.3f}s wall "
        f"({tokens / wall:.1f} tok/s), decode ticks={len(decode_inputs)}, "
        f"launches (flash, paged)={counts}, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, stats={srv.stats()}")
    check(len(done) == len(lengths) and not srv.rejected, "bf16 run lost requests")
    check(all(len(r.out) == max_new for r in done), "a request stopped early")
    check(bool(finite.item()), "non-finite logits in the bf16 run")
    check(srv.prefill_tokens_saved == 256 * len(shared),
          f"prefix reuse saved {srv.prefill_tokens_saved} tokens, "
          f"expected {256 * len(shared)}")
    check(counts[0] == n_layers * cold_long,
          f"flash launches {counts[0]} != {n_layers} x {cold_long} cold long prompts")
    check(counts[1] == n_layers * len(decode_inputs),
          f"paged launches {counts[1]} != {n_layers} x {len(decode_inputs)} ticks")
    return decode_inputs, counts


# ---------------------------------------------------------------------------
# phase 5: kernel times


def time_ms(fn, dev, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, with a 128 MB
    write between launches so each one finds its inputs out of L2 (50 MB),
    as it does on the serving path where other layers run in between."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def timing_phase(dev, decode_inputs, counts, S=1536):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, KH, D, dt = 1, 32, 4, 64, torch.bfloat16
    q = _randn((B, S, H, D), dt, dev, gen)
    k = _randn((B, S, KH, D), dt, dev, gen)
    v = _randn((B, S, KH, D), dt, dev, gen)
    out, _ = fa.flash_attention_cuda(q, k, v, causal=True)
    want, _ = fa.flash_attention_torch(q, k, v, causal=True)
    flash_err = (out.float() - want.float()).abs().max().item()
    qh, kh, vh = (q.transpose(1, 2).contiguous(),
                  k.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous(),
                  v.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous())
    flash = {
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), dev),
        "plain_ms": time_ms(lambda: fa.flash_attention_torch(q, k, v, causal=True), dev),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), dev),
    }
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KH * D) + 4 * B * H * S
    flash_bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3

    # the decode tick halfway through phase 4, with fresh random K/V
    tables, lengths = decode_inputs[len(decode_inputs) // 2]
    Bd, M = tables.shape
    G, P, N = H // KH, 16, 8 * 128 + 1
    qd = _randn((Bd, KH, G, D), dt, dev, gen)
    kp = _randn((N, P, KH, D), dt, dev, gen)
    vp = _randn((N, P, KH, D), dt, dev, gen)
    bt, ln = tables.to(dev), lengths.to(dev)
    got = pa.paged_attention_decode_cuda(qd, kp, vp, bt, ln)
    ref = pa.paged_attention_decode_torch(qd, kp, vp, bt, ln)
    paged_err = (got.float() - ref.float()).abs().max().item()
    paged = {
        "ms": time_ms(lambda: pa.paged_attention_decode_cuda(qd, kp, vp, bt, ln), dev),
        "plain_ms": time_ms(lambda: pa.paged_attention_decode_torch(qd, kp, vp, bt, ln), dev),
        "library_ms": None,
    }
    n_tok = int(lengths.clamp_min(0).sum())
    pbytes = (2 * n_tok * KH * D * 2 + 2 * 2 * Bd * KH * G * D
              + 4 * int((-(-lengths.clamp_min(0) // P)).sum()) + 4 * Bd)
    pflops = 4.0 * n_tok * KH * G * D
    paged_bound = max(pflops / PEAK_BF16_FLOPS, pbytes / PEAK_BYTES) * 1e3
    log(f"[timing] flash B=1 S=T={S} H=32 KH=4 D=64 bf16 causal: {flash}, "
        f"bound {flash_bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"[timing] paged B={Bd} KH=4 G=8 D=64 P=16 M={M} lengths={lengths.tolist()} "
        f"bf16: {paged}, bound {paged_bound:.4f} ms ({pbytes / 1e6:.2f} MB)")
    check(flash_err <= TOL[dt] and paged_err <= TOL[dt],
          f"kernels disagree at the timing shapes: {flash_err}, {paged_err}")
    src = "src/repro_torch/csrc/"
    return [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "tpu_source": "src/repro/kernels/flash_attention.py:88 _fwd_call (_flash_kernel :35)",
         "launches": counts[0], "max_abs_err": flash_err, "max_err": flash_err,
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash_bound,
         "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
         else "bytes", "library_ms": flash["library_ms"]},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": src + "paged_attention_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:113",
         "tpu_source": "src/repro/kernels/paged_attention.py:113 paged_attention_decode "
                       "(_paged_decode_kernel :38)",
         "launches": counts[1], "max_abs_err": paged_err, "max_err": paged_err,
         "ms": paged["ms"], "plain_ms": paged["plain_ms"], "bound_ms": paged_bound,
         "bound_by": "bytes" if pbytes / PEAK_BYTES > pflops / PEAK_BF16_FLOPS
         else "operations", "library_ms": paged["library_ms"]},
    ]


# the phase-4 traffic: prompt lengths, and the (first, second) pairs whose
# prompts share a 256-token prefix (the second is served by the extend step)
BF16_LENGTHS = [40, 1536, 777, 900, 513, 1031, 130, 600,
                400, 1300, 1100, 257, 64, 1234, 90, 700]
BF16_SHARED = ((2, 3), (8, 9))
F32_LENGTHS = [530, 600, 777, 1000, 100, 300, 513, 64]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.config import BlockSpec, uniform_stages
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.time()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_phase()
    kernel_phase(dev)
    log(f"[time] phases 1-2 done at {time.time() - t0:.1f}s")
    full = get_config("tinyllama-1.1b")
    f32_phase(dev, full.replace(stages=uniform_stages(2, BlockSpec("attn", "dense")),
                                compute_dtype=torch.float32), F32_LENGTHS)
    log(f"[time] phase 3 done at {time.time() - t0:.1f}s")
    decode_inputs, counts = bf16_phase(dev, full, BF16_LENGTHS, BF16_SHARED)
    log(f"[time] phase 4 done at {time.time() - t0:.1f}s")
    kernels = timing_phase(dev, decode_inputs, counts)
    log(f"[time] phase 5 done at {time.time() - t0:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
