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
  6. train   -- GPT-Base at full width, 2 layers, f32, seq 1024, batch 2:
                one train step on the ``cuda`` and the ``torch`` backends
                gives the same loss, parameter gradients and updated
                parameters; a width-only de-coalesce then coalesce of the
                real tree gives it back bit for bit.
  7. vcycle  -- the slice: ``VCycleRunner`` (what ``run_vcycle`` wraps) on
                GPT-Base as configured (12 layers, bf16 compute, f32 master
                weights, seq 1024, batch 8), 2 levels, 2 + 20 + 40 steps on
                ``MarkovLM`` batches, then ``run_scratch`` for 40 steps on the
                same batches: finite losses that fall, the segment schedule,
                the FLOPs account, and every kernel's launch count derived
                from the specs, the plan and the schedule.
  5. timing  -- each kernel timed with CUDA events at its main path's
                shapes, beside its bound, its plain version and a library
                yardstick (run last: it reads the counts of phases 4 and 7).

The card's name and power limit are printed on the line before the JSON
object with one entry per kernel, and the last line is the device record
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero before printing any result.
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
# the CUDA kernel bodies of src/repro_torch/csrc, as ptxas names them
KERNEL_BODIES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "paged_decode_kernel", "coalesce_pair_kernel", "interp_axpy_kernel")


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
            k = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
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
    for body in KERNEL_BODIES:
        check(any(n.startswith(body + "<") for n in per_kernel),
              f"ptxas reported no {body}:\n{text}")
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
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    dts = (torch.float32, torch.bfloat16)
    # serving (TinyLlama GQA 32/4, B = 1) and the V-cycle's two levels
    # (GPT-Base MHA 12/12 and 6/6, B = 8, S = T = 1024)
    cases = [(1, S, S, True, dt, 32, 4) for S in (640, 1031, 2048) for dt in dts]
    cases += [(1, 640, 1031, False, dt, 32, 4) for dt in dts]
    cases += [(8, 1024, 1024, True, dt, H, H) for H in (12, 6) for dt in dts]
    for B, S, T, causal, dt, H, KH in cases:
        err, lerr = _flash_fwd_err(dev, gen, B, S, T, H, KH, causal, dt)
        log(f"[kernels] flash B={B} S={S} T={T} H={H} KH={KH} causal={causal} "
            f"{str(dt)[6:]}: max|out err|={err:.3e} max|lse err|={lerr:.3e}")
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
    flash_bwd_checks(dev, gen)
    elementwise_checks(dev, gen)


def _flash_fwd_err(dev, gen, B, S, T, H, KH, causal, dt, qkv=None):
    """(max |out err|, max |lse err|) of the flash forward kernel against
    its plain version on random (or the given) q, k, v; fails beyond
    TOL[dt] and 1e-4 (lse is f32 in both)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv or (_randn((B, S, H, 64), dt, dev, gen), _randn((B, T, KH, 64), dt, dev, gen),
                      _randn((B, T, KH, 64), dt, dev, gen))
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = fa.flash_attention_torch(q, k, v, causal=causal)
    torch.cuda.synchronize(dev)
    err = (out.float() - want.float()).abs().max().item()
    lerr = (lse - want_lse).abs().max().item()
    check(err <= TOL[dt] and lerr <= 1e-4,
          f"flash kernel B={B} S={S} T={T} H={H} KH={KH} causal={causal} {dt} disagrees "
          f"with its plain version: {err} / {lerr}")
    return err, lerr


def _scaled_err(got, want) -> float:
    """Max |got - want| over max(1, max |want|): gradients reach magnitudes
    of several units, where one bf16 rounding alone is above 2e-2."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def flash_bwd_checks(dev, gen) -> None:
    """dq, dk, dv of the two backward kernels against the plain backward:
    causal and not, MHA at both V-cycle levels' head counts (12, 6) and GQA,
    D 64 and 128, ragged S and T."""
    from repro_torch.kernels import flash_attention as fa

    for dt in (torch.float32, torch.bfloat16):
        for H, KH in ((12, 12), (6, 6), (32, 4)):
            for D in (64, 128):
                for causal, S, T in ((True, 1000, 1000), (False, 1000, 777)):
                    q = _randn((1, S, H, D), dt, dev, gen)
                    k = _randn((1, T, KH, D), dt, dev, gen)
                    v = _randn((1, T, KH, D), dt, dev, gen)
                    do = _randn((1, S, H, D), dt, dev, gen)
                    out, lse = fa.flash_attention_torch(q, k, v, causal=causal)
                    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
                    want = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
                    torch.cuda.synchronize(dev)
                    errs = [_scaled_err(g, w) for g, w in zip(got, want)]
                    log(f"[kernels] flash bwd H={H} KH={KH} D={D} S={S} T={T} "
                        f"causal={causal} {str(dt)[6:]}: scaled max err (dq, dk, dv)="
                        f"({errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e})")
                    check(all(g.dtype == w.dtype and g.shape == w.shape
                              for g, w in zip(got, want)), "flash bwd output types")
                    check(max(errs) <= TOL[dt],
                          f"flash backward kernels disagree with the plain version: {errs}")


def _ulps(got, want) -> int:
    """Largest distance in units in the last place (same-sign values)."""
    it = torch.int32 if got.dtype == torch.float32 else torch.int16
    return int((got.view(it).long() - want.view(it).long()).abs().max().item())


def elementwise_checks(dev, gen) -> None:
    """coalesce_pair exactly equal to its plain version (the same add and
    power-of-two scale); interp_axpy within 1 ulp (the kernel rounds the two
    products and the sum separately, as the plain version does, so 0 is
    expected)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import interp_axpy as ia

    shapes = [(768, 36864), (12, 589824), (768, 50304), (10, 7), (2, 1)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            for axis in (0, 1):
                w = _randn(shape if axis == 0 else shape[::-1], dt, dev, gen)
                for w0 in (0.5, 1.0):
                    got = cp.coalesce_pair_cuda(w, axis=axis, w0=w0)
                    check(torch.equal(got, cp.coalesce_pair_torch(w, axis=axis, w0=w0)),
                          f"coalesce_pair {tuple(w.shape)} axis={axis} w0={w0} {dt} "
                          f"differs from its plain version")
            log(f"[kernels] coalesce_pair {shape} and its transpose, axis 0/1, "
                f"w0 0.5/1.0, {str(dt)[6:]}: exactly equal")
        for n in (1, 1023, 1025, 50304 * 768):
            a, b = _randn((n,), dt, dev, gen), _randn((n,), dt, dev, gen)
            u = _ulps(ia.interp_axpy_cuda(a, b, 0.25), ia.interp_axpy_torch(a, b, 0.25))
            log(f"[kernels] interp_axpy n={n} {str(dt)[6:]}: max {u} ulp")
            check(u <= 1, f"interp_axpy n={n} {dt}: {u} ulp from its plain version")


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


def _wrappers():
    """Kernel name -> its CUDA wrapper (each counts its own launches)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import interp_axpy as ia
    from repro_torch.kernels import paged_attention as pa

    return {"flash_attention_fwd": fa.flash_attention_cuda,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_cuda,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_cuda,
            "coalesce_pair": cp.coalesce_pair_cuda,
            "interp_axpy": ia.interp_axpy_cuda,
            "paged_attention_decode": pa.paged_attention_decode_cuda}


def _reset_counters():
    for w in _wrappers().values():
        w.launches = 0


def _launches():
    return {k: w.launches for k, w in _wrappers().items()}


def _counters():
    """(flash forward, paged decode) launches: the serving phases' pair."""
    c = _launches()
    return c["flash_attention_fwd"], c["paged_attention_decode"]


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
# phases 6-7: the training path


def _gpt_base(n_layers=None, **kw):
    from repro_torch.config import BlockSpec, uniform_stages
    from repro_torch.configs import get_config

    cfg = get_config("gpt-base")
    if n_layers is not None:
        cfg = cfg.replace(stages=uniform_stages(n_layers, BlockSpec("attn", "dense")))
    return cfg.replace(**kw)


def train_f32_phase(dev, cfg, tc) -> None:
    """One train step (GPT-Base at full width, 2 layers, f32, in ``main``)
    on both backends from the same weights and batch.  Tolerances: loss within
    1e-4; each gradient leaf within 1e-5 + 1e-3 of its largest value
    (f32, other summation orders in attention); updated parameters within
    1e-5, with Adam's eps at 1e-4 (at 1e-8 the first step moves a weight
    whose gradient is zero up to rounding by up to lr either way).  Then a
    width-only de-coalesce and coalesce of the real tree, through the
    kernels, must give it back bit for bit."""
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core import operators as ops
    from repro_torch.data import MarkovLM, lm_batch
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.param import flatten, unflatten

    batch = lm_batch(MarkovLM(cfg.vocab_size), SEED, 0, tc.batch_size, tc.seq_len,
                     device=dev)
    init = flatten(build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED)))
    res = {}
    for backend in ("cuda", "torch"):
        model = build_model(cfg.replace(kernel_backend=backend))
        _reset_counters()
        leaves = [v.clone().requires_grad_() for v in init.values()]
        loss, _ = model.loss(unflatten(dict(zip(init, leaves))), batch)
        grads = torch.autograd.grad(loss, leaves)
        tree = unflatten({k: v.clone() for k, v in init.items()})
        tree, _, _ = make_train_step(model, tc)(tree, adamw_init(tree, tc), batch)
        torch.cuda.synchronize(dev)
        res[backend] = (loss.item(), grads, flatten(tree), _launches())
    (l_c, g_c, p_c, n_c), (l_t, g_t, p_t, n_t) = res["cuda"], res["torch"]
    passes = 2  # loss + gradients, then the train step
    want = {"flash_attention_fwd": passes * cfg.n_layers * 2,  # remat: fwd + recompute
            "flash_attention_bwd_dq": passes * cfg.n_layers,
            "flash_attention_bwd_dkv": passes * cfg.n_layers}
    g_err = max(((a - b).abs().max() / (1e-5 + 1e-3 * b.abs().max())).item()
                for a, b in zip(g_c, g_t))
    p_err = max((p_c[k] - p_t[k]).abs().max().item() for k in p_t)
    log(f"[train-f32] loss cuda {l_c:.7f} torch {l_t:.7f}; gradient error / its "
        f"tolerance {g_err:.3f} over {len(g_t)} leaves; max |param diff| after the "
        f"step {p_err:.3e}; launches cuda {n_c}, torch {n_t}")
    check(abs(l_c - l_t) <= 1e-4, f"losses differ: {l_c} vs {l_t}")
    check(g_err <= 1.0, f"gradients differ between backends ({g_err} x tolerance)")
    check(p_err <= 1e-5, f"updated parameters differ: {p_err}")
    check(all(n_c[k] == v for k, v in want.items()),
          f"cuda backend launches {n_c}, expected {want}")
    check(not any(n_t.values()), f"torch backend launched kernels: {n_t}")
    # C(D(w)) == w for a width-only transition, on the real tree
    ml = MultiLevelConfig()
    specs = build_model(cfg).specs()
    params = unflatten(dict(p_c))
    small = ops.make_coalesce_fn(specs, cfg, ml, width=True, depth=False)(params)
    back = ops.make_coalesce_fn(specs, cfg, ml, width=True, depth=False)(
        ops.make_decoalesce_fn(specs, cfg, ml, width=True, depth=False)(small))
    fs, fb = flatten(small), flatten(back)
    check(all(torch.equal(fb[k], v) for k, v in fs.items()),
          "width de-coalesce then coalesce did not give the tree back bit for bit")
    log(f"[train-f32] width-only C(D(w)) == w bit for bit over {len(fs)} leaves")


def width_pairs(specs, plan) -> int:
    """(leaf, width axis) pairs a "stack" coalescing runs through
    coalesce_pair: every dim whose logical axis the plan halves, with role
    "in" or "out" after the plan's role overrides."""
    from repro_torch.param import flatten

    maps = plan.build_maps()
    n = 0
    for spec in flatten(specs).values():
        for ax, role in zip(spec.axes, spec.roles):
            role = plan.role_overrides.get(ax, role) if ax in maps.width else role
            if ax in maps.width and role in ("in", "out"):
                check(maps.width[ax].variant == "stack", f"axis {ax} is not a pair merge")
                n += 1
    return n


def vcycle_phase(dev, cfg, ml, tc):
    """The slice: the paper's 2-level V-cycle, then training from scratch
    on the same batches.  Returns the launches of each of the two runs."""
    from repro_torch.core import flops as flops_lib
    from repro_torch.core import vcycle as vc
    from repro_torch.core.plans import build_plan
    from repro_torch.data import MarkovLM, lm_batch
    from repro_torch.models.api import build_model
    from repro_torch.param import flatten

    chain = MarkovLM(cfg.vocab_size)
    batch_fn = lambda g: lm_batch(chain, SEED, g, tc.batch_size, tc.seq_len, device=dev)
    runner = vc.VCycleRunner(cfg, ml, tc, batch_fn, seed=SEED, device=dev)
    plan = vc.segments(cfg, ml, tc)
    small = build_plan(cfg, ml).small_cfg
    cfgs = [cfg, small]
    check(runner.cfgs == cfgs and small.n_layers == (cfg.n_layers + 1) // 2
          and 2 * small.d_model == cfg.d_model and 2 * small.n_heads == cfg.n_heads
          and 2 * small.d_ff == cfg.d_ff
          and small.resolved_head_dim == cfg.resolved_head_dim,
          f"level-1 config {small}")
    step_dt = {0: [], 1: []}

    def on_step(state, params, opt_state, stopping, dt):
        step_dt[state.level].append(dt)

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    t0 = time.time()
    out = runner.run(on_step=on_step)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev)

    # what the path's structure implies
    specs0 = build_model(cfg).specs()
    steps = sum(s.steps for s in plan)
    want = {
        "flash_attention_fwd": sum(s.steps * cfgs[s.level].n_layers * 2 for s in plan),
        "flash_attention_bwd_dq": sum(s.steps * cfgs[s.level].n_layers for s in plan),
        "flash_attention_bwd_dkv": sum(s.steps * cfgs[s.level].n_layers for s in plan),
        "coalesce_pair": width_pairs(specs0, build_plan(cfg, ml)),
        "interp_axpy": len(flatten(specs0)),
        "paged_attention_decode": 0,
    }
    hist = out.history
    fps = [flops_lib.train_step_flops(c, build_model(c).specs(), tc.batch_size, tc.seq_len)
           for c in cfgs]
    cum, flops_want = 0.0, []
    for s in plan:
        for _ in range(s.steps):
            cum += fps[s.level]
            flops_want.append(cum)
    tok = tc.batch_size * tc.seq_len
    for lv in (0, 1):
        dts = step_dt[lv][1:]  # a level's first step pays its first launches
        log(f"[vcycle] level {lv} ({cfgs[lv].n_layers}L d_model {cfgs[lv].d_model}): "
            f"{len(step_dt[lv])} steps, mean step {np.mean(dts) * 1e3:.1f} ms after the "
            f"first ({step_dt[lv][0] * 1e3:.1f} ms), {tok / np.mean(dts):.0f} tokens/s")
    log(f"[vcycle] segments {[(s.phase, s.level, s.steps) for s in plan]}; {steps} steps "
        f"in {wall:.2f}s wall; losses first {hist.loss[0]:.4f} last {hist.loss[-1]:.4f}; "
        f"peak max_memory_allocated {peak / 2**30:.2f} GiB; launches {counts}; "
        f"expected {want}")
    check(all(np.isfinite(hist.loss)), "a non-finite loss in the V-cycle")
    check(hist.loss[-1] < hist.loss[0], "the final segment's last loss is not below the "
                                         "first logged loss")
    check(hist.level == [s.level for s in plan for _ in range(s.steps)],
          "History.level does not follow segments()")
    check(hist.flops == flops_want and out.total_flops == flops_want[-1],
          "cumulative FLOPs differ from the sum of train_step_flops per level")
    check(runner.n_compiles == 2, f"{runner.n_compiles} step functions built")
    check(counts == want, f"V-cycle launches {counts} != structure {want}")

    # training from scratch on the same batches
    _reset_counters()
    t0 = time.time()
    _, base = vc.run_scratch(cfg, tc, batch_fn, seed=SEED, steps=tc.steps, device=dev)
    torch.cuda.synchronize(dev)
    scratch_wall = time.time() - t0
    scratch = _launches()
    want_s = dict(want, coalesce_pair=0, interp_axpy=0,
                  flash_attention_fwd=tc.steps * cfg.n_layers * 2,
                  flash_attention_bwd_dq=tc.steps * cfg.n_layers,
                  flash_attention_bwd_dkv=tc.steps * cfg.n_layers)
    saving = vc.saving_vs_baseline(base, hist)
    log(f"[vcycle] run_scratch {tc.steps} steps in {scratch_wall:.2f}s wall; losses first "
        f"{base.loss[0]:.4f} last {base.loss[-1]:.4f}; launches {scratch}")
    log(f"[vcycle] saving_vs_baseline (printed, not checked: {tc.steps} steps are too few "
        f"to show the paper's saving): {saving}")
    check(all(np.isfinite(base.loss)) and base.loss[-1] < base.loss[0],
          "run_scratch losses are not finite and falling")
    check(scratch == want_s, f"scratch launches {scratch} != structure {want_s}")
    return counts, scratch


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


def timing_phase(dev, decode_inputs, S=1536):
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
         "max_abs_err": flash_err, "max_err": flash_err,
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash_bound,
         "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
         else "bytes", "library_ms": flash["library_ms"]},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": src + "paged_attention_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:113",
         "tpu_source": "src/repro/kernels/paged_attention.py:113 paged_attention_decode "
                       "(_paged_decode_kernel :38)",
         "max_abs_err": paged_err, "max_err": paged_err,
         "ms": paged["ms"], "plain_ms": paged["plain_ms"], "bound_ms": paged_bound,
         "bound_by": "bytes" if pbytes / PEAK_BYTES > pflops / PEAK_BF16_FLOPS
         else "operations", "library_ms": paged["library_ms"]},
    ]


def _bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def train_timing_phase(dev):
    """The training kernels at phase 7's shapes: the flash forward and
    backward of one layer (B = 8, S = T = 1024, D = 64, causal, bf16) held to
    their plain versions at level 1 (H = KH = 6) and level 0 (H = KH = 12),
    the backward timed at level 0; coalesce_pair / interp_axpy on the
    embedding, the largest leaf (f32)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import interp_axpy as ia

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, S, D, dt = 8, 1024, 64, torch.bfloat16
    for H in (6, 12):  # level 1, then level 0, whose inputs are timed below
        q, k, v, do = (_randn((B, S, H, D), dt, dev, gen) for _ in range(4))
        fwd_err, lse_err = _flash_fwd_err(dev, gen, B, S, S, H, H, True, dt, qkv=(q, k, v))
        out, lse = fa.flash_attention_cuda(q, k, v, causal=True)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True)
        wq, wk, wv = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, causal=True)
        dq_err = (dq.float() - wq.float()).abs().max().item()
        dkv_err = max((dk.float() - wk.float()).abs().max().item(),
                      (dv.float() - wv.float()).abs().max().item())
        log(f"[timing] flash B={B} S=T={S} H=KH={H} D={D} bf16 causal: forward max|out err|="
            f"{fwd_err:.3e} max|lse err|={lse_err:.3e}; backward max|dq err|={dq_err:.3e} "
            f"max|dk, dv err|={dkv_err:.3e}")
        check(max(_scaled_err(dq, wq), _scaled_err(dk, wk), _scaled_err(dv, wv)) <= TOL[dt],
              f"flash backward disagrees at the H={H} training shape: {dq_err}, {dkv_err}")
    # yardsticks: PyTorch's flash-attention backward op, one call computing
    # dq, dk, dv from the same saved forward; and SDPA fwd+bwd minus fwd
    # through autograd, which includes the host's launch gaps
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    o, lse_l, cq, ck, mq, mk, seed, offset, _ = \
        torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True)
    lib_bwd = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        doh, qh, kh, vh, o, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset), dev)
    qg, kg, vg = (t.requires_grad_() for t in (qh.clone(), kh.clone(), vh.clone()))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), doh)

    sdpa_fb = time_ms(sdpa_fwd_bwd, dev)
    sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), dev)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_torch(q, k, v, out, lse, do,
                                                            causal=True), dev)
    pairs = B * H * S * (S + 1) / 2
    rows, kv = B * S * H * D, B * S * H * D  # MHA: K/V as large as Q
    dq_bound = _bound(6 * D * pairs, 2 * (4 * rows + 2 * kv) + 4 * 2 * B * H * S,
                      PEAK_BF16_FLOPS)
    dkv_bound = _bound(8 * D * pairs, 2 * (2 * rows + 4 * kv) + 4 * 2 * B * H * S,
                       PEAK_BF16_FLOPS)
    bwd = {
        "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do,
                                                                causal=True), dev),
        "dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                                  causal=True), dev),
        "plain_ms (dq, dk, dv together)": plain_bwd,
        "library_ms (flash backward op: dq, dk, dv together)": lib_bwd,
        "SDPA fwd+bwd minus fwd, autograd": sdpa_fb - sdpa_f,
    }
    log(f"[timing] flash bwd B={B} S=T={S} H={H} D={D} bf16 causal: {bwd}; bounds dq "
        f"{dq_bound}, dkv {dkv_bound} ({6 * D * pairs / 1e9:.1f} + {8 * D * pairs / 1e9:.1f}"
        f" GFLOP done, {10 * D * pairs / 1e9:.1f} GFLOP needed by one fused backward)")

    w = _randn((768, 50304), torch.float32, dev, gen)  # embed/tok folded on its embed axis
    half = w.shape[0] // 2
    cp_err = (cp.coalesce_pair_cuda(w, axis=0) - cp.coalesce_pair_torch(w, axis=0)
              ).abs().max().item()
    pair = {"ms": time_ms(lambda: cp.coalesce_pair_cuda(w, axis=0, w0=0.5), dev),
            "plain_ms": time_ms(lambda: cp.coalesce_pair_torch(w, axis=0, w0=0.5), dev),
            "library_ms": time_ms(lambda: torch.mean(w.view(2, half, -1), 0), dev)}
    pair_bound = _bound(2.0 * half * w.shape[1], 4 * 1.5 * w.numel(), PEAK_F32_FLOPS)
    a, b = (_randn((50304, 768), torch.float32, dev, gen) for _ in range(2))
    ia_err = (ia.interp_axpy_cuda(a, b, 0.25) - ia.interp_axpy_torch(a, b, 0.25)
              ).abs().max().item()
    axpy = {"ms": time_ms(lambda: ia.interp_axpy_cuda(a, b, 0.25), dev),
            "plain_ms": time_ms(lambda: ia.interp_axpy_torch(a, b, 0.25), dev),
            "library_ms": time_ms(lambda: torch.lerp(a, b, 0.25), dev)}
    axpy_bound = _bound(3.0 * a.numel(), 4 * 3 * a.numel(), PEAK_F32_FLOPS)
    log(f"[timing] coalesce_pair [768, 50304] f32 axis 0 w0 0.5: {pair}, bound {pair_bound}")
    log(f"[timing] interp_axpy [50304, 768] f32 alpha 0.25: {axpy}, bound {axpy_bound}")
    check(cp_err == 0.0 and ia_err == 0.0,
          f"elementwise kernels differ at the timing shapes: {cp_err}, {ia_err}")
    src = "src/repro_torch/csrc/"
    return [
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:249",
         "tpu_source": "src/repro/kernels/flash_attention.py:249 _bwd_call (_bwd_dq_kernel :149)",
         "max_abs_err": dq_err, "ms": bwd["dq_ms"], "plain_ms": plain_bwd,
         "bound_ms": dq_bound[0], "bound_by": dq_bound[1], "library_ms": lib_bwd},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:266",
         "tpu_source": "src/repro/kernels/flash_attention.py:266 _bwd_call (_bwd_dkv_kernel :188)",
         "max_abs_err": dkv_err, "ms": bwd["dkv_ms"], "plain_ms": plain_bwd,
         "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1], "library_ms": lib_bwd},
        {"name": "coalesce_pair", "route": "cuda", "source": src + "coalesce_pair.cu",
         "replaces": "src/repro/kernels/coalesce_pair.py:71",
         "tpu_source": "src/repro/kernels/coalesce_pair.py:71 coalesce_pair (_pair_kernel :24)",
         "max_abs_err": cp_err, "ms": pair["ms"], "plain_ms": pair["plain_ms"],
         "bound_ms": pair_bound[0], "bound_by": pair_bound[1],
         "library_ms": pair["library_ms"]},
        {"name": "interp_axpy", "route": "cuda", "source": src + "interp_axpy.cu",
         "replaces": "src/repro/kernels/interp_axpy.py:36",
         "tpu_source": "src/repro/kernels/interp_axpy.py:36 interp_axpy (_axpy_kernel :17)",
         "max_abs_err": ia_err, "ms": axpy["ms"], "plain_ms": axpy["plain_ms"],
         "bound_ms": axpy_bound[0], "bound_by": axpy_bound[1],
         "library_ms": axpy["library_ms"]},
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
    from repro_torch.config import BlockSpec, MultiLevelConfig, TrainConfig, uniform_stages
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
    decode_inputs, (serve_flash, serve_paged) = bf16_phase(dev, full, BF16_LENGTHS,
                                                           BF16_SHARED)
    log(f"[time] phase 4 done at {time.time() - t0:.1f}s")
    train_f32_phase(dev, _gpt_base(2, compute_dtype=torch.float32), TrainConfig(
        steps=4, warmup_steps=1, eps=1e-4, batch_size=2, seq_len=1024))
    log(f"[time] phase 6 done at {time.time() - t0:.1f}s")
    vcycle, scratch = vcycle_phase(
        dev, _gpt_base(), MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.05,
                                           e_small_frac=0.5),
        TrainConfig(steps=40, warmup_steps=2, peak_lr=6e-4, batch_size=8, seq_len=1024,
                    log_every=1))
    log(f"[time] phase 7 done at {time.time() - t0:.1f}s")
    serve = {k: 0 for k in vcycle}
    serve.update(flash_attention_fwd=serve_flash, paged_attention_decode=serve_paged)
    kernels = timing_phase(dev, decode_inputs)
    kernels += train_timing_phase(dev)
    for entry in kernels:  # launches on the main paths: serving, V-cycle, scratch
        name = entry["name"]
        entry["launches_by_path"] = {"serve": serve[name], "vcycle": vcycle[name],
                                     "scratch": scratch[name]}
        entry["launches"] = serve[name] + vcycle[name] + scratch[name]
        check(entry["launches"] > 0, f"{name} was never launched on a main path")
    order = list(_wrappers())
    kernels.sort(key=lambda e: order.index(e["name"]))
    log(f"[time] phase 5 done at {time.time() - t0:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
