"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version, the serving path (both kernel backends, both engines, the
speculative verify step and policy) and one train step on both kernel
backends, for a dense model and for the MoE family (Phi smoke at head_dim
128); the recurrent mixers: prefill plus a decode step against the full
forward (xLSTM-125m smoke, and Mamba beside attention), and a hybrid train
step with flash beside a Mamba layer on both kernel backends; MLA's head
dims (192, 128) in the three flash kernels, and an MLA model's streams and
train step on both kernel backends; two processes serving on a ``--mesh
1x2`` against one.

Every test carries the ``gpu`` marker and skips inside the test when no CUDA
card is present.  The file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: attention in f32 within 1e-4 (same inputs, summation order
differs), in bf16 within 2e-2 of the plain version fed the same bf16 inputs
(relative to the largest gradient for the backward): the bf16 forward, dq
and dk/dv kernels round P and dS to bf16 before their tensor-core products,
which the f32 plain version does not do; coalesce_pair and
interp_axpy exactly (the same roundings); the verify step's logits
against single-token decode steps within 1e-4 (f32) and 2e-2 (bf16) of the
largest logit or 1, whichever is larger; the train step's loss and
updated parameters within 1e-5 and its gradients within 1e-5 + 1e-3 of
each leaf's largest gradient.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config import BlockSpec, Stage, TrainConfig
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import gpt_proxy
from repro_torch.data import MarkovLM, lm_batch
from repro_torch.kernels import dispatch
from repro_torch.kernels.coalesce_pair import coalesce_pair_cuda, coalesce_pair_torch
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_dkv_cuda,
                                                 flash_attention_bwd_dq_cuda,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_cuda, flash_attention_torch)
from repro_torch.kernels.interp_axpy import interp_axpy_cuda, interp_axpy_torch
from repro_torch.kernels.paged_attention import (SPLIT_SPAN, paged_attention_decode_cuda,
                                                 paged_attention_decode_torch)
from repro_torch.launch.serve import Request, make_server
from repro_torch.models.api import (build_model, make_prefill_step, make_serve_step,
                                    make_train_step, make_verify_step)
from repro_torch.optim import adamw_init
from repro_torch.param import flatten, tree_map, unflatten

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, seed, dtype, dev):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,S,T,D", [(True, 333, 333, 64), (False, 100, 257, 64),
                                          (True, 130, 130, 128)])
def test_flash_kernel_matches_plain(dtype, causal, S, T, D):
    dev = _card()
    q, k, v = (_randn(s, i, dtype, dev) for i, s in
               enumerate([(2, S, 8, D), (2, T, 2, D), (2, T, 2, D)]))
    before = flash_attention_cuda.launches
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_torch(q, k, v, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _paged_case(lengths, P, G, D, M, dtype, index_dtype, dev, KH=2):
    """q, pools, the plain version's tables (padding -> page 0) and the
    kernel's (padding -> a NaN page no valid position may reach), lengths."""
    B = len(lengths)
    used = [-(-int(n) // P) for n in lengths]
    N = 2 + sum(used)  # page 0 is the null page, page N - 1 the NaN page
    tables = np.zeros((B, M), np.int64)
    perm = np.random.default_rng(0).permutation(np.arange(1, N - 1))
    for b, u in enumerate(used):
        tables[b, :u], perm = perm[:u], perm[u:]
    poisoned = tables.copy()
    for b, u in enumerate(used):
        poisoned[b, u:] = N - 1
    q = _randn((B, KH, G, D), 1, dtype, dev)
    kp, vp = _randn((N, P, KH, D), 2, dtype, dev), _randn((N, P, KH, D), 3, dtype, dev)
    kp[N - 1] = float("nan")
    vp[N - 1] = float("nan")
    ln = torch.tensor(lengths, dtype=index_dtype, device=dev)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(poisoned).to(dev, index_dtype), ln)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [4, 16, 64])
@pytest.mark.parametrize("G,D", [(1, 64), (8, 64), (1, 128), (8, 128), (2, 16), (4, 32)])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("full", [False, True])
def test_paged_kernel_matches_plain(dtype, P, G, D, index_dtype, full):
    """Lengths on either side of the 64-position split edges, 0, 1, P + 1 and
    the whole table (M * P), or one sequence at the whole table; table
    padding points at a NaN page; int32 and int64 tables."""
    dev = _card()
    span = SPLIT_SPAN
    M = max(12, 4 * span // P)
    lengths = [M * P] if full else [0, 1, P + 1, span - 1, span, span + 1, M * P]
    q, kp, vp, bt, bt_kernel, ln = _paged_case(lengths, P, G, D, M, dtype, index_dtype, dev)
    before = paged_attention_decode_cuda.launches
    got = paged_attention_decode_cuda(q, kp, vp, bt_kernel, ln)
    want = paged_attention_decode_torch(q, kp, vp, bt, ln)
    assert paged_attention_decode_cuda.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if not full:
        assert got[0].abs().max().item() == 0.0  # idle row: exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_bit_identical_across_launches(dtype):
    """The splits are merged in a fixed order, with no atomics."""
    dev = _card()
    args = _paged_case([1301, 65, 2048, 700], 16, 8, 64, 128, dtype, torch.int64, dev)
    q, kp, vp, _, bt_kernel, ln = args
    outs = [paged_attention_decode_cuda(q, kp, vp, bt_kernel, ln) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,S,T,H,KH,D", [(True, 333, 333, 8, 2, 64),
                                               (False, 100, 257, 4, 4, 64),
                                               (True, 130, 130, 4, 1, 128)])
def test_flash_bwd_kernels_match_plain(dtype, causal, S, T, H, KH, D):
    dev = _card()
    q, k, v, do = (_randn(s, i, dtype, dev) for i, s in
                   enumerate([(2, S, H, D), (2, T, KH, D), (2, T, KH, D), (2, S, H, D)]))
    out, lse = flash_attention_torch(q, k, v, causal=causal)
    before = (flash_attention_bwd_dq_cuda.launches, flash_attention_bwd_dkv_cuda.launches)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    want = flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
    assert (flash_attention_bwd_dq_cuda.launches, flash_attention_bwd_dkv_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype] * max(
            1.0, w.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,S,T", [(True, 333, 333), (False, 100, 257), (True, 1031, 1031)])
def test_mla_head_dims_flash_kernels_match_plain(dtype, causal, S, T):
    """MLA's (D 192, Dv 128) with KH = H: the forward, dq and dk/dv kernels
    against their plain versions, ragged S and T, and a second dq and dk/dv
    launch bit-identical to the first."""
    dev = _card()
    H = 16
    q, k, v, do = (_randn(s, 40 + i, dtype, dev) for i, s in
                   enumerate([(1, S, H, 192), (1, T, H, 192), (1, T, H, 128), (1, S, H, 128)]))
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_torch(q, k, v, causal=causal)
    assert out.shape == (1, S, H, 128)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    out, lse = want, want_lse
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    ref = flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
    for g, w in zip(got, ref):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype] * max(
            1.0, w.float().abs().max().item())
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal)
    assert torch.equal(dq, got[0])
    assert all(torch.equal(a, b) for a, b in zip(
        flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal), got[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", [(64, 64), (128, 128), (192, 128)])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_flash_kernels_at_a_query_offset_match_plain(dtype, D, Dv, where):
    """A context-parallel chunk: C = 130 query rows of a causal sequence of
    T = 3C at offset 0, 150 (inside a 64-key tile) or T - C.  The forward,
    dq and dk/dv kernels with ``q_offset`` against their plain versions."""
    dev = _card()
    C, H, KH = 130, 8, 2
    T, off = 3 * C, {"first": 0, "mid": 150, "last": 2 * C}[where]
    q, k, v, do = (_randn(s, 60 + i, dtype, dev) for i, s in
                   enumerate([(1, C, H, D), (1, T, KH, D), (1, T, KH, Dv), (1, C, H, Dv)]))
    out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=off)
    want, want_lse = flash_attention_torch(q, k, v, causal=True, q_offset=off)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got = flash_attention_bwd_cuda(q, k, v, want, want_lse, do, causal=True, q_offset=off)
    ref = flash_attention_bwd_torch(q, k, v, want, want_lse, do, causal=True, q_offset=off)
    for g, w in zip(got, ref):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype] * max(
            1.0, w.float().abs().max().item())


# the ragged edges of the tensor-core bodies' 64-row and 64-key tiles
EDGES = (1, 17, 63, 64, 65, 127, 129, 1031)


def _edge_case(S, causal):
    """(S, T): T = S when causal, else another edge, so that T != S."""
    return S, S if causal else EDGES[(EDGES.index(S) + 3) % len(EDGES)]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KH", [(12, 12), (32, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", EDGES)
def test_bf16_flash_forward_on_tile_edges(S, causal, H, KH, D):
    dev = _card()
    S, T = _edge_case(S, causal)
    q, k, v = (_randn(s, i, torch.bfloat16, dev) for i, s in
               enumerate([(2, S, H, D), (2, T, KH, D), (2, T, KH, D)]))
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_torch(q, k, v, causal=causal)
    assert (out.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _dkv_inputs(S, T, H, KH, D, causal, dev):
    """bf16 q, k, v, do with the plain forward's lse and delta = rowsum(do * out)."""
    q, k, v, do = (_randn(s, 10 + i, torch.bfloat16, dev) for i, s in
                   enumerate([(2, S, H, D), (2, T, KH, D), (2, T, KH, D), (2, S, H, D)]))
    out, lse = flash_attention_torch(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, out, lse, delta


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KH", [(12, 12), (32, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", EDGES)
def test_bf16_flash_dkv_on_tile_edges(S, causal, H, KH, D):
    dev = _card()
    S, T = _edge_case(S, causal)
    q, k, v, do, out, lse, delta = _dkv_inputs(S, T, H, KH, D, causal, dev)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    _, wk, wv = flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
    for g, w in ((dk, wk), (dv, wv)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= TOL[torch.bfloat16] * max(
            1.0, w.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KH", [(12, 12), (32, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", EDGES)
def test_bf16_flash_dq_on_tile_edges(S, causal, H, KH, D):
    """The tensor-core dq body: dq against the plain backward's, and the
    delta it writes against rowsum(do * out) in f32."""
    dev = _card()
    S, T = _edge_case(S, causal)
    q, k, v, do, out, lse, delta = _dkv_inputs(S, T, H, KH, D, causal, dev)
    dq, got_delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal)
    wq, _, _ = flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
    assert dq.shape == wq.shape and dq.dtype == wq.dtype
    for g, w in ((dq, wq), (got_delta, delta)):
        assert (g.float() - w.float()).abs().max().item() <= TOL[torch.bfloat16] * max(
            1.0, w.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_dq_is_bit_identical_across_launches(causal):
    """Each block owns its query rows and uses no atomics: two launches on
    the same inputs give the same dq and delta bits."""
    dev = _card()
    q, k, v, do, out, lse, _ = _dkv_inputs(1031, 1031, 32, 4, 64, causal, dev)
    first = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal)
    second = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_dkv_is_bit_identical_across_launches(causal):
    """The GQA sum over query heads happens inside one block, in a fixed
    order: two launches on the same inputs give the same bits."""
    dev = _card()
    q, k, v, do, _, lse, delta = _dkv_inputs(1031, 1031, 32, 4, 64, causal, dev)
    first = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    second = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_bf16_misaligned_view_raises_without_launching():
    """A bf16 q that starts 2 bytes past a 16-byte boundary, or a k cut from
    longer rows, is refused: no launch, no fallback."""
    dev = _card()
    B, S, H, D = 1, 130, 4, 64
    n = B * S * H * D
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    q_bad = buf[1:n + 1].view(B, S, H, D)
    q = torch.zeros((B, S, H, D), dtype=torch.bfloat16, device=dev)
    k_bad = torch.zeros((B, S, H, D + 4), dtype=torch.bfloat16, device=dev)[..., :D]
    before = flash_attention_cuda.launches, flash_attention_bwd_dkv_cuda.launches
    with pytest.raises(ValueError, match="bf16 q .*16-byte aligned"):
        flash_attention_cuda(q_bad, q, q)
    with pytest.raises(ValueError, match="bf16 k .*multiple of 8"):
        flash_attention_cuda(q, k_bad, q)
    stats = torch.zeros((B, H, S), device=dev)
    with pytest.raises(ValueError, match="bf16 do .*16-byte aligned"):
        flash_attention_bwd_dkv_cuda(q, q, q, q_bad, stats, stats)
    assert (flash_attention_cuda.launches, flash_attention_bwd_dkv_cuda.launches) == before


@pytest.mark.gpu
def test_flash_function_gradients_equal_across_backends():
    """The Function on the kernels gives the gradients it gives on the plain
    versions; the raw forward wrapper refuses to run under autograd."""
    dev = _card()
    grads = {}
    for backend in ("cuda", "torch"):
        q, k, v = (_randn(s, i, torch.float32, dev).requires_grad_() for i, s in
                   enumerate([(2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64)]))
        out = dispatch.flash_attention(q, k, v, causal=True, backend=backend)
        out.backward(_randn(out.shape, 9, torch.float32, dev))
        grads[backend] = (q.grad, k.grad, v.grad)
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert (a - b).abs().max().item() <= 1e-4
    with pytest.raises(RuntimeError, match="records no gradient"):
        flash_attention_cuda(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w0", [0.5, 1.0])
@pytest.mark.parametrize("shape,axis", [((768, 36864), 0), ((10, 7), 0), ((2, 1), 0),
                                        ((7, 10), 1), ((64, 96), 1), ((12, 589824), 0)])
def test_coalesce_pair_kernel_equals_plain(dtype, w0, shape, axis):
    """Exactly equal: the same add and power-of-two scale in f32."""
    dev = _card()
    w = _randn(shape, 4, dtype, dev)
    got = coalesce_pair_cuda(w, axis=axis, w0=w0)
    assert torch.equal(got, coalesce_pair_torch(w, axis=axis, w0=w0))


# 16-byte chunks of one interp_axpy block: one per thread (csrc/interp_axpy.cu)
AXPY_BLOCK_CHUNKS = 256


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1023, 1025, 50304 * 768] + [
    ("blocks", k, d) for k in (1, 2, 5) for d in (-1, 0, 1)])
def test_interp_axpy_kernel_equals_plain(dtype, n):
    """Equal: both round the two products and the sum separately.  The
    ("blocks", k, d) sizes are k whole blocks of 16-byte chunks plus d
    elements: on either side of the last block's edge and of the scalar
    tail."""
    dev = _card()
    if isinstance(n, tuple):
        _, k, d = n
        n = AXPY_BLOCK_CHUNKS * (16 // dtype.itemsize) * k + d
    a, b = _randn((n,), 5, dtype, dev), _randn((n,), 6, dtype, dev)
    assert torch.equal(interp_axpy_cuda(a, b, 0.25), interp_axpy_torch(a, b, 0.25))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interp_axpy_misaligned_views_take_the_scalar_path(dtype):
    """Views that do not start on a 16-byte boundary go through the scalar
    loop and still equal the plain version."""
    dev = _card()
    n = AXPY_BLOCK_CHUNKS * (16 // dtype.itemsize) * 3
    buf = _randn((2, n + 2), 7, dtype, dev)
    a, b = buf[0, 1:-1], buf[1, 1:-1]
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    assert torch.equal(interp_axpy_cuda(a, b, 0.25), interp_axpy_torch(a, b, 0.25))


@pytest.mark.gpu
def test_train_step_gradients_equal_across_backends():
    """One train step of a two-layer model at head_dim 64, f32, from the same
    weights and batch: loss, every gradient and the updated parameters
    agree between the kernel backend and the plain one."""
    dev = _card()
    cfg = gpt_proxy(d_model=256, n_layers=2, vocab=512).replace(
        compute_dtype=torch.float32, attn_impl="blockwise", attn_block_k=64, remat="full")
    chain = MarkovLM(cfg.vocab_size)
    batch = lm_batch(chain, 0, 0, 2, 256, device=dev)
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    res = {}
    for backend in ("cuda", "torch"):
        c = cfg.replace(kernel_backend=backend)
        model = build_model(c)
        params = {k: v for k, v in flatten(init).items()}
        leaves = [v.clone().requires_grad_() for v in params.values()]
        tree = unflatten(dict(zip(params, leaves)))
        loss, _ = model.loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        # eps 1e-4: at 1e-8 Adam's first step moves a weight whose gradient
        # is zero up to rounding by up to lr either way
        tc = TrainConfig(steps=4, warmup_steps=1, eps=1e-4)
        tree, _, metrics = make_train_step(model, tc)(tree, adamw_init(tree, tc), batch)
        res[backend] = (loss.item(), grads, flatten(tree), metrics["loss"].item())
    assert abs(res["cuda"][0] - res["torch"][0]) <= 1e-5
    assert abs(res["cuda"][3] - res["torch"][3]) <= 1e-5
    for a, b in zip(res["cuda"][1], res["torch"][1]):
        assert (a - b).abs().max().item() <= 1e-5 + 1e-3 * b.abs().max().item()
    for key, b in res["torch"][2].items():
        assert (res["cuda"][2][key] - b).abs().max().item() <= 1e-5, key


@pytest.mark.gpu
def test_serving_streams_equal_across_backends():
    """The smoke config at head_dim 64, f32: the kernel backend and the plain
    backend serve identical greedy streams, and both kernels ran."""
    dev = _card()
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(
        head_dim=64, attn_block_k=64, compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (150, 9, 200, 131)]
    streams = {}
    for backend in ("cuda", "torch"):
        srv = make_server(cfg.replace(kernel_backend=backend), batch=2, max_seq=256,
                          page_size=8, device=dev)
        counts = flash_attention_cuda.launches, paged_attention_decode_cuda.launches
        streams[backend] = {r.rid: r.out for r in
                            srv.run([Request(i, p, 5) for i, p in enumerate(prompts)])}
        ran = (flash_attention_cuda.launches - counts[0],
               paged_attention_decode_cuda.launches - counts[1])
        assert (min(ran) > 0) == (backend == "cuda"), ran
    assert streams["cuda"] == streams["torch"]


def _phi_smoke(**kw):
    """Phi-3.5-MoE's smoke config at Phi's head_dim 128, f32, flash route
    past 64 tokens."""
    return get_config("phi3.5-moe-42b-a6.6b", smoke=True).replace(
        head_dim=128, attn_block_k=64, compute_dtype=torch.float32, **kw)


@pytest.mark.gpu
def test_moe_serving_streams_equal_across_backends():
    """A Phi smoke paged server (f32): the kernel backend and the plain one
    serve identical greedy streams, a shared-prefix request through the
    padded extend step included, and both kernels ran."""
    dev = _card()
    cfg = _phi_smoke()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (150, 9, 200, 131)]
    # admitted beside the 200-token prompt, whose first 64 tokens it shares
    prompts.insert(3, np.concatenate([prompts[2][:64], rng.integers(0, cfg.vocab_size, 21)]))
    streams = {}
    for backend in ("cuda", "torch"):
        srv = make_server(cfg.replace(kernel_backend=backend), batch=2, max_seq=256,
                          page_size=8, device=dev)
        counts = flash_attention_cuda.launches, paged_attention_decode_cuda.launches
        streams[backend] = {r.rid: r.out for r in
                            srv.run([Request(i, p, 5) for i, p in enumerate(prompts)])}
        ran = (flash_attention_cuda.launches - counts[0],
               paged_attention_decode_cuda.launches - counts[1])
        assert (min(ran) > 0) == (backend == "cuda"), ran
        assert srv.prefill_tokens_saved == 64
    assert streams["cuda"] == streams["torch"]


@pytest.mark.gpu
def test_moe_train_step_gradients_equal_across_backends():
    """One Phi smoke train step (head_dim 128, seq 256, remat "full", f32)
    on both kernel backends: loss, moe_aux, every gradient (the router's
    through the recomputed block) and the updated parameters agree."""
    dev = _card()
    cfg = _phi_smoke(remat="full")
    batch = lm_batch(MarkovLM(cfg.vocab_size), 0, 0, 2, 256, device=dev)
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    res = {}
    for backend in ("cuda", "torch"):
        model = build_model(cfg.replace(kernel_backend=backend))
        before = flash_attention_bwd_dq_cuda.launches
        params = flatten(init)
        leaves = [v.clone().requires_grad_() for v in params.values()]
        tree = unflatten(dict(zip(params, leaves)))
        loss, metrics = model.loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        tc = TrainConfig(steps=4, warmup_steps=1, eps=1e-4)
        tree, _, _ = make_train_step(model, tc)(tree, adamw_init(tree, tc), batch)
        ran = flash_attention_bwd_dq_cuda.launches - before
        assert (ran > 0) == (backend == "cuda"), ran
        res[backend] = (loss.item(), metrics["moe_aux"].item(), grads, flatten(tree))
    (lc, ac, gc, pc), (lt, at, gt, pt) = res["cuda"], res["torch"]
    assert abs(lc - lt) <= 1e-5 and abs(ac - at) <= 1e-5
    for a, b in zip(gc, gt):
        assert (a - b).abs().max().item() <= 1e-5 + 1e-3 * b.abs().max().item()
    assert gt[list(params).index("stages/stage_0/b0/ffn/router")].abs().max() > 0
    for key, b in pt.items():
        assert (pc[key] - b).abs().max().item() <= 1e-5, key


def _mla_smoke(**kw):
    """DeepSeek-V3's smoke config at MLA's head dims (nope 128, rope 64, v
    128), f32, flash route past 64 tokens, the MTP head on."""
    return get_config("deepseek-v3-671b", smoke=True).replace(
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, attn_block_k=64,
        compute_dtype=torch.float32, **kw)


@pytest.mark.gpu
def test_mla_streams_and_train_step_equal_across_backends():
    """An MLA model at nope 128 + rope 64, v 128 (narrow d_model, 3 layers):
    paged greedy streams (absorbed decode, flash prefill) and one train
    step's loss, ``mtp_ce``, gradients and updated parameters agree between
    the kernel backend and the plain one; flash ran, paged decode did not."""
    dev = _card()
    cfg = _mla_smoke()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (150, 9, 200, 131)]
    streams = {}
    for backend in ("cuda", "torch"):
        srv = make_server(cfg.replace(kernel_backend=backend), batch=2, max_seq=256,
                          page_size=8, device=dev)
        counts = flash_attention_cuda.launches, paged_attention_decode_cuda.launches
        streams[backend] = {r.rid: r.out for r in
                            srv.run([Request(i, p, 5) for i, p in enumerate(prompts)])}
        ran = (flash_attention_cuda.launches - counts[0],
               paged_attention_decode_cuda.launches - counts[1])
        assert ran == ((3 * 3 if backend == "cuda" else 0), 0), ran
    assert streams["cuda"] == streams["torch"]
    batch = lm_batch(MarkovLM(cfg.vocab_size), 0, 0, 2, 256, device=dev)
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    res = {}
    for backend in ("cuda", "torch"):
        model = build_model(cfg.replace(kernel_backend=backend))
        leaves = [v.clone().requires_grad_() for v in flatten(init).values()]
        tree = unflatten(dict(zip(flatten(init), leaves)))
        loss, metrics = model.loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        tc = TrainConfig(steps=4, warmup_steps=1, eps=1e-4)
        tree, _, _ = make_train_step(model, tc)(tree, adamw_init(tree, tc), batch)
        res[backend] = ({k: v.item() for k, v in metrics.items()}, grads, flatten(tree))
    assert set(res["cuda"][0]) == {"ce", "mtp_ce", "moe_aux", "loss"}
    for k, v in res["torch"][0].items():
        assert abs(res["cuda"][0][k] - v) <= 1e-5, k
    for a, b in zip(res["cuda"][1], res["torch"][1]):
        assert (a - b).abs().max().item() <= 1e-5 + 1e-3 * b.abs().max().item()
    for key, b in res["torch"][2].items():
        assert (res["cuda"][2][key] - b).abs().max().item() <= 1e-5, key


def _tiny_hybrid(**kw):
    """``tests/helpers.py``'s ``tiny_hybrid`` in the port: Mamba and
    attention blocks, each with a dense FFN."""
    return get_config("tinyllama-1.1b", smoke=True).replace(
        name="t-hyb", family="hybrid", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, qk_norm=True, compute_dtype=torch.float32,
        stages=(Stage((BlockSpec("mamba", "dense"), BlockSpec("attn", "dense")), 2),), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("fam", ["xlstm", "hybrid"])
def test_recurrent_decode_matches_forward(fam):
    """Prefill tokens[:T] on the card, then decode position T from the
    prefill's state (f32): the logits equal the full forward's at T - 1 and
    T within 1e-4 of max(1, max |logit|)."""
    dev = _card()
    cfg = (get_config("xlstm-125m", smoke=True).replace(compute_dtype=torch.float32)
           if fam == "xlstm" else _tiny_hybrid())
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B, S = 2, 40
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))).to(dev)
    T = S - 1
    with torch.inference_mode():
        full = model.forward_logits(params, {"tokens": toks})
        lg_pre, caches = make_prefill_step(model)(params, toks[:, :T])

        def grow(buf, spec):  # K/V from T to S positions; recurrent states as they are
            out = torch.zeros(spec.shape, dtype=spec.dtype or buf.dtype, device=dev)
            out[tuple(slice(0, n) for n in buf.shape)] = buf
            return out

        caches = tree_map(grow, caches, model.cache_specs(B, S))
        lg_dec, _ = make_serve_step(model)(params, caches, toks[:, T:],
                                           torch.full((B,), T, dtype=torch.long, device=dev))
    tol = TOL[torch.float32] * max(1.0, full.abs().max().item())
    assert (lg_pre - full[:, T - 1]).abs().max().item() <= tol
    assert (lg_dec - full[:, T]).abs().max().item() <= tol


@pytest.mark.gpu
def test_hybrid_train_step_gradients_equal_across_backends():
    """One train step of the hybrid (Mamba beside attention; head_dim 64,
    seq 256 past attn_block_k 64, remat "full", f32) on both kernel
    backends: the flash kernels run beside the Mamba layers' plain scan;
    loss, every gradient and the updated parameters agree."""
    dev = _card()
    cfg = _tiny_hybrid(head_dim=64, attn_impl="blockwise", attn_block_k=64, remat="full")
    batch = lm_batch(MarkovLM(cfg.vocab_size), 0, 0, 2, 256, device=dev)
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    res = {}
    for backend in ("cuda", "torch"):
        model = build_model(cfg.replace(kernel_backend=backend))
        before = flash_attention_bwd_dq_cuda.launches
        params = flatten(init)
        leaves = [v.clone().requires_grad_() for v in params.values()]
        tree = unflatten(dict(zip(params, leaves)))
        loss, _ = model.loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        tc = TrainConfig(steps=4, warmup_steps=1, eps=1e-4)
        tree, _, _ = make_train_step(model, tc)(tree, adamw_init(tree, tc), batch)
        ran = flash_attention_bwd_dq_cuda.launches - before
        assert ran == (4 if backend == "cuda" else 0), ran  # 2 attention layers, 2 passes
        res[backend] = (loss.item(), grads, flatten(tree))
    (lc, gc, pc), (lt, gt, pt) = res["cuda"], res["torch"]
    assert abs(lc - lt) <= 1e-5
    for a, b in zip(gc, gt):
        assert (a - b).abs().max().item() <= 1e-5 + 1e-3 * b.abs().max().item()
    for key, b in pt.items():
        assert (pc[key] - b).abs().max().item() <= 1e-5, key


def _smoke64(dtype):
    """The smoke config at head_dim 64 (the kernels' width), flash prefill
    past 64 tokens."""
    return get_config("tinyllama-1.1b", smoke=True).replace(
        head_dim=64, attn_block_k=64, compute_dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_logits_equal_single_token_decode_steps(dtype):
    """The speculative verify step scores k+1 positions at once (plain
    attention over the gathered pages); k+1 single-token paged decode steps
    (the kernel) on a copy of the same pool give the same logits.  Two rows:
    one with a run of k+1, one right-padded to a run of 2."""
    dev = _card()
    cfg = _smoke64(dtype)
    srv = make_server(cfg, batch=2, max_seq=128, page_size=8, device=dev)
    rng = np.random.default_rng(3)
    for i, n in enumerate((21, 9)):
        assert srv.admit(Request(i, rng.integers(0, cfg.vocab_size, size=n), 16))
    k, runs = 4, (5, 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, k + 1))).to(dev)
    pos = torch.full((2, k + 1), -1, dtype=torch.int64)
    for i, n in enumerate(runs):
        pos[i, :n] = torch.arange(int(srv.pos[i]), int(srv.pos[i]) + n)
    pos = pos.to(dev)
    bt = torch.zeros((2, max(map(len, srv.tables))), dtype=torch.int64)  # null-page padding
    for i, t in enumerate(srv.tables):
        bt[i, :len(t)] = torch.tensor(t)
    bt = bt.to(dev)
    twin = tree_map(torch.clone, srv.pages)
    before = paged_attention_decode_cuda.launches
    got, _ = make_verify_step(srv.model)(srv.params, srv.pages, toks, pos, bt)
    assert paged_attention_decode_cuda.launches == before  # S > 1: plain attention
    want = torch.stack([srv.paged_step(srv.params, twin, toks[:, j:j + 1], pos[:, j:j + 1],
                                       bt)[0] for j in range(k + 1)], 1)
    assert paged_attention_decode_cuda.launches - before == (k + 1) * cfg.n_layers
    for i, n in enumerate(runs):
        g, w = got[i, :n].float(), want[i, :n].float()
        err = ((g - w).abs().max() / w.abs().max().clamp_min(1.0)).item()
        assert torch.isfinite(g).all() and err <= TOL[dtype], (i, err)


@pytest.mark.gpu
def test_slots_and_speculative_streams_equal_paged_greedy():
    """f32 on the card: the slots engine and the speculative policy serve
    the paged greedy streams; the speculative run drafted through paged
    decode and projected its draft through coalesce_pair."""
    dev = _card()
    cfg = _smoke64(torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (150, 9, 200, 131, 17)]
    streams = {}
    for engine, policy in (("paged", "greedy"), ("slots", "greedy"), ("paged", "speculative")):
        counts = paged_attention_decode_cuda.launches, coalesce_pair_cuda.launches
        srv = make_server(cfg, engine=engine, policy=policy, draft_k=3, batch=2,
                          max_seq=256, page_size=8, device=dev)
        streams[engine, policy] = {r.rid: r.out for r in
                                   srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])}
        ran = (paged_attention_decode_cuda.launches - counts[0],
               coalesce_pair_cuda.launches - counts[1])
        assert ran[0] > 0 if engine == "paged" else ran[0] == 0, (engine, ran)
        assert (ran[1] > 0) == (policy == "speculative"), (policy, ran)
    greedy = streams["paged", "greedy"]
    assert streams["slots", "greedy"] == greedy
    assert streams["paged", "speculative"] == greedy


@pytest.mark.gpu
def test_async_checkpoint_of_card_tensors_snapshots_before_it_returns(tmp_path):
    """f32, bf16 and int32 0-d leaves on the card, saved with
    ``blocking=False`` and updated in place at once: the checkpoint holds the
    values from before, and restores onto the card bit for bit, each leaf a
    tensor of its own."""
    from repro_torch.checkpoint import CheckpointManager

    dev = _card()
    state = {"params": {"w": _randn((512, 384), 1, torch.float32, dev),
                        "bf": _randn((1000,), 2, torch.bfloat16, dev),
                        "twin": _randn((512, 384), 1, torch.float32, dev)},
             "opt": {"count": 5, "i": torch.zeros((), dtype=torch.int32, device=dev)}}
    want = {k: v.clone() for k, v in flatten(state["params"]).items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state, meta={"step": 1}, blocking=False)
    with torch.no_grad():
        for t in flatten(state["params"]).values():
            t.mul_(-2.0).add_(1.0)
    cm.wait()
    out, _ = cm.restore(state)
    got = flatten(out["params"])
    assert all(t.device == dev and torch.equal(t, want[k]) for k, t in got.items())
    assert got["w"].data_ptr() != got["twin"].data_ptr()
    assert out["opt"]["count"] == 5 and out["opt"]["i"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the "model" axis: two processes sharing the card


MESH_WORKER = textwrap.dedent("""
    import json, os
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    RANK, OUT = int(os.environ["RANK"]), os.environ["OUT"]
    from repro_torch.config import BlockSpec, uniform_stages
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.launch.serve import Request, make_server
    init_distributed(os.environ["COORD"], 2, RANK, device="cuda")
    mesh = make_cli_mesh("1x2", num_processes=2, device="cuda")
    cfg = get_config("tinyllama-1.1b").replace(
        stages=uniform_stages(2, BlockSpec("attn", "dense")), compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 600, 130, 300)]
    prompts[3][:256] = prompts[1][:256]
    reqs = lambda: [Request(i, p, 8) for i, p in enumerate(prompts)]
    kw = dict(batch=4, max_seq=1024, page_size=16, device="cuda")
    out = {"mesh": {r.rid: r.out for r in make_server(cfg, mesh=mesh, **kw).run(reqs())}}
    if RANK == 0:
        out["one"] = {r.rid: r.out for r in make_server(cfg, **kw).run(reqs())}
    with open(f"{OUT}/gpu{RANK}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.mark.gpu
def test_mesh_streams_equal_one_process_on_the_card(tmp_path):
    """TinyLlama-1.1B at full width cut to 2 layers, f32, served by two
    processes sharing the card on a ``--mesh 1x2`` (gloo), emits the same
    streams on both ranks as the same server on one process (rank 0 runs
    it), on a cold flash prefill, a prefix extend and two plain prefills."""
    _card()
    root = os.path.join(os.path.dirname(__file__), "..")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH="src", RANK=str(r), OUT=str(tmp_path),
                 COORD=f"file://{tmp_path / 'coord'}")) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    recs = [json.loads((tmp_path / f"gpu{r}.json").read_text()) for r in range(2)]
    assert recs[0]["mesh"] == recs[1]["mesh"] == recs[0]["one"]
