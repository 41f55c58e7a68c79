"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version, the serving path and one train step on both kernel backends.

Every test carries the ``gpu`` marker and skips inside the test when no CUDA
card is present.  The file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: attention in f32 within 1e-4 (same inputs, summation order
differs), in bf16 within 2e-2 of the plain version fed the same bf16 inputs
(relative to the largest gradient for the backward); coalesce_pair and
interp_axpy exactly (the same roundings); the train step's loss and
updated parameters within 1e-5 and its gradients within 1e-5 + 1e-3 of
each leaf's largest gradient.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import TrainConfig
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
from repro_torch.kernels.paged_attention import (paged_attention_decode_cuda,
                                                 paged_attention_decode_torch)
from repro_torch.launch.serve import Request, make_server
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.param import flatten, unflatten

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [4, 16])
def test_paged_kernel_matches_plain(dtype, P):
    dev = _card()
    B, KH, G, D, M = 5, 2, 4, 64, 12
    lengths = np.array([0, 1, P + 1, 7 * P - 3, M * P])
    N = 1 + sum(-(-int(n) // P) for n in lengths)
    tables = np.zeros((B, M), np.int64)
    perm = np.random.default_rng(0).permutation(np.arange(1, N))
    for b, n in enumerate(lengths):
        used = -(-int(n) // P)
        tables[b, :used], perm = perm[:used], perm[used:]
    q = _randn((B, KH, G, D), 1, dtype, dev)
    kp, vp = _randn((N, P, KH, D), 2, dtype, dev), _randn((N, P, KH, D), 3, dtype, dev)
    bt, ln = torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev)
    got = paged_attention_decode_cuda(q, kp, vp, bt, ln)
    want = paged_attention_decode_torch(q, kp, vp, bt, ln)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert got[0].abs().max().item() == 0.0  # idle row: exact zeros


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1023, 1025, 50304 * 768])
def test_interp_axpy_kernel_equals_plain(dtype, n):
    """Equal: both round the two products and the sum separately."""
    dev = _card()
    a, b = _randn((n,), 5, dtype, dev), _randn((n,), 6, dtype, dev)
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
