"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version, and the serving path on both kernel backends.

Every test carries the ``gpu`` marker and skips inside the test when no CUDA
card is present.  The file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 within 1e-4 (same inputs, summation order differs); bf16
within 2e-2 of the plain version fed the same bf16 inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch
from repro_torch.kernels.paged_attention import (paged_attention_decode_cuda,
                                                 paged_attention_decode_torch)
from repro_torch.launch.serve import Request, make_server

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
