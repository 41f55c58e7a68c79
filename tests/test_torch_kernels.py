"""The port's kernel layer against the JAX reference, on the CPU.

The plain PyTorch versions of the two kernels (flash-attention forward and
paged decode) are held to the reference's oracles (``repro.kernels.ref``) and
to its Pallas kernels run in interpret mode, at f32 with atol 1e-5; the GQA
flash adapter is held to ``repro.layers.attention._flash_pallas``.  Inputs
are numpy arrays from a seed, handed to both packages.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _fwd_call
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention_decode as jax_paged
from repro.layers.attention import _flash_pallas

from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch
from repro_torch.kernels.paged_attention import (paged_attention_decode_cuda,
                                                 paged_attention_decode_torch)
from repro_torch.layers.attention import _flash_attention

ATOL = 1e-5


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gqa_inputs(B, S, T, H, KH, D, seed=0):
    """q [B,S,H,D], k/v [B,T,KH,D] (the port's layout)."""
    return _randn((B, S, H, D), seed), _randn((B, T, KH, D), seed + 1), \
        _randn((B, T, KH, D), seed + 2)


def _to_heads(q, k, v, G):
    """The reference's [B,H,S,D] layout with K/V broadcast over the groups."""
    return (q.transpose(0, 2, 1, 3), np.repeat(k.transpose(0, 2, 1, 3), G, axis=1),
            np.repeat(v.transpose(0, 2, 1, 3), G, axis=1))


# ---------------------------------------------------------------------------
# flash attention: plain version vs the reference


@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_matches_reference(causal):
    q, k, v = (_randn((2, 3, 24, 16), s) for s in (1, 2, 3))
    got = ref.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = jref.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,S,T", [(True, 64, 64), (False, 32, 64)])
def test_flash_plain_matches_reference_oracle_and_pallas(causal, S, T):
    B, H, KH, D = 1, 4, 2, 16
    q, k, v = _gqa_inputs(B, S, T, H, KH, D)
    out, lse = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    qh, kh, vh = (jnp.asarray(a) for a in _to_heads(q, k, v, H // KH))
    want = np.asarray(jref.naive_attention(qh, kh, vh, causal=causal)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    pallas = np.asarray(jax_flash(qh, kh, vh, causal=causal, block_q=32, block_k=32,
                                  interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL, rtol=0)
    # the log-sum-exp the Pallas forward emits for its backward
    _, want_lse = _fwd_call(qh.reshape(B * H, S, D), kh.reshape(B * H, T, D),
                            vh.reshape(B * H, T, D), causal=causal, scale=D ** -0.5,
                            bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S), np.asarray(want_lse),
                               atol=ATOL, rtol=0)


def test_flash_adapter_matches_flash_pallas():
    """The GQA adapter in the layer layout [B,S,KH,G,D] against the
    reference's ``_flash_pallas`` (KV broadcast + interpreted kernel)."""
    B, S, KH, G, D = 2, 64, 2, 3, 16
    q = _randn((B, S, KH, G, D), 5)
    k, v = _randn((B, S, KH, D), 6), _randn((B, S, KH, D), 7)
    got = _flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=True, scale=D ** -0.5)
    want = _flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         scale=D ** -0.5, bq=32, bk=32, backend="pallas-interpret")
    assert got.shape == (B, S, KH, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# paged decode: plain version vs the reference


def _paged_inputs(seed=0):
    """Length-0 rows, lengths off the page grid, tables padded with the null
    page, pages shared out of order."""
    B, KH, G, D, P, M, N = 5, 2, 3, 16, 4, 6, 24
    lengths = np.array([0, 3, 4, 13, 24], np.int32)
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, M), np.int32)
    perm = rng.permutation(np.arange(1, N))
    for b, n in enumerate(lengths):
        used = -(-n // P)
        tables[b, :used] = perm[:used]
        perm = np.roll(perm, -used)
    q = _randn((B, KH, G, D), seed + 1)
    kp, vp = _randn((N, P, KH, D), seed + 2), _randn((N, P, KH, D), seed + 3)
    return q, kp, vp, tables, lengths


def test_paged_plain_matches_reference_oracle_and_pallas():
    q, kp, vp, tables, lengths = _paged_inputs()
    got = paged_attention_decode_torch(*(torch.from_numpy(a) for a in
                                         (q, kp, vp, tables, lengths)))
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.paged_attention_ref(*args)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_paged(*args, interpret=True)),
                               atol=ATOL, rtol=0)
    assert np.all(got.numpy()[0] == 0.0)  # idle row: exact zeros, no NaN


def test_paged_plain_ignores_table_padding():
    """Pages past ceil(len/P) never change the result."""
    q, kp, vp, tables, lengths = _paged_inputs(3)
    a = paged_attention_decode_torch(*(torch.from_numpy(x) for x in
                                       (q, kp, vp, tables, lengths)))
    padded = tables.copy()
    for b, n in enumerate(lengths):
        padded[b, -(-n // 4):] = 7
    b_ = paged_attention_decode_torch(*(torch.from_numpy(x) for x in
                                        (q, kp, vp, padded, lengths)))
    np.testing.assert_array_equal(a.numpy(), b_.numpy())


# ---------------------------------------------------------------------------
# dispatch


def test_resolution_order(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend("flash_attention", cpu) == "torch"
    assert dispatch.resolve_backend("flash_attention", cuda) == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch")
    assert dispatch.resolve_backend("paged_attention_decode", cuda) == "torch"
    assert dispatch.resolve_backend("paged_attention_decode", cuda, config="cuda") == "cuda"
    assert dispatch.resolve_backend("paged_attention_decode", cuda, backend="torch",
                                    config="cuda") == "torch"


def test_cuda_backend_on_cpu_tensor_raises(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.resolve_backend("flash_attention", torch.device("cpu"), backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.resolve_backend("flash_attention", torch.device("cpu"), backend="pallas")
    with pytest.raises(KeyError):
        dispatch.resolve_backend("coalesce_pair", torch.device("cpu"))
    assert dispatch.ops() == ("flash_attention", "paged_attention_decode")


def test_cuda_wrappers_raise_on_cpu_tensors_without_launching():
    """No fallback: a CPU tensor never reaches the plain version through the
    CUDA wrapper, and nothing is counted."""
    q, k, v = (torch.from_numpy(a) for a in _gqa_inputs(1, 8, 8, 2, 1, 64))
    before = flash_attention_cuda.launches, paged_attention_decode_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    qd, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _paged_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_decode_cuda(qd, kp, vp, tables, lengths)
    assert (flash_attention_cuda.launches, paged_attention_decode_cuda.launches) == before


def test_build_commands_target_sm90a(tmp_path):
    srcs = build.sources()
    assert {p.name for p in srcs} == {"flash_attention_fwd.cu",
                                      "paged_attention_decode.cu"}
    compiles, link = build.compile_commands("nvcc", srcs, tmp_path, tmp_path / "lib.so")
    assert len(compiles) == len(srcs)  # one nvcc per source, run in parallel
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    for cmd in compiles:
        assert {"-std=c++17", "-O3", "-fPIC"} <= set(cmd)
    assert "-shared" in link
    assert build.library_name(srcs) == build.library_name(srcs)
    assert build.library_name(srcs).startswith("libreprotorch_")
