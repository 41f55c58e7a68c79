"""The port's kernel layer against the JAX reference, on the CPU.

The plain PyTorch versions of the kernels (flash-attention forward and
backward, paged decode, coalesce_pair, interp_axpy) are held to the
reference's oracles (``repro.kernels.ref``) and to its Pallas kernels run in
interpret mode; the GQA flash adapter and its gradients are held to
``repro.layers.attention._flash_pallas``.  Inputs are numpy arrays from a
seed, handed to both packages.  Tolerances: attention values and gradients
at f32 within atol 1e-5 (same math, other summation order); coalesce_pair
exactly (the same single add and power-of-two scale); interp_axpy within
1 ulp of the largest of its two products and its result (the reference's
compiler fuses into an FMA, which rounds once where the port rounds twice).

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.coalesce_pair import coalesce_pair as jax_coalesce_pair
from repro.kernels.flash_attention import _fwd_call, flash_attention_with_vjp
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.interp_axpy import interp_axpy as jax_interp_axpy
from repro.kernels.paged_attention import paged_attention_decode as jax_paged
from repro.layers.attention import _flash_pallas

from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels.coalesce_pair import coalesce_pair_cuda, coalesce_pair_torch
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention_bwd_cuda,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_cuda, flash_attention_torch)
from repro_torch.kernels.interp_axpy import interp_axpy_cuda, interp_axpy_torch
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
# flash attention backward: plain version and the autograd Function


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("causal,S,T", [(True, 64, 64), (False, 32, 64)])
def test_flash_bwd_plain_matches_pallas_vjp(causal, S, T):
    """dq, dk, dv of the plain backward (and of the Function, run on the
    plain versions) against ``jax.vjp`` through the reference's Pallas
    forward and backward kernels in interpret mode (MHA: H == KH)."""
    B, H, D = 1, 2, 16
    q, k, v = _gqa_inputs(B, S, T, H, H, D, seed=11)
    do = _randn((B, S, H, D), 14)
    qh, kh, vh = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    _, pull = jax.vjp(lambda a, b, c: flash_attention_with_vjp(
        a, b, c, causal=causal, block_q=32, block_k=32, interpret=True), qh, kh, vh)
    want = [np.asarray(g).transpose(0, 2, 1, 3)
            for g in pull(jnp.asarray(do.transpose(0, 2, 1, 3)))]
    out, lse = flash_attention_torch(_t(q), _t(k), _t(v), causal=causal)
    got = flash_attention_bwd_torch(_t(q), _t(k), _t(v), out, lse, _t(do), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = dispatch.flash_attention(tq, tk, tv, causal=causal, backend="torch")
    o.backward(_t(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_flash_adapter_gradients_match_flash_pallas():
    """GQA (KH = 2, G = 3): the layer adapter's gradients, with dk/dv summed
    over the groups inside the backward, against the gradients of the
    reference's ``_flash_pallas`` (KV broadcast, interpreted kernels)."""
    B, S, KH, G, D = 1, 64, 2, 3, 16
    q = _randn((B, S, KH, G, D), 21)
    k, v = _randn((B, S, KH, D), 22), _randn((B, S, KH, D), 23)
    do = _randn((B, S, KH, G, D), 24)
    _, pull = jax.vjp(lambda a, b, c: _flash_pallas(
        a, b, c, causal=True, scale=D ** -0.5, bq=32, bk=32,
        backend="pallas-interpret"), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = pull(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    _flash_attention(tq, tk, tv, causal=True, scale=D ** -0.5).backward(_t(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradcheck_f64(causal):
    """``torch.autograd.gradcheck`` of the Function in f64 (GQA, ragged)."""
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 8))).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 7, 2, 8))).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((1, 7, 2, 8))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b, c: dispatch.flash_attention(a, b, c, causal=causal, backend="torch"),
        (q, k, v))


def test_flash_function_saves_and_reuses_one_forward():
    """The Function's backward is the backend's backward on the saved
    (q, k, v, out, lse); the forward runs once per apply."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return flash_attention_torch(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return flash_attention_bwd_torch(*a, **kw)

    q, k, v = (_t(a, True) for a in _gqa_inputs(1, 16, 16, 2, 1, 8, seed=41))
    FlashAttention.apply(q, k, v, True, 8 ** -0.5, fwd, bwd).sum().backward()
    assert calls == {"fwd": 1, "bwd": 1} and q.grad is not None and k.grad is not None


# ---------------------------------------------------------------------------
# coalesce_pair and interp_axpy: plain versions vs the reference


COALESCE_CASES = [((8, 6), 0), ((8, 6), 1), ((10, 7), 0), ((7, 10), 1), ((2, 1), 0),
                  ((1, 2), 1), ((6, 13), 0), ((26, 3), 0), ((3, 26), 1)]


@pytest.mark.parametrize("w0", [0.5, 1.0])
@pytest.mark.parametrize("shape,axis", COALESCE_CASES)
def test_coalesce_pair_plain_matches_reference(shape, axis, w0):
    """Exactly equal to the reference's interpreted Pallas kernel (called
    directly, so the odd and prime shapes the reference's dispatch sends to
    XLA take the kernel too), its dense-F oracle and the port's oracle."""
    w = _randn(shape, 51)
    got = coalesce_pair_torch(torch.from_numpy(w), axis=axis, w0=w0).numpy()
    pallas = jax_coalesce_pair(jnp.asarray(w), axis=axis, w0=w0, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(
        got, np.asarray(jref.coalesce_pair_ref(jnp.asarray(w), axis=axis, w0=w0)))
    np.testing.assert_array_equal(
        got, ref.coalesce_pair_ref(torch.from_numpy(w), axis=axis, w0=w0).numpy())


def test_coalesce_pair_rejects_odd_axis():
    with pytest.raises(ValueError, match="must be even"):
        coalesce_pair_torch(torch.zeros(7, 4), axis=0)
    with pytest.raises(ValueError, match="2D"):
        coalesce_pair_torch(torch.zeros(4, 4, 4), axis=0)


@pytest.mark.parametrize("shape", [(1,), (1023,), (1025,), (3, 5, 7), (64, 48)])
def test_interp_axpy_plain_matches_reference(shape):
    a, b = _randn(shape, 61), _randn(shape, 62)
    got = interp_axpy_torch(torch.from_numpy(a), torch.from_numpy(b), 0.25).numpy()
    pallas = np.asarray(jax_interp_axpy(jnp.asarray(a), jnp.asarray(b), 0.25,
                                        interpret=True))
    oracle = np.asarray(jref.interp_axpy_ref(jnp.asarray(a), jnp.asarray(b), 0.25))
    assert got.shape == shape
    # one rounding apart: within 1 ulp of the largest of the two products and
    # the result (where the terms cancel, that is many ulps of the result)
    tol = np.spacing(np.maximum.reduce([np.abs(0.75 * a), np.abs(0.25 * b),
                                        np.abs(oracle)]).astype(np.float32))
    assert np.all(np.abs(got - pallas) <= tol) and np.all(np.abs(got - oracle) <= tol)


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
        dispatch.resolve_backend("no_such_op", torch.device("cpu"))
    assert dispatch.ops() == ("coalesce_pair", "flash_attention", "flash_attention_bwd",
                              "interp_axpy", "paged_attention_decode")


def test_cuda_wrappers_raise_on_cpu_tensors_without_launching():
    """No fallback: a CPU tensor never reaches the plain version through the
    CUDA wrapper, and nothing is counted."""
    wrappers = (flash_attention_cuda, paged_attention_decode_cuda, coalesce_pair_cuda,
                interp_axpy_cuda)
    q, k, v = (torch.from_numpy(a) for a in _gqa_inputs(1, 8, 8, 2, 1, 64))
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    out, lse = flash_attention_torch(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, out, lse, out)
    qd, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _paged_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_decode_cuda(qd, kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        coalesce_pair_cuda(torch.zeros(4, 4), axis=0)
    with pytest.raises(ValueError, match="CUDA"):
        interp_axpy_cuda(torch.zeros(4), torch.zeros(4), 0.5)
    assert [w.launches for w in wrappers] == before


def test_c_entry_points_match_their_ctypes_signatures():
    """Every entry point in ``build.SIGNATURES`` is an ``extern "C"``
    function of ``csrc/`` with as many parameters, pointers where ctypes
    passes pointers (nothing compiles the sources here)."""
    import re

    text = "\n".join(p.read_text() for p in build.sources())
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (name, params)
        for p, t in zip(params, argtypes):
            is_ptr = "*" in p
            assert is_ptr == (t is build._P), (name, p, t)
            if not is_ptr:
                want = {build._I: "int ", build._L: "long long ", build._F: "float "}[t]
                assert p.startswith(want), (name, p, t)


def test_raw_flash_wrapper_refuses_autograd():
    """Called directly where autograd records, the raw kernel wrapper would
    hand back an output with no gradient: it raises instead."""
    q, k, v = (torch.from_numpy(a) for a in _gqa_inputs(1, 8, 8, 2, 1, 64))
    with pytest.raises(RuntimeError, match="records no gradient"):
        flash_attention_cuda(q.requires_grad_(), k, v)


def test_build_commands_target_sm90a(tmp_path):
    srcs = build.sources()
    assert {p.name for p in srcs} == {"flash_attention_fwd.cu", "flash_attention_bwd.cu",
                                      "paged_attention_decode.cu", "coalesce_pair.cu",
                                      "interp_axpy.cu"}
    assert set(build.SIGNATURES) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv", "paged_attention_decode",
                                     "coalesce_pair", "interp_axpy"}
    compiles, link = build.compile_commands("nvcc", srcs, tmp_path, tmp_path / "lib.so")
    assert len(compiles) == len(srcs)  # one nvcc per source, run in parallel
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    for cmd in compiles:
        assert {"-std=c++17", "-O3", "-fPIC"} <= set(cmd)
    assert "-shared" in link
    assert build.library_name(srcs) == build.library_name(srcs)
    assert build.library_name(srcs).startswith("libreprotorch_")
