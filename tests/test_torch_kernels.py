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
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.coalesce_pair import coalesce_pair_cuda, coalesce_pair_torch
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention_bwd_cuda,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_cuda, flash_attention_torch)
from repro_torch.kernels.interp_axpy import interp_axpy_cuda, interp_axpy_torch
from repro_torch.kernels.paged_attention import (paged_attention_decode_cuda,
                                                 paged_attention_decode_torch)
from repro_torch.layers.attention import _flash_attention
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gqa_inputs(B, S, T, H, KH, D, seed=0, Dv=None):
    """q [B,S,H,D], k [B,T,KH,D], v [B,T,KH,Dv] (the port's layout; Dv = D
    unless given)."""
    return _randn((B, S, H, D), seed), _randn((B, T, KH, D), seed + 1), \
        _randn((B, T, KH, Dv or D), seed + 2)


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


# MLA's value head dim differs from its query/key one (tiny_mla: 16 + 8, 16)
FLASH_CASES = [pytest.param(True, 64, 64, 16, id="True-64-64"),
               pytest.param(False, 32, 64, 16, id="False-32-64"),
               pytest.param(True, 64, 64, 24, id="True-64-64-Dqk24-Dv16")]


@pytest.mark.parametrize("causal,S,T,D", FLASH_CASES)
def test_flash_plain_matches_reference_oracle_and_pallas(causal, S, T, D):
    B, H, KH, Dv = 1, 4, 2, 16
    q, k, v = _gqa_inputs(B, S, T, H, KH, D, Dv=Dv)
    out, lse = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    qh, kh, vh = (jnp.asarray(a) for a in _to_heads(q, k, v, H // KH))
    want = np.asarray(jref.naive_attention(qh, kh, vh, causal=causal)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    pallas = np.asarray(jax_flash(qh, kh, vh, causal=causal, block_q=32, block_k=32,
                                  interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL, rtol=0)
    # the log-sum-exp the Pallas forward emits for its backward
    assert out.shape == (B, S, H, Dv)
    _, want_lse = _fwd_call(qh.reshape(B * H, S, D), kh.reshape(B * H, T, D),
                            vh.reshape(B * H, T, Dv), causal=causal, scale=D ** -0.5,
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


@pytest.mark.parametrize("causal,S,T,D", FLASH_CASES)
def test_flash_bwd_plain_matches_pallas_vjp(causal, S, T, D):
    """dq, dk, dv of the plain backward (and of the Function, run on the
    plain versions) against ``jax.vjp`` through the reference's Pallas
    forward and backward kernels in interpret mode (MHA: H == KH), with
    the value head dim equal to D or, as MLA's, narrower."""
    B, H, Dv = 1, 2, 16
    q, k, v = _gqa_inputs(B, S, T, H, H, D, seed=11, Dv=Dv)
    do = _randn((B, S, H, Dv), 14)
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


@pytest.mark.parametrize("M,P", [(1, 4), (6, 4), (16, 4), (12, 16), (128, 16), (40, 24),
                                 (3, 64), (7, 80)])
def test_split_plan_covers_each_position_once(M, P):
    """The kernel's splits cover every position a table row can address
    exactly once, no split lies wholly past M * P, and the plan takes the
    shapes alone (never the lengths)."""
    import inspect

    span, n_splits = pa.split_plan(M, P)
    assert list(inspect.signature(pa.split_plan).parameters) == ["M", "P"]
    hits = np.zeros(M * P, np.int64)
    for s in range(n_splits):
        hits[s * span:min((s + 1) * span, M * P)] += 1
    assert np.all(hits == 1)
    assert (n_splits - 1) * span < M * P <= n_splits * span


def test_split_span_and_index_codes_match_the_kernel_source():
    """The wrapper sizes the workspace from SPLIT_SPAN and passes INDEX_CODES;
    the kernel source must agree on both (nothing compiles it here)."""
    import re

    text = (build.CSRC / "paged_attention_decode.cu").read_text()
    assert int(re.search(r"constexpr int kSplitSpan = (\d+);", text).group(1)) == pa.SPLIT_SPAN
    m = re.search(r"enum IndexType : int \{ kInt32 = (\d+), kInt64 = (\d+) \};", text)
    assert pa.INDEX_CODES == {torch.int32: int(m.group(1)), torch.int64: int(m.group(2))}


def _split_merge(q, kp, vp, tables, lengths):
    """The kernel's algorithm in numpy: per split of ``split_plan``, (m, l,
    acc) from the table entries below ceil(len / P) only, then the splits
    merged in order."""
    B, KH, G, D = q.shape
    P, M = kp.shape[1], tables.shape[1]
    span, n_splits = pa.split_plan(M, P)
    out = np.zeros((B, KH, G, D), np.float64)
    for b in range(B):
        n = max(0, min(int(lengths[b]), M * P))
        for kh in range(KH):
            parts = []
            for s in range(n_splits):
                t = np.arange(s * span, min((s + 1) * span, n))
                if not len(t):
                    break
                pages = np.array([tables[b, i] for i in t // P])
                k = kp[pages, t % P, kh].astype(np.float64)
                v = vp[pages, t % P, kh].astype(np.float64)
                sc = q[b, kh].astype(np.float64) @ k.T * D ** -0.5
                m = sc.max(-1)
                p = np.exp(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ v))
            if parts:
                m = np.max([x[0] for x in parts], 0)
                w = [np.exp(x[0] - m) for x in parts]
                l = sum(wi * x[1] for wi, x in zip(w, parts))
                acc = sum(wi[:, None] * x[2] for wi, x in zip(w, parts))
                out[b, kh] = acc / np.maximum(l, 1e-30)[:, None]
    return out.astype(np.float32)


def test_split_merge_algorithm_matches_pallas_reference():
    """What the kernel computes, split by split and merged in order, is the
    reference's paged decode (Pallas kernel in interpret mode), with table
    padding pointed at a NaN page that no split may read."""
    B, KH, G, D, P, M = 4, 2, 8, 64, 16, 12
    lengths = np.array([0, 63, 65, 192], np.int32)
    N = 1 + M * B
    tables = np.zeros((B, M), np.int32)
    perm = np.random.default_rng(5).permutation(np.arange(1, N))
    for b, n in enumerate(lengths):
        used = -(-n // P)
        tables[b, :used], perm = perm[:used], perm[used:]
    q = _randn((B, KH, G, D), 6)
    kp, vp = _randn((N + 1, P, KH, D), 7), _randn((N + 1, P, KH, D), 8)
    kp[N] = vp[N] = np.nan
    poisoned = tables.copy()
    for b, n in enumerate(lengths):
        poisoned[b, -(-n // P):] = N
    got = _split_merge(q, kp, vp, poisoned, lengths)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
                                interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[0] == 0.0)


def _paged_cpu_args(index_dtype=torch.int64, lengths_dtype=None):
    """Inputs the kernel takes (D = 64), on the CPU."""
    B, KH, G, D, P, M, N = 3, 2, 4, 64, 4, 6, 19
    q = torch.from_numpy(_randn((B, KH, G, D), 0))
    kp, vp = (torch.from_numpy(_randn((N, P, KH, D), s)) for s in (1, 2))
    tables = torch.arange(1, B * M + 1).view(B, M).to(index_dtype)
    lengths = torch.tensor([0, 5, M * P], dtype=lengths_dtype or index_dtype)
    return q, kp, vp, tables, lengths


def _bad_paged(case):
    q, kp, vp, bt, ln = _paged_cpu_args()
    if case == "head_dim":
        q, kp, vp = q[..., :8].contiguous(), kp[..., :8].contiguous(), vp[..., :8].contiguous()
    elif case == "dtype_mix":
        kp = kp.to(torch.bfloat16)
    elif case == "float16":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif case == "float_tables":
        bt = bt.float()
    elif case == "pool_shape":
        vp = vp[:, :2].contiguous()
    elif case == "batch":
        ln = ln[:-1]
    elif case == "strided_q":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "misaligned_pool":
        kp = torch.zeros(kp.numel() + 4)[1:kp.numel() + 1].view(kp.shape)
    elif case == "misaligned_q":
        q = torch.zeros(q.numel() + 4)[1:q.numel() + 1].view(q.shape)
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("case,what", [
    ("head_dim", "head_dim 8"), ("dtype_mix", "dtypes"), ("float16", "dtypes"),
    ("float_tables", "index dtypes"), ("pool_shape", "do not agree"),
    ("batch", "for batch"), ("strided_q", "contiguous"),
    ("misaligned_pool", "16-byte boundary"), ("misaligned_q", "16-byte boundary")])
def test_paged_wrapper_refuses_before_any_build(monkeypatch, case, what):
    """Each input the kernel does not take raises a ValueError before the
    library is loaded or a launch is counted (the device check is lifted so
    that CPU tensors reach the shape, type and layout checks)."""
    monkeypatch.setattr(pa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", _no_build)
    q, kp, vp, bt, ln = _bad_paged(case)
    before = paged_attention_decode_cuda.launches
    with pytest.raises(ValueError, match=what):
        paged_attention_decode_cuda(q, kp, vp, bt, ln)
    assert paged_attention_decode_cuda.launches == before


class _FakeLib:
    """Records the arguments of the C entry point; launches nothing."""

    def __init__(self):
        self.calls = []

    def paged_attention_decode(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("index_dtype,lengths_dtype,code", [
    (torch.int64, None, 1), (torch.int32, None, 0), (torch.int32, torch.int64, 0)])
def test_paged_wrapper_passes_tables_as_they_are(monkeypatch, index_dtype, lengths_dtype,
                                                 code):
    """Tables reach the kernel as the caller holds them (int64 from the
    server: no cast), with their index code; lengths are cast only when
    their type differs from the tables'; n_splits and the workspace follow
    from the shapes alone, whatever the lengths hold."""
    import contextlib
    import types

    lib = _FakeLib()
    monkeypatch.setattr(pa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    q, kp, vp, bt, ln = _paged_cpu_args(index_dtype, lengths_dtype)
    B, KH, G, D = q.shape
    M, P = bt.shape[1], kp.shape[1]
    before = paged_attention_decode_cuda.launches
    paged_attention_decode_cuda(q, kp, vp, bt, ln)
    paged_attention_decode_cuda(q, kp, vp, bt, torch.zeros_like(ln))
    assert paged_attention_decode_cuda.launches == before + 2
    (q_p, k_p, v_p, bt_p, ln_p, idx, acc_p, ml_p, out_p, dt, *dims, scale, stream), second = \
        lib.calls
    assert bt_p == bt.data_ptr() and idx == code
    assert (ln_p == ln.data_ptr()) == (lengths_dtype is None)
    n_splits = -(-M * P // pa.SPLIT_SPAN)
    assert dims == [B, KH, G, D, P, M, n_splits] and list(second[10:17]) == dims
    assert ml_p - acc_p == 4 * B * KH * n_splits * G * D
    assert dt == pa.DTYPE_CODES[q.dtype] and scale == D ** -0.5


def test_serve_profile_counts_the_paged_bodies_as_paged_decode():
    """``scripts/profile_torch_serve.py`` files the split and the merge body
    (as the profiler names them) under paged decode, not "other"."""
    import importlib.util
    import re
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "profile_torch_serve.py"
    spec = importlib.util.spec_from_file_location("profile_torch_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = {"paged_attention_decode": [
        "void reprotorch::(anonymous namespace)::paged_decode_split_kernel<__nv_bfloat16, 64>"
        "(__nv_bfloat16 const*, __nv_bfloat16 const*)",
        "void reprotorch::(anonymous namespace)::paged_decode_merge_kernel<__nv_bfloat16>"
        "(float const*, float const*)"],
        "flash_attention_fwd": ["void reprotorch::(anonymous namespace)::flash_fwd_mma_kernel"
                                "<64>(__nv_bfloat16 const*)"]}
    for cat, kernels in names.items():
        for name in kernels:
            assert next(c for c, pat in mod.CATEGORIES if re.search(pat, name)) == cat


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


def _bf16_misaligned(shape):
    """A bf16 view of ``shape`` whose data starts 2 bytes past a 16-byte
    boundary (the allocator aligns the buffer itself)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)


def _bf16_padded_rows(shape):
    """A bf16 view of ``shape`` cut from rows 4 elements longer, so every
    stride above the last is not a multiple of 8."""
    return torch.zeros(*shape[:-1], shape[-1] + 4, dtype=torch.bfloat16)[..., :shape[-1]]


def _no_build():
    raise AssertionError("the kernel library was loaded")


@pytest.mark.parametrize("name", ["q", "k", "v"])
@pytest.mark.parametrize("make,what", [(_bf16_misaligned, "16-byte aligned"),
                                       (_bf16_padded_rows, "multiple of 8")])
def test_bf16_layout_check_raises_before_any_build(monkeypatch, name, make, what):
    """The tensor-core bodies copy 16-byte rows: a bf16 q, k or v that is
    misaligned or has odd strides raises a ValueError naming it, before the
    library is built or anything is launched (the device check is lifted so
    that CPU tensors reach the layout check)."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", _no_build)
    shapes = {"q": (2, 65, 8, 64), "k": (2, 65, 2, 64), "v": (2, 65, 2, 64)}
    args = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    args[name] = make(shapes[name])
    before = (flash_attention_cuda.launches, fa.flash_attention_bwd_dq_cuda.launches)
    with pytest.raises(ValueError, match=f"bf16 {name} .*{what}"):
        flash_attention_cuda(args["q"], args["k"], args["v"])
    out = torch.zeros(shapes["q"], dtype=torch.bfloat16)
    lse = torch.zeros((2, 8, 65))
    with pytest.raises(ValueError, match=f"bf16 {name} .*{what}"):
        fa.flash_attention_bwd_cuda(args["q"], args["k"], args["v"], out, lse, out)
    assert (flash_attention_cuda.launches, fa.flash_attention_bwd_dq_cuda.launches) == before


@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 192), (128, 64), (96, 96), (64, 128)])
def test_flash_head_dims_outside_the_built_pairs_raise_before_any_build(monkeypatch, D, Dv):
    """The kernels are built for (64, 64), (128, 128) and (192, 128) alone:
    any other (D, Dv) raises a ValueError in each wrapper before the library
    is loaded or a launch is counted; a built pair gets past the shape
    checks to the build (device check lifted, as above)."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", _no_build)
    assert fa.HEAD_DIMS == ((64, 64), (128, 128), (192, 128))

    def inputs(D, Dv):
        q, k = torch.zeros((1, 65, 4, D)), torch.zeros((1, 65, 4, D))
        v, rows = torch.zeros((1, 65, 4, Dv)), torch.zeros((1, 65, 4, Dv))
        return q, k, v, rows, torch.zeros((1, 4, 65))

    q, k, v, rows, stats = inputs(D, Dv)
    before = [w.launches for w in (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
                                   fa.flash_attention_bwd_dkv_cuda)]
    with pytest.raises(ValueError, match=f"head dims \\(D {D}, Dv {Dv}\\) unsupported"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, rows, stats, rows)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, rows, stats, stats)
    assert [w.launches for w in (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
                                 fa.flash_attention_bwd_dkv_cuda)] == before
    q, k, v, rows, stats = inputs(192, 128)
    with pytest.raises(AssertionError, match="library was loaded"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(AssertionError, match="library was loaded"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, rows, stats, stats)


def test_bf16_layout_check_covers_do_and_passes_f32(monkeypatch):
    """dk/dv checks its dO as well; f32 tensors (the scalar bodies) and
    strides of length-1 axes are not held to the 16-byte rule."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", _no_build)
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k = v = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    stats = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="bf16 do .*16-byte aligned"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, _bf16_misaligned(q.shape), stats, stats)
    f32 = torch.zeros(4 * 64 + 1)[1:].view(1, 4, 64)
    fa.check_mma_layout("op", x=f32)
    fa.check_mma_layout("op", x=torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
                        .as_strided((1, 8, 1, 64), (3, 64, 5, 1)))


@pytest.mark.parametrize("name", ["out", "do"])
def test_bf16_layout_check_covers_dq_rows(monkeypatch, name):
    """The tensor-core dq body copies 16-byte rows of out and do too: a bf16
    out or do that starts 2 bytes past a 16-byte boundary raises a
    ValueError naming it, before the library is loaded or a launch is
    counted."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(build, "load_library", _no_build)
    q = k = v = torch.zeros((1, 65, 4, 64), dtype=torch.bfloat16)
    rows = {"out": torch.zeros(q.shape, dtype=torch.bfloat16),
            "do": torch.zeros(q.shape, dtype=torch.bfloat16)}
    rows[name] = _bf16_misaligned(q.shape)
    lse = torch.zeros((1, 4, 65))
    before = fa.flash_attention_bwd_dq_cuda.launches
    with pytest.raises(ValueError, match=f"flash_attention_bwd_dq: bf16 {name} .*16-byte"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, rows["out"], lse, rows["do"])
    assert fa.flash_attention_bwd_dq_cuda.launches == before


def test_kernel_bodies_in_chip_smoke_are_the_global_functions_of_csrc():
    """``chip_smoke.KERNEL_BODIES`` (phase 1 checks that ptxas reports each)
    names exactly the ``__global__`` functions of ``csrc/*.cu``, and its
    tensor-core bodies and paged-decode bodies (which phase 1 holds to no
    spill) are among them."""
    import ast
    import re
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent.parent / "chip_smoke.py").read_text())
    consts = {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id in ("KERNEL_BODIES", "MMA_BODIES", "PAGED_BODIES")}
    text = "\n".join(p.read_text() for p in build.sources())
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                             r"(\w+)\s*\(", text))
    assert set(consts["KERNEL_BODIES"]) == defined
    assert set(consts["MMA_BODIES"]) == {"flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                                         "flash_bwd_dkv_mma_kernel"}
    assert set(consts["MMA_BODIES"]) <= defined
    assert set(consts["PAGED_BODIES"]) == {"paged_decode_split_kernel",
                                           "paged_decode_narrow_kernel",
                                           "paged_decode_merge_kernel"}
    assert set(consts["PAGED_BODIES"]) <= defined


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
