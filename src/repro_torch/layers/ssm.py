"""Recurrent mixers: Mamba (selective SSM, Jamba-style) and xLSTM (mLSTM,
sLSTM) -- the counterpart of ``repro/layers/ssm.py``.

The reference scans time with ``lax.scan``; here a Python loop walks it,
one small set of ops per step (no kernel of the reference lies on these
layers).  Hidden projections are head-structured ([..., heads, head_sub])
so whole heads coalesce; the state-transition axes (d_state, conv taps,
per-head memories) are protected from width coalescing.

Cast points follow the reference: recurrent states in f32 (in f64 when the
compute dtype is f64, ``wide_dtype``); q/k/v, the gates' inputs and the
outputs in the compute dtype; ``k`` scaled by dh^-0.5 in the
compute dtype.  Maxima are ``torch.maximum`` with a tensor: on a tie it
splits the gradient in halves as ``jnp.maximum`` does (``clamp_min`` would
give all of it to one side), and the sLSTM's first step ties at
``max(n, 1)`` in every element.

On a "model" axis (``distributed/tensor_parallel.py``) each process holds a
block of Mamba's inner channels (``mamba_inner``) or of the xLSTM's heads,
as the reference's rules split them: the input enters the split region
through ``enter_split``, the input projections are column-parallel, the
conv, the gates and each channel's or head's recurrence stay local, and the
output projection is row-parallel, followed by one sum.  Mamba's ``B``,
``C`` and low-rank ``dt`` contract over the split channels: one sum of
their concatenation, which re-enters the split region (every block of
channels reads it).  The collectives run outside the per-chunk
checkpoints of :func:`chunked_scan`, so a chunk's recomputation runs none.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import cost
from repro_torch.layers.basic import wide_dtype
from repro_torch.param import Spec

Tensors = Tuple[torch.Tensor, ...]


def _scan(step: Callable, carry, xs: Tensors):
    """``lax.scan`` over the leading (time) axis of ``xs``: returns (the last
    carry, the per-step outputs stacked on a new leading axis).  On meta
    tensors (the dry run), where no value differs between steps, one step
    stands for all of them: its forward and backward ops count once per
    step (``kernels/cost.py::repeated``)."""
    S = xs[0].shape[0]
    if S > 1 and xs[0].device.type == "meta":
        return cost.repeated(lambda c, *p: _scan(step, c, p), carry,
                             tuple(x.narrow(0, 0, 1) for x in xs), S)
    ys = []
    for xs_t in zip(*(x.unbind(0) for x in xs)):
        carry, y = step(carry, xs_t)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step: Callable, init, xs: Tensors, chunk: int):
    """:func:`_scan` with per-chunk rematerialization: when ``chunk > 1``,
    ``S > chunk`` and ``S % chunk == 0``, each chunk of time steps runs under
    ``torch.utils.checkpoint``, so the backward keeps only the chunk-boundary
    states and recomputes the steps inside a chunk.  Otherwise a plain loop,
    as the reference falls back.  Without autograd the chunks run plainly
    (the values are the same)."""
    S = xs[0].shape[0]
    if chunk <= 1 or S <= chunk or S % chunk:
        return _scan(step, init, xs)
    if xs[0].device.type == "meta":  # one chunk stands for all (see _scan)
        run = (lambda c, *p: checkpoint(_scan, step, c, p, use_reentrant=False)) \
            if torch.is_grad_enabled() else (lambda c, *p: _scan(step, c, p))
        return cost.repeated(run, init, tuple(x.narrow(0, 0, chunk) for x in xs), S // chunk)
    carry, ys = init, []
    for c0 in range(0, S, chunk):
        part = tuple(x[c0:c0 + chunk] for x in xs)
        if torch.is_grad_enabled():
            carry, y = checkpoint(_scan, step, carry, part, use_reentrant=False)
        else:
            carry, y = _scan(step, carry, part)
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# Mamba (selective SSM)


def mamba_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dk, dtr = cfg.mamba_d_conv, cfg.resolved_dt_rank
    return {
        "w_in_x": Spec((E, di), ("embed", "mamba_inner"), ("in", "out"), init="fan_in"),
        "w_in_z": Spec((E, di), ("embed", "mamba_inner"), ("in", "out"), init="fan_in"),
        "conv_w": Spec((dk, di), ("conv_k", "mamba_inner"), ("-", "out"), init="normal",
                       scale=0.1),
        "conv_b": Spec((di,), ("mamba_inner",), ("out",), init="zeros"),
        "w_B": Spec((di, ds), ("mamba_inner", "mamba_state"), ("in", "-"), init="fan_in"),
        "w_C": Spec((di, ds), ("mamba_inner", "mamba_state"), ("in", "-"), init="fan_in"),
        "w_dt": Spec((di, dtr), ("mamba_inner", "dt_rank"), ("in", "out"), init="fan_in"),
        "dt_proj": Spec((dtr, di), ("dt_rank", "mamba_inner"), ("in", "out"), init="fan_in"),
        "dt_bias": Spec((di,), ("mamba_inner",), ("out",), init="mamba_dt"),
        "A_log": Spec((di, ds), ("mamba_inner", "mamba_state"), ("out", "-"), init="mamba_A"),
        "D": Spec((di,), ("mamba_inner",), ("out",), init="ones"),
        "w_out": Spec((di, E), ("mamba_inner", "embed"), ("in", "out"), init="fan_in"),
    }


def mamba_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, Spec]:
    """The conv tail (the last d_conv - 1 inputs, compute dtype) and the SSM
    state h (f32; f64 at an f64 compute dtype)."""
    di, ds, dk = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": Spec((batch, dk - 1, di), ("batch", "conv_k", "act_mamba"), init="zeros",
                     dtype=cfg.compute_dtype),
        "h": Spec((batch, di, ds), ("batch", "act_mamba", "mamba_state"), init="zeros",
                  dtype=wide_dtype(cfg.compute_dtype)),
    }


def _mamba_inner(p: Dict, x_c: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_c: [B,S,di] post-conv activations.  Returns (y [B,S,di], h_last).

    The discretized (dA, dBx) are computed per chunk of time steps, and the
    y_t = <h_t, C_t> contraction once per chunk, as in the reference: the
    checkpointed chunk keeps [B, chunk, di, ds] residuals, never
    [B, S, di, ds]."""
    B, S, di = x_c.shape
    cdt, wt = cfg.compute_dtype, wide_dtype(cfg.compute_dtype)
    A = -torch.exp(p["A_log"].to(wt))  # [di,ds]
    B_ = torch.einsum("bsd,dn->bsn", x_c, p["w_B"].to(cdt))
    C_ = torch.einsum("bsd,dn->bsn", x_c, p["w_C"].to(cdt))
    dt = torch.einsum("bsd,dr->bsr", x_c, p["w_dt"].to(cdt))
    if tp.is_split(di, cfg.mamba_d_inner):  # partial sums over this block of channels
        ds = B_.shape[-1]
        both = tp.enter_split(tp.all_reduce_sum(torch.cat([B_, C_, dt], dim=-1)))
        B_, C_, dt = both[..., :ds], both[..., ds:2 * ds], both[..., 2 * ds:]
    dt = torch.einsum("bsr,rd->bsd", dt, p["dt_proj"].to(cdt)) + p["dt_bias"].to(cdt)
    dt = F.softplus(dt.to(wt))  # [B,S,di]

    def step(h, xs):
        dA_t, dBx_t = xs  # [B,di,ds] each
        h = dA_t * h + dBx_t
        return h, h

    def run_chunk(h, xc, dtc, Bc, Cc):  # [B,c,...]
        dA = torch.exp(dtc[..., None] * A)  # [B,c,di,ds]
        dBx = (dtc * xc.to(wt))[..., None] * Bc.to(wt)[:, :, None, :]
        h, hs = _scan(step, h, (dA.transpose(0, 1), dBx.transpose(0, 1)))
        yc = torch.einsum("tbdn,btn->tbd", hs, Cc.to(wt))  # [c,B,di]
        return h, yc.to(cdt)

    c = cfg.ssm_chunk
    if c > 1 and S > c and S % c == 0 and x_c.device.type == "meta":
        # one chunk stands for all (see _scan)
        run = (lambda h, *p: checkpoint(run_chunk, h, *p, use_reentrant=False)) \
            if torch.is_grad_enabled() else run_chunk
        h, y = cost.repeated(run, h0, tuple(a.narrow(1, 0, c) for a in (x_c, dt, B_, C_)),
                             S // c)
    elif c > 1 and S > c and S % c == 0:
        h, ys = h0, []
        for c0 in range(0, S, c):
            part = tuple(a[:, c0:c0 + c] for a in (x_c, dt, B_, C_))
            if torch.is_grad_enabled():
                h, yc = checkpoint(run_chunk, h, *part, use_reentrant=False)
            else:
                h, yc = run_chunk(h, *part)
            ys.append(yc)
        y = torch.cat(ys)  # [S,B,di], chunk-major: time order
    else:
        h, y = run_chunk(h0, x_c, dt, B_, C_)
    y = y.transpose(0, 1)  # [B,S,di]
    y = y + p["D"].to(cdt) * x_c
    y = y * F.silu(z)
    return y, h


def mamba_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Dict] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Train/prefill over [B,S,E] (``cache`` None; ``return_state``: also the
    conv tail and the final state), or one decode token against ``cache``
    (returns the advanced state)."""
    di, ds, dk = p["w_in_x"].shape[-1], cfg.mamba_d_state, cfg.mamba_d_conv
    cdt = cfg.compute_dtype
    split = tp.is_split(di, cfg.mamba_d_inner)
    if split:  # the replicated stream enters this block of channels
        x = tp.enter_split(x)
    x_in = torch.einsum("bse,ed->bsd", x, p["w_in_x"].to(cdt))
    z = torch.einsum("bse,ed->bsd", x, p["w_in_z"].to(cdt))
    cw = p["conv_w"].to(cdt)  # [dk, di]

    if cache is None:
        # causal depthwise conv over the sequence: a cross-correlation, as
        # the reference's conv_general_dilated (taps not flipped)
        xp = F.pad(x_in, (0, 0, dk - 1, 0))
        x_c = F.conv1d(xp.transpose(1, 2), cw.t()[:, None, :], groups=di).transpose(1, 2)
        x_c = F.silu(x_c + p["conv_b"].to(cdt))
        h0 = torch.zeros((x.shape[0], di, ds), dtype=wide_dtype(cdt), device=x.device)
        y, h_last = _mamba_inner(p, x_c, z, cfg, h0)
        new_cache = None
        if return_state:  # prefill: conv tail + final SSM state
            new_cache = {"conv": xp[:, xp.shape[1] - (dk - 1):, :], "h": h_last}
    else:
        # single-token decode: rolling conv window + one state update
        window = torch.cat([cache["conv"].to(cdt), x_in], dim=1)  # [B,dk,di]
        x_c = torch.einsum("bkd,kd->bd", window, cw)[:, None, :]
        x_c = F.silu(x_c + p["conv_b"].to(cdt))
        y, h_last = _mamba_inner(p, x_c, z, cfg, cache["h"].to(wide_dtype(cdt)))
        new_cache = {"conv": window[:, 1:, :], "h": h_last}

    out = torch.einsum("bsd,de->bse", y, p["w_out"].to(cdt))
    if split:
        out = tp.all_reduce_sum(out)
    return out, new_cache


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory with recurrence)


def _xlstm_dims(cfg: ModelConfig, kind: str) -> Tuple[int, int]:
    NH = cfg.n_heads
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model) if kind == "mlstm" else cfg.d_model
    return NH, d_in // NH


def mlstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E = cfg.d_model
    NH, dh = _xlstm_dims(cfg, "mlstm")
    hax = "xlstm_head"
    return {
        "w_up": Spec((E, NH, dh), ("embed", "heads", hax), ("in", "out", "-"), init="fan_in"),
        "w_z": Spec((E, NH, dh), ("embed", "heads", hax), ("in", "out", "-"), init="fan_in"),
        "wq": Spec((NH, dh, dh), ("heads", hax, hax), ("out", "-", "-"), init="fan_in"),
        "wk": Spec((NH, dh, dh), ("heads", hax, hax), ("out", "-", "-"), init="fan_in"),
        "wv": Spec((NH, dh, dh), ("heads", hax, hax), ("out", "-", "-"), init="fan_in"),
        "w_i": Spec((NH, dh), ("heads", hax), ("out", "-"), init="normal", scale=0.02),
        "w_f": Spec((NH, dh), ("heads", hax), ("out", "-"), init="normal", scale=0.02),
        "b_i": Spec((NH,), ("heads",), ("out",), init="zeros"),
        "b_f": Spec((NH,), ("heads",), ("out",), init="ones"),  # bias toward remembering
        "w_down": Spec((NH, dh, E), ("heads", hax, "embed"), ("in", "-", "out"),
                       init="fan_in"),
    }


def mlstm_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, Spec]:
    NH, dh = _xlstm_dims(cfg, "mlstm")
    wt = wide_dtype(cfg.compute_dtype)
    return {
        "C": Spec((batch, NH, dh, dh), ("batch", "act_xlstm", "xlstm_head", "xlstm_head"),
                  init="zeros", dtype=wt),
        "n": Spec((batch, NH, dh), ("batch", "act_xlstm", "xlstm_head"), init="zeros",
                  dtype=wt),
        "m": Spec((batch, NH), ("batch", "act_xlstm"), init="zeros", dtype=wt),
    }


def mlstm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Dict] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, E = x.shape
    _, dh = _xlstm_dims(cfg, "mlstm")
    NH = p["wq"].shape[0]  # this process's heads
    split = tp.is_split(NH, cfg.n_heads)
    if split:
        x = tp.enter_split(x)
    cdt, wt = cfg.compute_dtype, wide_dtype(cfg.compute_dtype)
    xi = torch.einsum("bse,ehd->bshd", x, p["w_up"].to(cdt))  # [B,S,NH,dh]
    z = torch.einsum("bse,ehd->bshd", x, p["w_z"].to(cdt))
    q = torch.einsum("bshd,hdk->bshk", xi, p["wq"].to(cdt))
    k = torch.einsum("bshd,hdk->bshk", xi, p["wk"].to(cdt)) * (dh ** -0.5)
    v = torch.einsum("bshd,hdk->bshk", xi, p["wv"].to(cdt))
    ig = torch.einsum("bshd,hd->bsh", xi, p["w_i"].to(cdt)).to(wt) + p["b_i"].to(wt)
    fg = torch.einsum("bshd,hd->bsh", xi, p["w_f"].to(cdt)).to(wt) + p["b_f"].to(wt)
    log_f = F.logsigmoid(fg)  # stabilized exponential gating

    if cache is None:
        C0 = torch.zeros((B, NH, dh, dh), dtype=wt, device=x.device)
        n0 = torch.zeros((B, NH, dh), dtype=wt, device=x.device)
        m0 = torch.full((B, NH), -1e30, dtype=wt, device=x.device)
    else:
        C0, n0, m0 = (cache[key].to(wt) for key in ("C", "n", "m"))
    one = torch.ones((), dtype=wt, device=x.device)

    def step(carry, xs):
        C, n, m = carry
        qf, kf, vf, it, lft = xs  # q, k, v already in f32
        lm = lft + m
        m_new = torch.maximum(lm, it)
        i_p = torch.exp(it - m_new)[..., None]  # [B,NH,1]
        f_p = torch.exp(lm - m_new)[..., None]
        C = f_p[..., None] * C + i_p[..., None] * (vf[..., :, None] * kf[..., None, :])
        n = f_p * n + i_p * kf
        num = torch.einsum("bhvk,bhk->bhv", C, qf)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(), one)[..., None]
        return (C, n, m_new), num / den

    # the per-step casts hoisted out of the loop (the same values, fewer ops)
    xs = tuple(a.transpose(0, 1) for a in (q.to(wt), k.to(wt), v.to(wt), ig, log_f))
    (C, n, m), hs = chunked_scan(step, (C0, n0, m0), xs, cfg.ssm_chunk)
    h = hs.to(cdt).transpose(0, 1) * F.silu(z)  # [B,S,NH,dh]
    y = torch.einsum("bshd,hde->bse", h, p["w_down"].to(cdt))
    if split:
        y = tp.all_reduce_sum(y)
    new_cache = {"C": C, "n": n, "m": m} if (cache is not None or return_state) else None
    return y, new_cache


SLSTM_GATES = ("z", "i", "f", "o")


def slstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E = cfg.d_model
    NH, dh = _xlstm_dims(cfg, "slstm")
    hax = "slstm_head"
    s = {}
    for g in SLSTM_GATES:
        s[f"w_{g}"] = Spec((E, NH, dh), ("embed", "heads", hax), ("in", "out", "-"),
                           init="fan_in")
        s[f"r_{g}"] = Spec((NH, dh, dh), ("heads", hax, hax), ("out", "-", "-"), init="fan_in")
        s[f"b_{g}"] = Spec((NH, dh), ("heads", hax), ("out", "-"),
                           init="ones" if g == "f" else "zeros")
    s["w_down"] = Spec((NH, dh, E), ("heads", hax, "embed"), ("in", "-", "out"), init="fan_in")
    return s


def slstm_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, Spec]:
    NH, dh = _xlstm_dims(cfg, "slstm")
    ax = ("batch", "act_xlstm", "slstm_head")
    return {key: Spec((batch, NH, dh), ax, init="zeros", dtype=wide_dtype(cfg.compute_dtype))
            for key in ("c", "n", "h", "m")}


def slstm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Dict] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, E = x.shape
    _, dh = _xlstm_dims(cfg, "slstm")
    NH = p["r_z"].shape[0]  # this process's heads
    split = tp.is_split(NH, cfg.n_heads)
    if split:
        x = tp.enter_split(x)
    cdt, wt = cfg.compute_dtype, wide_dtype(cfg.compute_dtype)
    pre = [torch.einsum("bse,ehd->bshd", x, p[f"w_{g}"].to(cdt)) for g in SLSTM_GATES]

    if cache is None:
        c0, n0, h0 = (torch.zeros((B, NH, dh), dtype=wt, device=x.device) for _ in range(3))
        m0 = torch.full((B, NH, dh), -1e30, dtype=wt, device=x.device)
    else:
        c0, n0, h0, m0 = (cache[key].to(wt) for key in ("c", "n", "h", "m"))
    r = {g: p[f"r_{g}"].to(wt) for g in SLSTM_GATES}
    b = {g: p[f"b_{g}"].to(wt) for g in SLSTM_GATES}
    one = torch.ones((), dtype=wt, device=x.device)

    def step(carry, xs):
        c, n, h, m = carry
        zx, ix, fx, ox = xs  # already in f32

        def rec(g, inp):
            return inp + torch.einsum("bhd,hdk->bhk", h, r[g]) + b[g]

        zt = torch.tanh(rec("z", zx))
        it = rec("i", ix)
        ft = rec("f", fx)
        ot = torch.sigmoid(rec("o", ox))
        lm = F.logsigmoid(ft) + m
        m_new = torch.maximum(lm, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lm - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h_new = ot * c / torch.maximum(n, one)
        return (c, n, h_new, m_new), h_new

    xs = tuple(a.to(wt).transpose(0, 1) for a in pre)
    (c, n, h, m), hs = chunked_scan(step, (c0, n0, h0, m0), xs, cfg.ssm_chunk)
    y = torch.einsum("bshd,hde->bse", hs.to(cdt).transpose(0, 1), p["w_down"].to(cdt))
    if split:
        y = tp.all_reduce_sum(y)
    new_cache = ({"c": c, "n": n, "h": h, "m": m}
                 if (cache is not None or return_state) else None)
    return y, new_cache


MIXERS = {"mamba": (mamba_specs, mamba_cache_specs, mamba_apply),
          "mlstm": (mlstm_specs, mlstm_cache_specs, mlstm_apply),
          "slstm": (slstm_specs, slstm_cache_specs, slstm_apply)}
