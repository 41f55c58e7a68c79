"""Projection-matrix builders for the three operators (paper Eqs. 1-12, App. E).
A copy of ``repro/core/projections.py`` (numpy only).

Width:  F_out in R^{n x m} (full column rank).  Variants:
          "stack": pairs (i, i+m)   -- the paper's main choice, Eq. 15
          "adj":   pairs (2i, 2i+1) -- Eq. 17
        Derived (Algorithm 2/3 "Preparation", the appendix fixes the Eq. 2/9
        transposition typos):
          F_in  = F_out^T diag(1/colsum(F_out F_out^T))          [m,n]
          T_out = F_out^T diag(1/colsum(F_out F_out^T)) (= F_in) [m,n]
          T_in  = diag(1/rowsum(F_in^T F_in)) F_in^T             [n,m]

Depth:  R in R^{L x L2}.  Variants:
          "adj":   merge adjacent layers (2i, 2i+1)  -- Eq. 16
          "stack": inverse of progressive stacking (i, i+L2) -- Eq. 18
        G = R^T diag(1/colsum(R R^T))  [L2, L]

Invariants (tested): T_out F_out = I, F_in T_in = I, colsum(R G) = 1, and for
the averaging matrices C(D(w)) == w exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np

MAT_FIELDS = ("F_out", "F_in", "T_out", "T_in")


@dataclasses.dataclass(frozen=True)
class WidthMats:
    F_out: np.ndarray  # [n, m]
    F_in: np.ndarray  # [m, n]
    T_out: np.ndarray  # [m, n]
    T_in: np.ndarray  # [n, m]
    # which pair structure generated F_out ("stack" | "adj" | None).  "stack"
    # marks the matrices whose contraction is exactly the matrix-free
    # coalesce_pair / duplication kernels (core/operators.py fused path);
    # None (e.g. block_diag_width, hand-built F) keeps the dense-matrix path.
    variant: Optional[str] = None


def pair_merge_matrix(n: int, m: int, variant: str) -> np.ndarray:
    """F_out [n, m].  Requires n == 2m (even halving) for both variants."""
    if n != 2 * m:
        raise ValueError(f"width coalescing needs n == 2m, got n={n} m={m}")
    F = np.zeros((n, m), np.float64)
    idx = np.arange(m)
    if variant == "stack":
        F[idx, idx] = 0.5
        F[idx + m, idx] = 0.5
    elif variant == "adj":
        F[2 * idx, idx] = 0.5
        F[2 * idx + 1, idx] = 0.5
    else:
        raise ValueError(variant)
    return F


def derive_width(F_out: np.ndarray, variant: Optional[str] = None) -> WidthMats:
    """Apply the paper's normalization formulas to an arbitrary full-column-rank
    F_out (works for non-averaging choices too).

    colsum(F_out F_out^T) is taken as F_out (F_out^T 1) and rowsum(F_in^T
    F_in) as F_in^T (F_in 1): the same sums without the two n x n products
    (O(n^2 m) each: minutes on the host at DeepSeek-V3's d_ff 18432).  For
    the averaging matrices every term is a small dyadic fraction, so both
    orders give the reference's bits."""
    col = F_out @ F_out.sum(axis=0)  # colsum(F_out F_out^T) -> [n]
    F_in = F_out.T * (1.0 / np.where(col == 0, 1.0, col))[None, :]  # [m,n]
    T_out = F_in.copy()
    row = F_in.T @ F_in.sum(axis=1)  # rowsum(F_in^T F_in) -> [n]
    T_in = (1.0 / np.where(row == 0, 1.0, row))[:, None] * F_in.T  # [n,m]
    return WidthMats(F_out=F_out, F_in=F_in, T_out=T_out, T_in=T_in,
                     variant=variant)


class LazyWidthMats:
    """Width matrices built on their first read, then kept: the fused
    transitions run "stack" axes through ``coalesce_pair`` and duplication
    and never read their dense n x n/2 maps (four of them, f64: 9.7 GB on the
    host at Jamba-1.5-Large's d_ff 24576), and a model without an MTP head
    never reads ``embed_cat2``'s.  ``variant`` is known without a build."""

    def __init__(self, build: Callable[[], WidthMats], variant: Optional[str]):
        self._build, self._mats, self.variant = build, None, variant

    def built(self) -> WidthMats:
        if self._mats is None:
            self._mats = self._build()
        return self._mats

    F_out = property(lambda self: self.built().F_out)
    F_in = property(lambda self: self.built().F_in)
    T_out = property(lambda self: self.built().T_out)
    T_in = property(lambda self: self.built().T_in)


@functools.lru_cache(maxsize=16)
def width_mats(n: int, variant: str = "stack") -> LazyWidthMats:
    """The pair-merge maps of an axis of size ``n``, one object per (n,
    variant), shared (no caller writes them): a V-cycle's transitions, their
    replays and the draft projection all ask for the same ones.  The
    matrices are built on their first read (``LazyWidthMats``)."""
    return LazyWidthMats(lambda: derive_width(pair_merge_matrix(n, n // 2, variant), variant),
                         variant)


def block_diag_width(mats: WidthMats, blocks: int) -> LazyWidthMats:
    """Width matrices for a concatenation of ``blocks`` copies of the same axis
    (e.g. the MTP projection input [h_t ; emb_{t+1}] of size 2*d_model),
    built on their first read."""

    def bd(a: np.ndarray) -> np.ndarray:
        out = np.zeros((a.shape[0] * blocks, a.shape[1] * blocks), a.dtype)
        for b in range(blocks):
            out[b * a.shape[0]:(b + 1) * a.shape[0], b * a.shape[1]:(b + 1) * a.shape[1]] = a
        return out

    return LazyWidthMats(lambda: WidthMats(F_out=bd(mats.F_out), F_in=bd(mats.F_in),
                                           T_out=bd(mats.T_out), T_in=bd(mats.T_in)), None)


@dataclasses.dataclass(frozen=True)
class DepthMats:
    R: np.ndarray  # [L, L2]
    G: np.ndarray  # [L2, L]


def depth_merge_matrix(L: int, variant: str = "adj") -> np.ndarray:
    """R [L, ceil(L/2)].  Odd L: the last layer maps alone with weight 1."""
    L2 = (L + 1) // 2
    R = np.zeros((L, L2), np.float64)
    if variant == "adj":
        for j in range(L2):
            lo = 2 * j
            if lo + 1 < L:
                R[lo, j] = 0.5
                R[lo + 1, j] = 0.5
            else:
                R[lo, j] = 1.0
    elif variant == "stack":
        half = L2
        for j in range(L2):
            if j + half < L:
                R[j, j] = 0.5
                R[j + half, j] = 0.5
            else:
                R[j, j] = 1.0
    else:
        raise ValueError(variant)
    return R


def derive_depth(R: np.ndarray) -> DepthMats:
    RRt = R @ R.T
    col = RRt.sum(axis=0)
    G = R.T * (1.0 / np.where(col == 0, 1.0, col))[None, :]
    return DepthMats(R=R, G=G)


def depth_mats(L: int, variant: str = "adj") -> DepthMats:
    return derive_depth(depth_merge_matrix(L, variant))
