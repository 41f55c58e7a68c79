"""The kernels' recorded costs: where a kernel's launch (on the card) or its
meta form (on the meta device) reports the work it does to whoever counts
(``launch/op_cost.py``).  A kernel is no aten op, so a dispatch mode cannot
see it; each wrapper calls :func:`record` with its module's ``*_cost``
figures instead.  Nothing is recorded while no recorder is active.

Also the multiplier of repeated work (:func:`repeated`): on meta tensors a
recurrent mixer's time loop runs one chunk of one step for all of them
(``layers/ssm.py``), and its forward and backward ops count once per chunk
and step."""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

import torch

_RECORDERS: List[Callable[[str, float, float, int], None]] = []


def active() -> bool:
    return bool(_RECORDERS)


def record(name: str, flops: float, nbytes: float) -> None:
    """Report one launch of kernel ``name`` doing ``flops`` operations and
    moving ``nbytes`` bytes to the innermost recorder (as ``multiplier()``
    launches inside :func:`_repeat`)."""
    if _RECORDERS:
        _RECORDERS[-1](name, float(flops), float(nbytes), multiplier())


@contextlib.contextmanager
def recording(fn: Callable[[str, float, float, int], None]):
    """Inside, :func:`record` calls ``fn(name, flops, nbytes, launches)``."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)


# ---------------------------------------------------------------------------
# repeated work: one run standing for n (a recurrent time loop on meta tensors)

_MULT: List[int] = [1]


def multiplier() -> int:
    """How many times each op counted now stands for (1 outside
    :func:`_repeat`)."""
    return _MULT[-1]


@contextlib.contextmanager
def _repeat(n: int):
    """Inside, every op a counter sees, and every kernel cost recorded,
    counts ``n`` times (nested regions multiply: a chunk of steps repeated
    for every chunk)."""
    _MULT.append(_MULT[-1] * n)
    try:
        yield
    finally:
        _MULT.pop()


class _Mark(torch.autograd.Function):
    """Identity on tensors that bound a repeated region in the autograd
    graph: the backward of its outputs' mark (the region's end) multiplies
    the counted ops that follow by ``n``; the backward of its inputs' mark
    (the region's start) ends that.  The engine runs a region's backward
    between the two, as its nodes were made between them.  The end mark
    holds a tensor and reads it before it multiplies, so that where the
    region lies in a checkpointed function, the recomputation that reading
    it starts counts as the forward did."""

    @staticmethod
    def forward(ctx, n, start, *xs):
        ctx.n, ctx.start = n, start
        if not start:
            ctx.save_for_backward(xs[0])
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.start:
            if len(_MULT) > 1:
                _MULT.pop()
        else:
            ctx.saved_tensors  # noqa: B018 -- starts a checkpoint's recomputation first
            _MULT.append(_MULT[-1] * ctx.n)
        return (None, None) + gs


def _mark(n: int, start: bool, xs: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """``xs`` through a :class:`_Mark` (the start or the end of a region
    repeated ``n`` times), where autograd records one."""
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
        return xs
    return _Mark.apply(n, start, *xs)


def repeated(fn: Callable, carry, parts: Tuple[torch.Tensor, ...], n: int):
    """``carry, y = fn(carry, *parts)`` once, standing for ``n`` runs of it
    on parts of the same shapes (a recurrent loop's chunks or steps on meta
    tensors, where no value differs between them): its forward and backward
    ops count ``n`` times, and ``y`` is repeated ``n`` times along its first
    (time) dim.  ``carry`` is a tensor or a tuple of them."""
    one = isinstance(carry, torch.Tensor)
    flat = (carry,) if one else tuple(carry)
    with _repeat(n):
        ins = _mark(n, True, flat + tuple(parts))
        carry, y = fn(ins[0] if one else ins[:len(flat)], *ins[len(flat):])
        flat = (carry,) if one else tuple(carry)
        outs = _mark(n, False, flat + (y,))
    y = outs[-1]
    y = y.unsqueeze(0).expand((n,) + tuple(y.shape)).reshape((n * y.shape[0],) + tuple(y.shape[1:]))
    return (outs[0] if one else outs[:len(flat)]), y
