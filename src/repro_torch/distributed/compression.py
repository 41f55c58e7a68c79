"""Error-feedback int8 gradient compression for the data-parallel all-reduce
(the counterpart of ``repro/distributed/compression.py``).

int8 is a quarter of f32's bytes on the analytic wire (``int8_wire_bytes``;
the all-reduce itself sums the payload widened to int32, so a transport
without an int8 sum moves as many bytes as f32); error feedback carries the
quantization residual into the next step, so the noise stays unbiased over
time (Karimireddy et al., 2019).  The reduction
runs over a ``torch.distributed`` process group where the reference names a
``shard_map`` axis:

    g_sum, ef = ef_int8_psum(grads, ef, group)

Plain tensor code: the reference has no kernel here either.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.param import flatten, unflatten

# Call probe: ``ef_int8_psum`` adds one per call, so callers and tests can
# check that the compressed path really ran, not only that it was configured.
_EF_PSUM_CALLS = 0


def ef_psum_calls() -> int:
    """How many times ``ef_int8_psum`` has run in this process."""
    return _EF_PSUM_CALLS


def reset_ef_psum_probe() -> None:
    global _EF_PSUM_CALLS
    _EF_PSUM_CALLS = 0


def _scale(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(t.abs().max(), min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    xf = x.float()
    scale = _scale(xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(x: torch.Tensor, ef: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compress (x + carried error); returns (q, scale, new_error)."""
    target = x.float() + ef
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def ef_int8_psum(grads, ef_state, group=None):
    """Packed int8 EF compression and exactly two collectives over ``group``
    (the default group when None): one MAX all-reduce of the stacked
    per-leaf scales, and one SUM all-reduce of every leaf's int8 payload,
    concatenated and widened to int32 (lossless across up to 2^23 ranks).

    Each leaf is quantized at the shared (largest) scale, so the EF identity
    ``sent + new_ef == grad + ef`` holds to f32 rounding.  Returns
    ``(reduced, new_ef)``: ``reduced`` is the SUM over the group, cast back
    to each leaf's dtype; ``new_ef`` is the carried f32 residual."""
    global _EF_PSUM_CALLS
    _EF_PSUM_CALLS += 1

    flat_g = flatten(grads)
    flat_e = flatten(ef_state)
    targets = [g.float() + flat_e[k] for k, g in flat_g.items()]

    smax = torch.stack([_scale(t) for t in targets])
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)

    # smax >= each rank's own scale, so no value exceeds 127 (the clip is
    # safety)
    qs, new_es = [], []
    for i, t in enumerate(targets):
        q = torch.clamp(torch.round(t / smax[i]), -127, 127)
        new_es.append(t - q * smax[i])
        qs.append(q.to(torch.int8).reshape(-1))

    total = torch.cat(qs).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)

    out, off = {}, 0
    for i, (k, g) in enumerate(flat_g.items()):
        n = g.numel()
        leaf = total[off:off + n].reshape(g.shape)
        out[k] = (leaf.float() * smax[i]).to(g.dtype)
        off += n
    return unflatten(out), unflatten(dict(zip(flat_g, new_es)))


def init_ef_state(grads):
    """Zero f32 residuals shaped like ``grads``."""
    return unflatten({k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                      for k, g in flatten(grads).items()})


# ---------------------------------------------------------------------------
# bytes on the wire (analytic)


def dense_wire_bytes(tree) -> int:
    """Per-step all-reduce payload bytes of the uncompressed gradient tree."""
    return sum(x.numel() * x.element_size() for x in flatten(tree).values())


def int8_wire_bytes(tree) -> int:
    """Per-step payload bytes of the packed int8 + EF path: one byte per
    element plus one f32 scale per leaf."""
    leaves = list(flatten(tree).values())
    return sum(x.numel() for x in leaves) + 4 * len(leaves)
