"""The three-term roofline of one step on the H100 (the counterpart of
``repro/launch/analysis.py``).

The dry run (``launch/dryrun.py``) counts one rank's step with
``launch/op_cost.py``'s :class:`~repro_torch.launch.op_cost.OpCounter`, so
its FLOPs, bytes and collective bytes are per-device quantities; each term
is a per-device quantity over a per-device rate (global = per device times
devices, and the devices cancel).  Collective bytes inside a node of 8 move
at ``NVLINK_BW``, across nodes at ``IB_BW`` (``launch/mesh.py``, the H100's
spec-sheet figures).

Collective byte model (per device, ring algorithms, group size g):
  all-reduce       2 * B * (g-1)/g      (RS + AG phases)
  all-gather           B * (g-1)/g      (B = gathered output)
  reduce-scatter   B_out * (g-1)        (input = B_out * g)
  all-to-all           B * (g-1)/g
  send / recv          B
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    """Three-term roofline (seconds) for one step on the target mesh."""

    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    n_devices: int
    model_flops: float  # 6*N*D reference (global)
    nvlink_bytes_per_device: float = 0.0
    ib_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.nvlink_bytes_per_device / NVLINK_BW + self.ib_bytes_per_device / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / the step's global FLOPs (catches remat and
        redundant work)."""
        counted = self.flops_per_device * self.n_devices
        return self.model_flops / counted if counted else float("nan")

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of peak at the roofline-modelled step time."""
        useful = self.model_flops / self.n_devices / PEAK_FLOPS_BF16
        return useful / self.step_time if self.step_time else float("nan")

    def to_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "nvlink_bytes_per_device": self.nvlink_bytes_per_device,
            "ib_bytes_per_device": self.ib_bytes_per_device,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "step_time_s": self.step_time,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def collective_stats(counter) -> Dict[str, Dict[str, float]]:
    """Per-kind counts and per-device bytes (NVLink and IB apart) of a
    counted step, with their ``"total"``."""
    return counter.collective_totals()


def roofline(counter, n_devices: int, model_flops: float) -> Roofline:
    """The :class:`Roofline` of a counted step on ``n_devices``."""
    tot = counter.collective_totals()["total"]
    return Roofline(flops_per_device=counter.flops, bytes_per_device=counter.bytes,
                    coll_bytes_per_device=tot["bytes"], n_devices=n_devices,
                    model_flops=model_flops, nvlink_bytes_per_device=tot["nvlink_bytes"],
                    ib_bytes_per_device=tot["ib_bytes"])


def memory_summary(counter) -> Dict[str, float]:
    """The reference's memory keys from a counted step: ``peak_bytes_est``
    is the peak of live bytes (the arguments and every storage the step
    made, each freed when its last reference died); ``temp_bytes`` what
    that peak holds beyond the arguments and the new outputs, so that
    ``peak = argument + output + temp - alias`` as the reference's; ``fits``
    says whether the peak fits the card's ``HBM_BYTES``."""
    arg, out, alias = counter.argument_bytes, counter.output_bytes, counter.alias_bytes
    peak = counter.peak_bytes
    return {"argument_bytes": arg, "output_bytes": out,
            "temp_bytes": peak - arg - out + alias, "alias_bytes": alias,
            "peak_bytes_est": peak, "fits": peak <= HBM_BYTES}
