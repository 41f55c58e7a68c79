"""Analytic FLOPs accounting and the energy/CO2 layer on top of it (the
counterpart of ``repro/core/flops.py``).

The paper's evaluation axis: FLOPs-to-quality comparisons between the
V-cycle, the baselines and training from scratch.  Only relative numbers
matter, so one consistent formula is applied to every arm; the functions are
copies of the reference's and give the same numbers for the same specs.
That includes a ViT step, which is charged at the ``seq`` it is given (the
callers pass ``tc.seq_len``), not at its N + 1 tokens.

The energy layer (:class:`EnergyModel`) converts a FLOPs total to seconds,
joules and kgCO2e on one device envelope; it never changes a FLOPs number.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.param import is_spec


def _walk(tree, path=()):
    if is_spec(tree):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _walk(v, path + (k,))


def active_matmul_params(cfg: ModelConfig, specs) -> float:
    """Parameters participating in per-token matmuls, with MoE expert weights
    scaled by top_k / n_experts (active fraction) and the embedding table
    counted once iff tied (the unembed matmul)."""
    total = 0.0
    moe_frac = (cfg.moe_top_k / cfg.n_experts) if cfg.n_experts else 1.0
    for path, s in _walk(specs):
        if len(s.shape) < 2:
            continue
        n = float(np.prod(s.shape))
        if "experts" in s.axes:
            n *= moe_frac
        total += n
    return total


def total_params(specs) -> float:
    return float(sum(np.prod(s.shape) for _, s in _walk(specs)))


def _attn_layers(cfg: ModelConfig):
    n_self = sum(st.repeats * sum(1 for b in st.pattern
                                  if b.mixer in ("attn", "dec_attn", "enc_attn"))
                 for st in cfg.stages)
    n_cross = sum(st.repeats * sum(1 for b in st.pattern if b.mixer in ("cross_attn", "dec_attn"))
                  for st in cfg.stages)
    n_rec = sum(st.repeats * sum(1 for b in st.pattern if b.mixer in ("mamba", "mlstm", "slstm"))
                for st in cfg.stages)
    return n_self, n_cross, n_rec


def forward_flops(cfg: ModelConfig, specs, batch: int, seq: int) -> float:
    """Forward-pass FLOPs for a [batch, seq] input (2 FLOPs per MAC)."""
    tokens = batch * seq
    f = 2.0 * active_matmul_params(cfg, specs) * tokens
    n_self, n_cross, n_rec = _attn_layers(cfg)
    if cfg.attn_type == "mla":
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    t_avg = seq / 2 if cfg.causal else seq
    f += tokens * n_self * 2.0 * cfg.n_heads * (dqk + dv) * t_avg
    n_kv = cfg.n_image_tokens or cfg.encoder_seq
    if n_cross and n_kv:
        f += tokens * n_cross * 2.0 * cfg.n_heads * 2 * cfg.resolved_head_dim * n_kv
    if n_rec:  # recurrent state updates (mamba: d_in*d_state; xlstm: NH*dh^2)
        di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
        f += tokens * n_rec * 6.0 * di * ds
    if cfg.n_encoder_layers:  # encoder runs on encoder_seq tokens
        enc_tokens = batch * cfg.encoder_seq
        per_layer = 2.0 * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff)
        f += enc_tokens * cfg.n_encoder_layers * per_layer
        f += (enc_tokens * cfg.n_encoder_layers * 2.0 * cfg.n_heads * 2
              * cfg.resolved_head_dim * cfg.encoder_seq)
    return f


def train_step_flops(cfg: ModelConfig, specs, batch: int, seq: int) -> float:
    """fwd + bwd ~= 3x fwd (standard convention)."""
    return 3.0 * forward_flops(cfg, specs, batch, seq)


def model_flops_reference(cfg: ModelConfig, specs, tokens: float, train: bool = True) -> float:
    """Roofline reference: 6*N*D (dense) / 6*N_active*D (MoE), N = matmul params."""
    n = active_matmul_params(cfg, specs)
    return (6.0 if train else 2.0) * n * tokens


# ---------------------------------------------------------------------------
# energy / CO2 accounting
#
# The model follows Patterson et al., "Carbon Emissions and Large Neural
# Network Training": Energy = runtime x device power x PUE, CO2e = kWh x grid
# intensity -- with runtime and power derived from the roofline utilization
# fraction (the roofline-inspired scaling model in PAPERS.md):
#
#   seconds = flops / (utilization * peak_flops)
#   watts   = tdp * (idle_frac + (1 - idle_frac) * utilization)
#   joules  = seconds * watts * PUE
#   kgCO2e  = kWh * grid_kgco2_per_kwh
#
# ``utilization`` is the achieved fraction of peak (MFU, the roofline
# fraction); power scales linearly between
# the idle floor and TDP with it.  Only *relative* numbers matter between
# arms (same device, same utilization on both sides of a comparison), exactly
# like the FLOPs basis -- the absolute numbers are envelope estimates.


@dataclasses.dataclass(frozen=True)
class DevicePower:
    """One accelerator's power envelope (peak compute + TDP)."""

    name: str
    peak_flops: float   # peak FLOP/s at the training precision (bf16-class)
    tdp_watts: float    # board power at full utilization
    idle_frac: float    # fraction of TDP drawn at ~zero utilization

    def __post_init__(self):
        if self.peak_flops <= 0 or self.tdp_watts <= 0:
            raise ValueError(f"{self.name}: peak_flops and tdp_watts must be > 0")
        if not 0.0 <= self.idle_frac < 1.0:
            raise ValueError(f"{self.name}: idle_frac must be in [0, 1)")


# datasheet-level envelopes (peak bf16-class FLOP/s, board TDP); idle
# fractions are the ~30% floor Patterson et al. report for accelerators at
# low utilization.  "cpu-proxy" prices CPU smoke runs.
DEVICES: Dict[str, DevicePower] = {
    "tpu-v4": DevicePower("tpu-v4", peak_flops=275e12, tdp_watts=192.0,
                          idle_frac=0.28),
    "a100": DevicePower("a100", peak_flops=312e12, tdp_watts=400.0,
                        idle_frac=0.3),
    "h100": DevicePower("h100", peak_flops=989e12, tdp_watts=700.0,
                        idle_frac=0.3),
    "cpu-proxy": DevicePower("cpu-proxy", peak_flops=1e11, tdp_watts=65.0,
                             idle_frac=0.5),
}

# kgCO2e per kWh: US average grid intensity used by Patterson et al.
US_GRID_KGCO2_PER_KWH = 0.429


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """flops -> (seconds, joules, kgCO2e) on one device envelope.

    ``utilization`` is the achieved roofline fraction (MFU); ``pue`` the
    datacenter power-usage effectiveness (Google fleet ~1.1, Patterson et
    al.); ``grid_kgco2_per_kwh`` the grid carbon intensity.
    """

    device: DevicePower
    utilization: float = 0.4
    pue: float = 1.1
    grid_kgco2_per_kwh: float = US_GRID_KGCO2_PER_KWH

    def __post_init__(self):
        if not 0.0 < self.utilization <= 1.0:
            raise ValueError("utilization must be in (0, 1]")
        if self.pue < 1.0:
            raise ValueError("PUE is >= 1 by definition")
        if self.grid_kgco2_per_kwh < 0:
            raise ValueError("grid intensity must be >= 0")

    def seconds(self, flops: float) -> float:
        """Device-seconds to execute ``flops`` at the achieved fraction of
        peak (divide by the device count for wall-clock)."""
        return flops / (self.utilization * self.device.peak_flops)

    def watts(self) -> float:
        """Average board power: linear between the idle floor and TDP with
        utilization (the roofline-inspired power scaling)."""
        d = self.device
        return d.tdp_watts * (d.idle_frac + (1.0 - d.idle_frac) * self.utilization)

    def joules(self, flops: float) -> float:
        """Facility energy: device-seconds x average watts x PUE."""
        return self.seconds(flops) * self.watts() * self.pue

    def kgco2e(self, flops: float) -> float:
        return self.joules(flops) / 3.6e6 * self.grid_kgco2_per_kwh

    def report(self, flops: float) -> Dict[str, float]:
        """The full accounting for one arm, on one basis (benchmark tables)."""
        j = self.joules(flops)
        return {"flops": float(flops),
                "device": self.device.name,
                "utilization": self.utilization,
                "seconds": self.seconds(flops),
                "watts": self.watts(),
                "joules": j,
                "kwh": j / 3.6e6,
                "kgco2e": j / 3.6e6 * self.grid_kgco2_per_kwh}


def energy_report(flops: float, device: str = "tpu-v4", *,
                  utilization: float = 0.4, pue: float = 1.1,
                  grid_kgco2_per_kwh: float = US_GRID_KGCO2_PER_KWH) -> Dict[str, float]:
    """One-call convenience: ``energy_report(total_flops)`` -> the table row."""
    return EnergyModel(DEVICES[device], utilization=utilization, pue=pue,
                       grid_kgco2_per_kwh=grid_kgco2_per_kwh).report(flops)
