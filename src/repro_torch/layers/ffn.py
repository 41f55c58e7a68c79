"""Dense FFN: SwiGLU, or the classic two-matrix GELU FFN with biases (the
counterpart of ``repro/layers/ffn.py::ffn_specs``/``ffn_apply``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.basic import act_fn
from repro_torch.param import Spec


def ffn_specs(cfg: ModelConfig, d_ff: int = 0, axis: str = "mlp") -> Dict[str, Spec]:
    E = cfg.d_model
    F = d_ff or cfg.d_ff
    s = {
        "w_gate": Spec((E, F), ("embed", axis), ("in", "out"), init="fan_in"),
        "w_up": Spec((E, F), ("embed", axis), ("in", "out"), init="fan_in"),
        "w_down": Spec((F, E), (axis, "embed"), ("in", "out"), init="fan_in"),
    }
    if cfg.act == "gelu":  # classic 2-matrix FFN (BERT/GPT/DeiT/Whisper)
        s.pop("w_gate")
    if cfg.use_bias:
        s["b_up"] = Spec((F,), (axis,), ("out",), init="zeros")
        s["b_down"] = Spec((E,), ("embed",), ("out",), init="zeros")
    return s


def ffn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    act = act_fn(cfg.act)
    h = x @ p["w_up"].to(cdt)
    if cfg.use_bias:
        h = h + p["b_up"].to(cdt)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(cdt)) * h
    else:
        h = act(h)
    y = h @ p["w_down"].to(cdt)
    if cfg.use_bias:
        y = y + p["b_down"].to(cdt)
    return y
