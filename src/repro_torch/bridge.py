"""Weight bridge between the reference package and the port.

Both packages keep parameters as the same nested dict (``embed/tok``,
``stages/stage_0/b0/mixer/wq`` with its stacked leading ``layers`` axis,
...), so crossing is a tree walk over numpy arrays.  Both directions check
every leaf name and shape against ``lm_specs(cfg)`` and raise on a mismatch;
the AdamW state (``m``/``v`` mirror the parameter tree, plus ``count``)
crosses the same way.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.lm import lm_specs
from repro_torch.param import flatten, tree_map


def _check(tree, cfg: ModelConfig, what: str) -> None:
    want = {k: tuple(s.shape) for k, s in flatten(lm_specs(cfg)).items()}
    got = {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}
    if set(got) != set(want):
        raise ValueError(f"{what}: leaf names differ from lm_specs({cfg.name}): "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"{what}: leaf shapes differ from lm_specs({cfg.name}) "
                         f"(got, want): {bad}")


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the reference's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(np_tree: Dict, cfg: ModelConfig, device="cpu",
                   dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's parameters (numpy leaves) as the port's tree on
    ``device``, each leaf cast to ``dtype`` when given."""
    _check(np_tree, cfg, "from_reference")
    return tree_map(lambda a: _to_torch(a).to(device=device, dtype=dtype), np_tree)


def to_reference(tree: Dict, cfg: ModelConfig) -> Dict:
    """The port's parameters as numpy leaves (bf16 leaves widen to float32,
    which numpy can hold without extra packages)."""
    _check(tree, cfg, "to_reference")

    return tree_map(_to_numpy, tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_state_from_reference(np_opt: Dict, cfg: ModelConfig, device="cpu") -> Dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` (numpy leaves) as
    the port's: moment trees checked against ``lm_specs(cfg)`` like the
    parameters, ``count`` a Python int."""
    _check(np_opt["m"], cfg, "opt_state_from_reference (m)")
    _check(np_opt["v"], cfg, "opt_state_from_reference (v)")
    conv = lambda a: _to_torch(a).to(device=device)
    return {"m": tree_map(conv, np_opt["m"]), "v": tree_map(conv, np_opt["v"]),
            "count": int(np.asarray(np_opt["count"]))}


def opt_state_to_reference(opt: Dict, cfg: ModelConfig) -> Dict:
    """The port's AdamW state as the reference's (numpy leaves, ``count`` an
    int32 scalar)."""
    _check(opt["m"], cfg, "opt_state_to_reference (m)")
    _check(opt["v"], cfg, "opt_state_to_reference (v)")
    return {"m": tree_map(_to_numpy, opt["m"]), "v": tree_map(_to_numpy, opt["v"]),
            "count": np.asarray(opt["count"], np.int32)}
