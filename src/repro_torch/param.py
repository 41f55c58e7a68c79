"""Parameter specs: the single source of truth for shapes, logical axes,
coalescing roles and initialization (the counterpart of ``repro/param.py``).

A model declares its parameters as a nested dict of :class:`Spec`;
:func:`init_tree` materializes it from a ``torch.Generator``.  The random
numbers differ from the reference's ``jax.random`` draws; tests that compare
the two packages move one set of weights across with ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor.

    Attributes:
      shape: global shape.
      axes:  logical axis name per dim, e.g. ("layers", "embed", "mlp").
      roles: coalescing role per dim: "in", "out" or "-".
      init:  "normal" | "zeros" | "ones" | "fan_in" | "embed".
      scale: stddev override for "normal"/"embed", numerator for "fan_in".
      dtype: dtype override (caches carry the compute dtype).
    """

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    roles: Tuple[str, ...] = ()
    init: str = "normal"
    scale: Optional[float] = None
    dtype: Optional[Any] = None

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")
        if self.roles and len(self.roles) != len(self.shape):
            raise ValueError(f"roles {self.roles} do not match shape {self.shape}")
        if not self.roles:
            object.__setattr__(self, "roles", ("-",) * len(self.shape))


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (``rest`` share the keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` for nested dicts, keys in insertion order."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict:
    """Inverse of :func:`flatten`."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _init_leaf(spec: Spec, dtype, gen: torch.Generator) -> torch.Tensor:
    dt = spec.dtype or dtype
    sh = spec.shape
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(sh, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(sh, dtype=dt, device=dev)
    if spec.init in ("normal", "embed"):
        sd = 0.02 if spec.scale is None else spec.scale
    elif spec.init == "fan_in":
        # stddev = scale / sqrt(prod of "in"-role dims); fallback: first dim
        ins = [n for n, r in zip(sh, spec.roles) if r == "in"]
        fan = math.prod(ins) if ins else sh[0]
        sd = (spec.scale or 1.0) / math.sqrt(max(fan, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(sh, generator=gen, dtype=torch.float32, device=dev)
    return (x * sd).to(dt)


def init_tree(gen: torch.Generator, specs, dtype=torch.float32):
    """Materialize parameters for a spec tree on ``gen.device``."""
    return tree_map(lambda s: _init_leaf(s, dtype, gen), specs)


def zeros_tree(specs, dtype, device) -> Dict:
    """Zero tensors for a spec tree (cache pools), each leaf in its spec dtype
    or ``dtype``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype or dtype,
                                          device=device), specs)
