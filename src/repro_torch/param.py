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
      init:  "normal" | "zeros" | "ones" | "fan_in" | "embed" | "mamba_A" |
             "mamba_dt".
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
    if spec.init == "mamba_A":
        # A = -exp(A_log); A_log = log(1..d_state) broadcast over the leading
        # (layers, d_inner) dims: deterministic, each value the correctly
        # rounded f32 log on every device (taken in f64)
        a = torch.log(torch.arange(1, sh[-1] + 1, dtype=torch.float64, device=dev))
        return a.to(torch.float32).expand(sh).to(dt).contiguous()
    if spec.init == "mamba_dt":
        # dt bias such that softplus(dt) is log-uniform in [1e-3, 1e-1]: the
        # reference's distribution, drawn from ``gen``
        lo, hi = 1e-3, 1e-1
        u = torch.rand(sh, generator=gen, dtype=torch.float32, device=dev)
        t = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        return (t + torch.log(-torch.expm1(-t))).to(dt)  # inverse softplus
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def axes_tree(specs):
    """Each ``Spec`` leaf's logical axes."""
    return tree_map(lambda s: s.axes, specs)


def roles_tree(specs):
    """Each ``Spec`` leaf's coalescing roles."""
    return tree_map(lambda s: s.roles, specs)


def struct_tree(specs, dtype=torch.bfloat16):
    """Meta tensors of each leaf's shape and dtype (``spec.dtype`` or
    ``dtype``): stand-ins that allocate nothing, the counterpart of the
    reference's ``jax.ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"),
                    specs)


def count_params(specs) -> int:
    """Elements over every ``Spec`` leaf."""
    return sum(math.prod(s.shape) for s in _leaves(specs))


def param_bytes(specs, dtype=torch.bfloat16) -> int:
    """:func:`count_params` times ``dtype``'s size, as the reference counts
    (a leaf's own dtype is not read)."""
    return count_params(specs) * torch.empty((), dtype=dtype).element_size()


def tree_axpy(a: float, x, y):
    """``a * x + (1 - a) * y`` over two matching trees."""
    return tree_map(lambda u, v: a * u + (1.0 - a) * v, x, y)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree``."""
    sq = [torch.sum(torch.square(t.float())) for t in _leaves(tree)]
    return torch.sqrt(sum(sq))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def flatten_with_paths(tree) -> Dict[str, Any]:
    """``{"['a']['b']": leaf}``: the reference's ``jax.tree_util.keystr``
    paths of a nested dict, keys sorted at every level as ``jax`` flattens
    a dict."""
    items = sorted(flatten(tree).items(), key=lambda kv: kv[0].split("/"))
    return {"".join(f"[{k!r}]" for k in path.split("/")): v for path, v in items}
