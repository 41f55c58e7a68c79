"""The paper's three operators on a parameter tree (Coalescing,
De-coalescing, Interpolation), driven by per-family
:class:`~repro_torch.core.plans.ProjectionPlan` objects over the per-leaf
logical-axis metadata (the counterpart of ``repro/core/operators.py``).

For every width-coalescible logical axis one shared set of projection
matrices is built -- which *is* the Appendix-A constraint structure:
residual stream, Q/K alignment and norm scales share their F.  The "layers"
axis is handled by the depth matrices R/G per stage.  Protected axes
(head_dim, vocab, ...) are never projected; see DESIGN.md §4.

Execution: for the paper's main "stack" width variant the F contractions
are pair merges, which run through the ``coalesce_pair`` kernel behind
``kernels/dispatch.py`` (one pass, no F matrix), and the T contractions are
duplications (``torch.cat``); Interpolation runs every leaf through the
``interp_axpy`` kernel.  The "adj" variant, ``embed_cat2`` block-diagonal
matrices and depth R/G keep the dense-matrix ``tensordot`` path, which the
reference also computes outside any kernel.  ``fused=False`` forces the
dense path for every width axis (the equivalence oracle of the tests).

The transitions run eagerly under ``torch.no_grad``; the ``make_*_fn``
builders return plain callables.  On a mesh whose "model" axis splits
``heads`` or ``mlp`` into contiguous blocks, every pair (i, i + n/2) of a
width operator straddles two processes: ``make_coalesce_fn`` and
``make_decoalesce_fn`` with ``in_shardings``/``out_shardings`` gather each
split leaf whole first (``gather_global_tree``), project as one process
does, and cut the result to the target level's layout
(``put_global_tree``), where a dimension the smaller level can no longer
split falls back to replicated.  Interpolation is elementwise: it runs on
the local blocks, which the stash and the de-coalesced tree share.
``project_tree`` itself is differentiable in the maps and the parameters:
LiGO (``core/baselines.py``) fits its growth matrices by SGD through it.  Results are new, contiguous tensors: the inputs
are never written.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, MultiLevelConfig
from repro_torch.core import projections as proj
from repro_torch.core.plans import LevelMaps, ProjectionPlan, build_plan, normalize_overrides
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.param import Spec, is_spec


def coalesce_config(cfg: ModelConfig, ml: Optional[MultiLevelConfig] = None,
                    *, width: bool = True, depth: bool = True) -> ModelConfig:
    """The next-level (smaller) model config: ``build_plan(...).small_cfg``."""
    return build_plan(cfg, ml, width=width, depth=depth).small_cfg


def build_level_maps(cfg: ModelConfig, ml: MultiLevelConfig,
                     *, width: bool = True, depth: bool = True) -> LevelMaps:
    """The projection matrices of one level transition:
    ``build_plan(...).build_maps()`` (numpy; ``.as_torch()`` moves them)."""
    return build_plan(cfg, ml, width=width, depth=depth).build_maps()


# ---------------------------------------------------------------------------
# applying the projections to a parameter tree


def _contract(w: torch.Tensor, dim: int, mat: torch.Tensor, mat_axis: int) -> torch.Tensor:
    """Contract w's ``dim`` with mat's ``mat_axis``; result axis moved back."""
    out = torch.tensordot(w, mat, dims=([dim], [mat_axis]))
    return torch.movedim(out, -1, dim)


def _stack_coalesce(w: torch.Tensor, dim: int, w0: float,
                    backend: Optional[str]) -> torch.Tensor:
    """Matrix-free "stack"-variant coalescing of ``dim``: fold the leaf to 2D
    and merge pairs (i, i + n/2) in one kernel pass.  The fold copies the
    leaf when ``dim`` is not its first axis."""
    n = w.shape[dim]
    rest = tuple(s for i, s in enumerate(w.shape) if i != dim)
    w2 = torch.movedim(w, dim, 0).reshape(n, -1).contiguous()
    out = kdispatch.dispatch("coalesce_pair", w2, axis=0, w0=w0, config=backend)
    return torch.movedim(out.reshape((n // 2,) + rest), 0, dim)


def _stack_decoalesce(w: torch.Tensor, dim: int, w0: float) -> torch.Tensor:
    """Matrix-free "stack"-variant de-coalescing: T duplication is a pure
    gather -- tile the halved axis twice, scaled by the paper's normalization
    weight (T_out rows are 1.0, T_in rows 0.5)."""
    dup = torch.cat([w, w], dim=dim)
    if w0 == 1.0:
        return dup
    return (w0 * dup.float()).to(w.dtype)


def _width_leaf(w, spec: Spec, width: Dict[str, proj.WidthMats], direction: str,
                role_overrides: Dict[str, str], backend=None, fused: bool = True):
    for d, (ax, role) in enumerate(zip(spec.axes, spec.roles)):
        if ax in role_overrides and ax in width:
            # plan-level role rewrite, e.g. expert pair-averaging
            role = role_overrides[ax]
        if ax not in width or role not in ("in", "out"):
            continue
        m = width[ax]
        if fused and getattr(m, "variant", None) == "stack":
            # the "stack" averaging matrices ARE pair merges/duplications
            # (F_out weights 0.5, F_in 1.0; T_out 1.0, T_in 0.5)
            if direction == "coalesce":
                w = _stack_coalesce(w, d, 0.5 if role == "out" else 1.0, backend)
            else:
                w = _stack_decoalesce(w, d, 1.0 if role == "out" else 0.5)
        elif direction == "coalesce":
            w = _contract(w, d, m.F_out, 0) if role == "out" else _contract(w, d, m.F_in, 1)
        else:
            w = _contract(w, d, m.T_out, 0) if role == "out" else _contract(w, d, m.T_in, 1)
    return w


def _depth_leaf(w, spec: Spec, dm: proj.DepthMats, direction: str):
    if not spec.axes or spec.axes[0] != "layers":
        return w
    if direction == "coalesce":
        return torch.einsum("l...,lj->j...", w, dm.R)  # R: [L, L2]
    return torch.einsum("l...,lj->j...", w, dm.G)  # G: [L2, L]


def project_tree(params, specs, maps: LevelMaps, direction: str,
                 role_overrides=None, depth_key: Optional[str] = None,
                 backend: Optional[str] = None, fused: bool = True):
    """Recurse through the tree, tracking which stage we are under so the
    right depth matrices apply.  ``role_overrides`` is the plan's per-axis
    role rewrite dict, or a ``coalesce_experts`` bool
    (:func:`~repro_torch.core.plans.normalize_overrides`).  A leaf that no
    map touches comes back as a copy: the optimizer updates parameters in
    place, and the V-cycle keeps the input tree as its ``params_before``
    stash.  Autograd records the dense-matrix
    path; a "stack" coalescing runs the ``coalesce_pair`` kernel, which has
    no backward."""

    role_overrides = normalize_overrides(role_overrides)

    def rec(p, s, dkey):
        if is_spec(s):
            w = _width_leaf(p, s, maps.width, direction, role_overrides,
                            backend=backend, fused=fused)
            if dkey is not None and dkey in maps.depth:
                w = _depth_leaf(w, s, maps.depth[dkey], direction)
            w = w.contiguous()
            return w.clone() if w is p else w
        out = {}
        for k in s:
            sub_dkey = dkey
            if k.startswith("stage_"):
                sub_dkey = k
            elif k == "encoder":
                sub_dkey = "encoder"
            out[k] = rec(p[k], s[k], sub_dkey)
        return out

    return rec(params, specs, depth_key)


_project_tree = torch.no_grad()(project_tree)


def _device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def coalesce(params, specs, cfg: ModelConfig, ml: MultiLevelConfig,
             maps: Optional[LevelMaps] = None, *, fused: bool = True,
             plan: Optional[ProjectionPlan] = None):
    """Paper Algorithm 2: width then depth (they commute on disjoint axes)."""
    plan = plan or build_plan(cfg, ml)
    maps = (maps or plan.build_maps()).as_torch(_device(params))
    return _project_tree(params, specs, maps, "coalesce", plan.role_overrides,
                         backend=cfg.kernel_backend or None, fused=fused)


def decoalesce(params_small, specs, cfg: ModelConfig, ml: MultiLevelConfig,
               maps: Optional[LevelMaps] = None, *, fused: bool = True,
               plan: Optional[ProjectionPlan] = None):
    """Paper Algorithm 3: depth then width.  ``specs``/``cfg`` are the LARGE
    level's; ``params_small`` the small level's parameters."""
    plan = plan or build_plan(cfg, ml)
    maps = (maps or plan.build_maps()).as_torch(_device(params_small))
    return _project_tree(params_small, specs, maps, "decoalesce",
                         plan.role_overrides,
                         backend=cfg.kernel_backend or None, fused=fused)


@torch.no_grad()
def interpolate(params_large, params_decoalesced, alpha: float,
                backend: Optional[str] = None):
    """Paper Algorithm 4 / Eq. 13: M <- (1-a) M + a D(M_small), each leaf
    through the ``interp_axpy`` kernel."""
    if isinstance(params_large, dict):
        return {k: interpolate(v, params_decoalesced[k], alpha, backend)
                for k, v in params_large.items()}
    return kdispatch.dispatch("interp_axpy", params_large, params_decoalesced, alpha,
                              config=backend)


def _across_mesh(fn, in_shardings, out_shardings, mesh):
    """``fn`` on the global tree: the input's split leaves gathered whole
    (``in_shardings``), the output cut to this process's blocks
    (``out_shardings``); ``fn`` itself without shardings."""
    if in_shardings is None and out_shardings is None:
        return fn
    from repro_torch.distributed.multiprocess import gather_global_tree, put_global_tree

    def run(p):
        return put_global_tree(fn(gather_global_tree(p, in_shardings, mesh)), out_shardings,
                               mesh)

    return run


def make_coalesce_fn(specs, cfg: ModelConfig, ml: MultiLevelConfig,
                     *, width: bool = True, depth: bool = True,
                     fused: bool = True, plan: Optional[ProjectionPlan] = None,
                     in_shardings=None, out_shardings=None, mesh=None):
    """The level transition down as a plain callable ``params -> params``.
    "stack"-variant width axes run through the ``coalesce_pair`` kernel,
    everything else as tensordots; ``fused=False`` forces the dense-matrix
    path.  Pass ``plan`` when one is already built (the V-cycle runner
    does); it must match ``(cfg, ml, width, depth)``.  On a mesh,
    ``in_shardings`` is the input level's parameter layout and
    ``out_shardings`` the smaller level's (see the module docstring)."""
    plan = plan or build_plan(cfg, ml, width=width, depth=depth)
    maps = plan.build_maps()
    backend = cfg.kernel_backend or None
    return _across_mesh(lambda p: _project_tree(p, specs, maps.as_torch(_device(p)),
                                                "coalesce", plan.role_overrides,
                                                backend=backend, fused=fused),
                        in_shardings, out_shardings, mesh)


def make_decoalesce_fn(specs, cfg: ModelConfig, ml: MultiLevelConfig,
                       *, width: bool = True, depth: bool = True,
                       fused: bool = True, plan: Optional[ProjectionPlan] = None,
                       in_shardings=None, out_shardings=None, mesh=None):
    """The level transition up (``specs``/``cfg`` the large level's); on a
    mesh, ``in_shardings`` is the small level's layout and
    ``out_shardings`` the large level's."""
    plan = plan or build_plan(cfg, ml, width=width, depth=depth)
    maps = plan.build_maps()
    backend = cfg.kernel_backend or None
    return _across_mesh(lambda p: _project_tree(p, specs, maps.as_torch(_device(p)),
                                                "decoalesce", plan.role_overrides,
                                                backend=backend, fused=fused),
                        in_shardings, out_shardings, mesh)


def make_interpolate_fn(alpha: float, backend: Optional[str] = None):
    return lambda a, b: interpolate(a, b, alpha, backend=backend)


def make_draft_projection(specs, cfg: ModelConfig,
                          ml: Optional[MultiLevelConfig] = None,
                          *, width: bool = True, depth: bool = True,
                          in_shardings=None, out_shardings=None, mesh=None
                          ) -> Tuple[ModelConfig, Any]:
    """The serving-time self-speculative draft: ``(draft_cfg, project)``.

    The level-1 coalesced model is a deterministic projection of the serving
    parameters: ``project(params) -> draft_params`` is the Coalescing
    transition (``make_coalesce_fn``; "stack" width axes through the
    ``coalesce_pair`` kernel, under ``no_grad``).  Call it again whenever the
    serving parameters change and the draft stays in sync.  Width-only
    drafts track the full model most closely (width de-coalescing preserves
    the function for untied embeddings); width and depth together give the
    cheapest draft the paper defines.  On a serving mesh ``in_shardings``
    is the server's parameter layout and ``out_shardings`` the draft's
    (``serve_shardings`` of the draft model): the serving leaves are
    gathered whole, projected and cut, as a level transition does.
    """
    ml = ml or MultiLevelConfig()
    plan = build_plan(cfg, ml, width=width, depth=depth)
    return plan.small_cfg, make_coalesce_fn(specs, cfg, ml, width=width, depth=depth,
                                            plan=plan, in_shardings=in_shardings,
                                            out_shardings=out_shardings, mesh=mesh)
