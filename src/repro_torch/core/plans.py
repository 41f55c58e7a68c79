"""Per-family projection plans: the explicit contract between a model family
and the three operators (DESIGN.md §2).  A copy of ``repro/core/plans.py``
(pure Python over numpy), every family hook included, with
``LevelMaps.as_torch`` in place of ``as_jnp``.

A :class:`ProjectionPlan` is built once per level transition from a
:class:`ModelConfig` and names

* ``width_axes``    -- the logical axes this transition halves (and their
                       current sizes); one shared F/T pair per axis *is* the
                       paper's Appendix-A constraint structure,
* ``protected_axes``-- axes the operators must never mix (head_dim, conv
                       taps, SSM state, vocab, patches, ...; DESIGN.md §4),
* ``role_overrides``-- per-axis role rewrites applied before projection (the
                       MoE expert axis is declared "-"/protected in the leaf
                       specs and flipped to "out" here when expert coalescing
                       is on -- pairwise expert merging is a plan decision,
                       not a leaf property),
* ``depth_groups``  -- the per-stage layer counts the depth R/G matrices act
                       on,
* ``carried``       -- scalar config fields that follow the merge *unchanged
                       by construction* (MoE capacity factor / aux-loss
                       coefficient; see the MoE hook), recorded so tests can
                       pin the reasoning,
* ``small_cfg``     -- the next-level config, derived by the same hooks.

Plans are assembled by composable **family hooks**: feature-detected
contributors (dense attention/FFN, MLA, MoE, Mamba, xLSTM, encoder-decoder,
vision adapters, ViT) that each add their axes + config halvings.  A hybrid
like jamba simply matches several hooks (dense + moe + ssm) -- there is no
"jamba hook", which is the point: a new family declares its axes once and
every operator, baseline, benchmark and sharding rule follows.

``operators.coalesce_config`` is a thin wrapper over :func:`build_plan`, so
config halving and map construction cannot drift apart: both read the same
plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, MultiLevelConfig, Stage
from repro_torch.core import projections as proj

# logical axes subject to width coalescing (the reference's canonical list)
WIDTH_AXES = (
    "embed", "mlp", "heads", "kv_heads", "q_lora", "kv_lora",
    "moe_mlp", "shared_mlp", "mamba_inner", "dt_rank", "experts", "embed_cat2",
)


@dataclasses.dataclass
class LevelMaps:
    """Projection matrices between a (large cfg, small cfg) level pair."""

    width: Dict[str, proj.WidthMats]
    depth: Dict[str, proj.DepthMats]  # per stage name + "encoder"

    def as_torch(self, device="cpu", dtype=torch.float32) -> "LevelMaps":
        """The matrices as tensors on ``device`` (f32 by default)."""
        conv = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        width = {k: dataclasses.replace(
                     v, **{f: conv(getattr(v, f)) for f in proj.MAT_FIELDS})
                 for k, v in self.width.items()}
        depth = {k: proj.DepthMats(R=conv(v.R), G=conv(v.G))
                 for k, v in self.depth.items()}
        return LevelMaps(width=width, depth=depth)


def _halve(x: int) -> int:
    """A dimension is halved iff it is even -- exactly the condition under
    which width matrices are constructed, so config and projected parameter
    shapes stay consistent for any architecture."""
    return x // 2 if (x and x % 2 == 0) else x


@dataclasses.dataclass
class _Draft:
    """Mutable scratch a family hook writes into while a plan is built."""

    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    protected: List[str] = dataclasses.field(default_factory=list)
    overrides: Dict[str, str] = dataclasses.field(default_factory=dict)
    carried: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    hooks: List[str] = dataclasses.field(default_factory=list)

    def protect(self, *axes: str):
        for ax in axes:
            if ax not in self.protected:
                self.protected.append(ax)


@dataclasses.dataclass(frozen=True)
class FamilyHook:
    """One feature-detected contributor to a projection plan."""

    name: str
    applies: Callable[[ModelConfig], bool]
    contribute: Callable[[_Draft, ModelConfig, MultiLevelConfig, bool, bool], None]


def _has_mixer(cfg: ModelConfig, *mixers: str) -> bool:
    return any(b.mixer in mixers for st in cfg.stages for b in st.pattern)


def _hook_dense(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    """Residual stream + attention heads + dense FFN: every family has these
    (ViT included); the shared ``embed`` F *is* the residual constraint group."""
    d.sizes.update(embed=cfg.d_model, heads=cfg.n_heads,
                   kv_heads=cfg.n_kv_heads, embed_cat2=2 * cfg.d_model)
    if cfg.d_ff:
        d.sizes["mlp"] = cfg.d_ff
    d.protect("head_dim", "vocab", "seq", "mtp")
    halve = _halve if width else (lambda x: x)
    if depth:
        d.kw["stages"] = tuple(Stage(st.pattern, (st.repeats + 1) // 2)
                               for st in cfg.stages)
    d.kw.update(d_model=halve(cfg.d_model), n_heads=halve(cfg.n_heads),
                n_kv_heads=halve(cfg.n_kv_heads), d_ff=halve(cfg.d_ff),
                # head width preserved; heads merge whole
                head_dim=cfg.resolved_head_dim)
    d.notes.append("heads merge whole: head_dim pinned to the resolved value")


def _hook_mla(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    d.sizes.update(q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank)
    d.protect("rope_dim", "v_head_dim")
    halve = _halve if width else (lambda x: x)
    d.kw.update(q_lora_rank=halve(cfg.q_lora_rank),
                kv_lora_rank=halve(cfg.kv_lora_rank))


def _hook_moe(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    """MoE: expert-inner width always coalesces; the expert *count* only when
    ``cfg.coalesce_experts`` flips the leaf-protected "experts" axis to "out"
    (pairwise expert merging, beyond-paper; DESIGN.md §3).

    Router consistency under an expert merge (X -> X/2) is structural:

    * router columns: the router leaf carries the "experts" axis, so the same
      role override pair-averages its columns -- the merged expert's logit is
      the mean of its parents' logits.  No special case, pinned by tests.
    * ``capacity_factor`` carries UNCHANGED: per-expert capacity is
      C = ceil(S * k * cf / X), so halving X doubles each expert's slots and
      the *total* slot count X * C is preserved exactly.
    * ``router_aux_coef`` carries UNCHANGED: the Switch aux loss
      X * sum_e(m_e * c_e) is scale-invariant in X at uniform routing (its
      value is 1.0 for any X), so the load-balancing pressure is comparable
      across levels without retuning.
    """
    F = cfg.moe_d_ff or cfg.d_ff
    d.sizes["moe_mlp"] = F
    if cfg.n_shared_experts:
        d.sizes["shared_mlp"] = cfg.n_shared_experts * F
    halve = _halve if width else (lambda x: x)
    d.kw["moe_d_ff"] = halve(cfg.moe_d_ff)
    if cfg.coalesce_experts:
        d.sizes["experts"] = cfg.n_experts
        d.overrides["experts"] = "out"
        d.kw.update(n_experts=halve(cfg.n_experts),
                    moe_top_k=min(cfg.moe_top_k, halve(cfg.n_experts)))
        d.notes.append("expert merge: router columns pair-average via the "
                       "'experts'->'out' override")
        d.notes.append("capacity_factor / router_aux_coef carry unchanged: "
                       "per-expert capacity ceil(S*k*cf/X) doubles as X "
                       "halves (total slots preserved); the aux loss "
                       "X*sum(m_e*c_e) is scale-invariant in X")
    else:
        d.protect("experts")
    d.carried.update(capacity_factor=cfg.capacity_factor,
                     router_aux_coef=cfg.router_aux_coef)


def _hook_mamba(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    """Mamba mixers: the inner stream and dt rank coalesce; the recurrent
    state (d_state) and conv taps are function-defining and protected
    (DESIGN.md §4)."""
    d.sizes.update(mamba_inner=cfg.mamba_d_inner, dt_rank=cfg.resolved_dt_rank)
    d.protect("conv_k", "mamba_state")
    halve = _halve if width else (lambda x: x)
    d.kw["mamba_dt_rank"] = halve(cfg.resolved_dt_rank)


def _hook_xlstm(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    """xLSTM mixers: heads coalesce whole (the dense hook already names the
    "heads" axis); the per-head recurrent memories are protected."""
    d.protect("xlstm_head", "slstm_head")


def _hook_encoder(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    if depth:
        d.kw["n_encoder_layers"] = (cfg.n_encoder_layers + 1) // 2


def _hook_vision_adapter(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    # the stub frontend's feature dim is fixed; pin it before halving d_model
    d.kw["vision_dim"] = cfg.vision_dim or cfg.d_model
    d.notes.append("cross-attn frontend feature dim pinned (vision_dim)")


def _hook_vit(d: _Draft, cfg: ModelConfig, ml, width: bool, depth: bool):
    """ViT: patch pixels, sequence positions and class logits are data-defined
    dims -- protected; only the transformer trunk coalesces."""
    d.protect("patch", "classes")


FAMILY_HOOKS: Tuple[FamilyHook, ...] = (
    FamilyHook("dense", lambda c: True, _hook_dense),
    FamilyHook("mla", lambda c: c.attn_type == "mla", _hook_mla),
    FamilyHook("moe", lambda c: bool(c.n_experts), _hook_moe),
    FamilyHook("mamba", lambda c: _has_mixer(c, "mamba"), _hook_mamba),
    FamilyHook("xlstm", lambda c: _has_mixer(c, "mlstm", "slstm"), _hook_xlstm),
    FamilyHook("encoder", lambda c: bool(c.n_encoder_layers), _hook_encoder),
    FamilyHook("vision_adapter", lambda c: _has_mixer(c, "cross_attn"),
               _hook_vision_adapter),
    FamilyHook("vit", lambda c: c.family == "vit", _hook_vit),
)


@dataclasses.dataclass(frozen=True)
class ProjectionPlan:
    """The explicit per-family contract for one level transition.

    ``cfg`` is the LARGE level, ``small_cfg`` the coalesced one.  All the
    operator entry points (``make_coalesce_fn`` / ``make_decoalesce_fn`` /
    the baselines / the V-cycle runner) accept a plan; building one yourself
    is only needed for introspection -- the wrappers build it on demand.
    """

    family: str                      # cfg.family label of the large model
    hooks: Tuple[str, ...]           # contributing family hooks, in order
    cfg: ModelConfig
    small_cfg: ModelConfig
    ml: MultiLevelConfig
    width: bool
    depth: bool
    width_axes: Dict[str, int]       # axis -> LARGE size, only axes that halve
    protected_axes: Tuple[str, ...]
    role_overrides: Dict[str, str]   # axis -> forced role (e.g. experts->out)
    depth_groups: Dict[str, Tuple[int, int]]  # group -> (large, small) layers
    carried: Dict[str, Any]          # scalar fields carried across the merge
    notes: Tuple[str, ...]

    def axis_sizes(self) -> Dict[str, int]:
        """Every width-coalescible axis present (halvable or not)."""
        return dict(self._all_sizes)

    # populated by build_plan; excluded from the frozen public fields above
    _all_sizes: Dict[str, int] = dataclasses.field(default_factory=dict,
                                                   repr=False, compare=False)

    def build_maps(self) -> LevelMaps:
        """The F/T/R/G matrices this plan's transition applies (numpy; call
        ``.as_torch(device)`` before applying them)."""
        wmats: Dict[str, proj.WidthMats] = {}
        if self.width:
            for ax, n in self.width_axes.items():
                if ax == "embed_cat2":
                    continue
                wmats[ax] = proj.width_mats(n, self.ml.width_variant)
            if "embed" in wmats:
                wmats["embed_cat2"] = proj.block_diag_width(wmats["embed"], 2)
        dmats: Dict[str, proj.DepthMats] = {}
        if self.depth:
            for name, (large, _small) in self.depth_groups.items():
                dmats[name] = proj.depth_mats(large, self.ml.depth_variant)
        return LevelMaps(width=wmats, depth=dmats)

    def describe(self) -> str:
        """Human-readable plan summary (verbose V-cycle logs, docs, tests)."""
        lines = [f"ProjectionPlan[{self.family}] "
                 f"{self.cfg.name or '?'} -> {self.small_cfg.name or '?'} "
                 f"(hooks: {', '.join(self.hooks)})"]
        if self.width:
            ax = ", ".join(f"{a}:{n}->{n // 2}"
                           for a, n in sorted(self.width_axes.items()))
            lines.append(f"  width axes   : {ax or '(none halvable)'}")
        if self.depth:
            dg = ", ".join(f"{k}:{a}->{b}"
                           for k, (a, b) in sorted(self.depth_groups.items()))
            lines.append(f"  depth groups : {dg or '(none)'}")
        lines.append(f"  protected    : {', '.join(self.protected_axes)}")
        if self.role_overrides:
            ov = ", ".join(f"{a}->{r}" for a, r in self.role_overrides.items())
            lines.append(f"  overrides    : {ov}")
        if self.carried:
            ca = ", ".join(f"{k}={v}" for k, v in sorted(self.carried.items()))
            lines.append(f"  carried      : {ca}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def axis_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """Current size of every width-coalescible axis present in this model
    (the pre-plan ``operators.axis_sizes`` contract, now hook-derived)."""
    d = _Draft()
    for h in FAMILY_HOOKS:
        if h.applies(cfg):
            h.contribute(d, cfg, MultiLevelConfig(), True, True)
    return d.sizes


def build_plan(cfg: ModelConfig, ml: Optional[MultiLevelConfig] = None,
               *, width: bool = True, depth: bool = True) -> ProjectionPlan:
    """Assemble the :class:`ProjectionPlan` for one level transition.

    ``width``/``depth`` switches support the single-direction baselines
    (StackBERT = depth-only, bert2BERT = width-only).
    """
    ml = ml or MultiLevelConfig()
    d = _Draft()
    for h in FAMILY_HOOKS:
        if h.applies(cfg):
            h.contribute(d, cfg, ml, width, depth)
            d.hooks.append(h.name)
    if not width:
        # single-direction baselines keep width fields untouched
        for k in ("d_model", "n_heads", "n_kv_heads", "d_ff", "q_lora_rank",
                  "kv_lora_rank", "moe_d_ff", "n_experts", "moe_top_k",
                  "mamba_dt_rank"):
            d.kw.pop(k, None)
        d.kw["head_dim"] = cfg.resolved_head_dim
    small_cfg = cfg.replace(**d.kw)
    halvable = {ax: n for ax, n in d.sizes.items()
                if ax != "embed_cat2" and n >= 2 and n % 2 == 0} if width else {}
    if "embed" in halvable:
        halvable["embed_cat2"] = d.sizes["embed_cat2"]
    depth_groups: Dict[str, Tuple[int, int]] = {}
    if depth:
        for i, st in enumerate(cfg.stages):
            depth_groups[f"stage_{i}"] = (st.repeats, small_cfg.stages[i].repeats)
        if cfg.n_encoder_layers:
            depth_groups["encoder"] = (cfg.n_encoder_layers,
                                       small_cfg.n_encoder_layers)
    return ProjectionPlan(
        family=cfg.family, hooks=tuple(d.hooks), cfg=cfg, small_cfg=small_cfg,
        ml=ml, width=width, depth=depth, width_axes=halvable,
        protected_axes=tuple(d.protected), role_overrides=dict(d.overrides),
        depth_groups=depth_groups, carried=dict(d.carried),
        notes=tuple(d.notes), _all_sizes=dict(d.sizes))
