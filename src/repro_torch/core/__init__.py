"""The paper's primary contribution: multi-level V-cycle training (the
counterpart of ``repro/core``).

operators.py    Coalescing / De-coalescing / Interpolation (Eqs. 1-13)
plans.py        per-family projection plans
projections.py  F/R/G/T matrix builders (stack & adj variants, App. E)
vcycle.py       Algorithm 1 + FLOPs-indexed training histories
baselines.py    StackBERT / bert2BERT / LiGO / Network Expansion / KI
flops.py        analytic FLOPs accounting
"""
from repro_torch.core.operators import (  # noqa: F401
    build_level_maps,
    coalesce,
    coalesce_config,
    decoalesce,
    interpolate,
    make_coalesce_fn,
    make_decoalesce_fn,
    make_interpolate_fn,
)
from repro_torch.core.vcycle import (  # noqa: F401
    History,
    SegmentPlan,
    VCycleOutput,
    VCycleRunner,
    VCycleState,
    flops_to_reach,
    run_scratch,
    run_vcycle,
    saving_vs_baseline,
    segments,
    train_segment,
)
