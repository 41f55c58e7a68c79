"""V-cycle training process (paper Algorithm 1) + the training loop with a
FLOPs-indexed loss history (the counterpart of ``repro/core/vcycle.py``,
without its mesh, drain-flag, gradient-reduction and error-feedback
branches).

* ``segments(cfg, ml, tc)`` materializes Algorithm 1 as a deterministic
  schedule of :class:`SegmentPlan` entries -- the downward sweep (init-train
  ``E_a`` per level, then coalesce), the upward sweep (train ``E_small``,
  then de-coalesce + interpolate) and the final full-size segment.
* :class:`VCycleState` carries everything needed to re-enter training at an
  arbitrary (phase, level, step), the ``params_before`` stash included.
* :class:`VCycleRunner` owns the per-level model stack and a per-level
  train-step cache: each level's step function is built at most once per run
  although every level below the top is visited twice; ``n_compiles`` counts
  the step functions built.  Level transitions run the operators of
  ``core/operators.py`` (the ``coalesce_pair`` and ``interp_axpy`` kernels
  on the card) and the optimizer is re-initialized at each transition
  (paper App. C), so its step count, warm-up and schedule restart.

Entry points (``run_vcycle``, ``run_scratch``, ``VCycleRunner``) run on the
CUDA card unless given ``device=``; with neither they raise.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, MultiLevelConfig, TrainConfig
from repro_torch.core import flops as flops_lib
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.device import default_device
from repro_torch.models.api import Model, build_model, make_train_step
from repro_torch.optim import adamw_init


@dataclasses.dataclass
class History:
    """Loss trace indexed by cumulative training FLOPs."""

    flops: List[float] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    step: List[int] = dataclasses.field(default_factory=list)
    level: List[int] = dataclasses.field(default_factory=list)

    def log(self, f: float, l: float, s: int, lv: int):
        self.flops.append(float(f))
        self.loss.append(float(l))
        self.step.append(int(s))
        self.level.append(int(lv))

    def smoothed(self, window: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray(self.loss)
        fl = np.asarray(self.flops)
        if len(lo) < window:
            return fl, lo
        kernel = np.ones(window) / window
        sm = np.convolve(lo, kernel, mode="valid")
        return fl[window - 1:], sm

    def to_dict(self) -> Dict[str, list]:
        return {"flops": list(self.flops), "loss": list(self.loss),
                "step": list(self.step), "level": list(self.level)}


def flops_to_reach(hist: History, target: float, window: int = 5) -> Optional[float]:
    """First cumulative-FLOPs point where the smoothed loss crosses ``target``."""
    fl, sm = hist.smoothed(window)
    idx = np.nonzero(sm <= target)[0]
    return float(fl[idx[0]]) if len(idx) else None


def saving_vs_baseline(base: History, ours: History, window: int = 5) -> Dict[str, float]:
    """The paper's headline metric: FLOPs saving at the baseline's final quality."""
    _, sm = base.smoothed(window)
    target = float(sm[-1])
    f_base = flops_to_reach(base, target, window) or base.flops[-1]
    f_ours = flops_to_reach(ours, target, window)
    if f_ours is None:
        return {"target_loss": target, "flops_saving": float("nan"),
                "base_flops": f_base, "ours_flops": float("nan")}
    return {"target_loss": target, "flops_saving": 1.0 - f_ours / f_base,
            "base_flops": f_base, "ours_flops": f_ours}


# ---------------------------------------------------------------------------
# generic training segment


def _train_loop(step_fn, batch_fn, steps: int, start_in_seg: int, params,
                opt_state, history: History, cum: float, g: int, level: int,
                fps: float, log_every: int, target_loss: Optional[float],
                on_step=None, sync_every_step: bool = False):
    """The one segment inner loop, shared by ``train_segment`` and
    ``VCycleRunner`` so log cadence, FLOPs accounting and the smoothed
    target-loss early stop cannot drift apart.

    ``g`` is the global step (keys the deterministic ``batch_fn``); ``i``
    indexes within the segment (keys the log cadence), starting at
    ``start_in_seg`` when resuming.  ``on_step(i, params, opt_state, cum, g,
    stop, dt)`` fires after each step's bookkeeping with the step's wall
    time; ``sync_every_step`` reads the loss every step so ``dt`` includes
    the device's work.  The target-loss window covers the current segment's
    entries only (recovered from ``history.step``).
    """
    seg_base = bisect.bisect_right(history.step, g - start_in_seg)
    for i in range(start_in_seg, steps):
        batch = batch_fn(g)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if sync_every_step:
            float(metrics["loss"])
        dt = time.time() - t0
        cum += fps
        g += 1
        stop = False
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            history.log(cum, loss, g, level)
            if target_loss is not None and len(history.loss) >= 5:
                seg_loss = np.asarray(history.loss[seg_base:])
                w = min(5, len(seg_loss))
                if w and float(seg_loss[-w:].mean()) <= target_loss:
                    stop = True
        if on_step is not None:
            on_step(i, params, opt_state, cum, g, stop, dt)
        if stop:
            break
    return params, opt_state, cum, g


def train_segment(
    model: Model,
    tc: TrainConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    steps: int,
    *,
    params=None,
    opt_state=None,
    history: Optional[History] = None,
    start_flops: float = 0.0,
    start_step: int = 0,
    level: int = 0,
    seed: int = 0,
    target_loss: Optional[float] = None,
    step_fn=None,
    device=None,
):
    """Train ``model`` for ``steps`` optimizer steps, logging (flops, loss).
    Fresh parameters are drawn on ``device`` (resolved as ``run_vcycle``
    does) from a generator seeded with ``seed``."""
    history = history if history is not None else History()
    if params is None:
        dev = default_device(device)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if opt_state is None:
        opt_state = adamw_init(params, tc)
    if step_fn is None:
        step_fn = make_train_step(model, tc)
    specs = model.specs()
    fps = flops_lib.train_step_flops(model.cfg, specs, tc.batch_size, tc.seq_len)
    params, opt_state, cum, g = _train_loop(
        step_fn, batch_fn, steps, 0, params, opt_state, history,
        start_flops, start_step, level, fps, tc.log_every, target_loss)
    return params, opt_state, history, cum, g


# ---------------------------------------------------------------------------
# the V-cycle (Algorithm 1) as an explicit state machine


@dataclasses.dataclass
class VCycleOutput:
    params: Any
    history: History
    configs: List[ModelConfig]
    total_flops: float


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One training segment of Algorithm 1.

    The transition *after* a segment is implied by its phase: ``down`` stashes
    ``params_before[level]`` and coalesces to ``level + 1``; ``up``
    de-coalesces to ``level - 1`` and interpolates with the stash; ``final``
    has no successor.
    """

    phase: str  # "down" | "up" | "final"
    level: int
    steps: int


def segments(cfg: ModelConfig, ml: MultiLevelConfig, tc: TrainConfig,
             *, final_steps: Optional[int] = None) -> List[SegmentPlan]:
    """Deterministic segment schedule for Algorithm 1: E_a init steps per
    level before coalescing, E_small steps for every level below the top on
    the way up, then the top level's final segment (``tc.steps`` or
    ``final_steps``, optionally cut short by a target loss)."""
    del cfg  # the schedule depends only on (ml, tc)
    K = ml.n_levels
    E_a = max(int(round(tc.steps * ml.e_a_frac)), 1)
    E_small = max(int(round(tc.steps * ml.e_small_frac)), 1)
    plan = [SegmentPlan("down", l, E_a) for l in range(K - 1)]
    plan += [SegmentPlan("up", l, E_small) for l in range(K - 1, 0, -1)]
    plan.append(SegmentPlan("final", 0,
                            final_steps if final_steps is not None else tc.steps))
    return plan


@dataclasses.dataclass
class VCycleState:
    """Everything needed to re-enter ``VCycleRunner.run`` at an arbitrary
    (phase, level, step): the schedule position (``seg_index``, ``seg_step``
    = completed steps within the segment), the global step, cumulative
    FLOPs, the history, and ``params_before`` (level -> the pre-coalesce
    parameters that Interpolation consumes on the way up)."""

    phase: str = "down"
    level: int = 0
    seg_index: int = 0
    seg_step: int = 0
    global_step: int = 0
    cum_flops: float = 0.0
    history: History = dataclasses.field(default_factory=History)
    params_before: Dict[int, Any] = dataclasses.field(default_factory=dict)


class VCycleRunner:
    """Runs Algorithm 1.

    Owns the per-level model stack (configs derived from one
    :class:`~repro_torch.core.plans.ProjectionPlan` per transition, so config
    halving and the maps the transitions apply cannot disagree) and the
    per-level train-step cache.  ``run`` may be entered fresh or from a
    :class:`VCycleState` with its parameters; a ``ckpt_cb(state, params,
    opt_state)`` hook fires every ``ckpt_every`` global steps and
    ``on_step(state, params, opt_state, stopping, dt)`` on every step.
    """

    def __init__(self, cfg: ModelConfig, ml: MultiLevelConfig, tc: TrainConfig,
                 batch_fn: Callable[[int], Dict[str, torch.Tensor]], *,
                 seed: int = 0, target_loss: Optional[float] = None,
                 final_steps: Optional[int] = None, verbose: bool = False,
                 device=None):
        self.ml, self.tc, self.batch_fn = ml, tc, batch_fn
        self.seed, self.target_loss, self.verbose = seed, target_loss, verbose
        self.device = default_device(device)
        # proj_plans[l] is the family contract for level l <-> l+1; note that
        # ``self.plan`` (no s) is the segment schedule
        self.cfgs = [cfg]
        self.proj_plans = []
        for _ in range(ml.n_levels - 1):
            p = plans_lib.build_plan(self.cfgs[-1], ml)
            self.proj_plans.append(p)
            self.cfgs.append(p.small_cfg)
        self.models = [build_model(c) for c in self.cfgs]
        self.specs = [m.specs() for m in self.models]
        self.plan = segments(cfg, ml, tc, final_steps=final_steps)
        if verbose:
            for p in self.proj_plans:
                print("[vcycle] " + p.describe().replace("\n", "\n[vcycle] "))
        self.state: Optional[VCycleState] = None
        self._step_fns: Dict[int, Callable] = {}
        self.n_compiles = 0  # step functions built: must end up == #levels visited

    def step_fn(self, level: int) -> Callable:
        """The train step for ``level`` (built once, then cached)."""
        fn = self._step_fns.get(level)
        if fn is None:
            fn = make_train_step(self.models[level], self.tc)
            self._step_fns[level] = fn
            self.n_compiles += 1
        return fn

    def init_state(self) -> Tuple[VCycleState, Any]:
        """Fresh (state, params) for an uninterrupted run, drawn on the
        runner's device from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return VCycleState(), self.models[0].init(gen)

    def _transition(self, state: VCycleState, plan: SegmentPlan, params):
        """Apply the post-segment operator (Alg. 1 lines 3-4 / 7-9)."""
        l = plan.level
        if plan.phase == "down":
            state.params_before[l] = params
            if self.verbose:
                print(f"[vcycle] level {l} init-trained {plan.steps} steps, coalescing")
            return ops.make_coalesce_fn(self.specs[l], self.cfgs[l], self.ml,
                                        plan=self.proj_plans[l])(params)
        if plan.phase == "up":
            if self.verbose:
                print(f"[vcycle] level {l} trained {plan.steps} steps, de-coalescing")
            de = ops.make_decoalesce_fn(self.specs[l - 1], self.cfgs[l - 1], self.ml,
                                        plan=self.proj_plans[l - 1])(params)
            # pop, don't read: the stash is consumed here
            before = state.params_before.pop(l - 1)
            return ops.make_interpolate_fn(
                self.ml.alpha, backend=self.cfgs[l - 1].kernel_backend or None)(before, de)
        return params

    def run(self, *, state: Optional[VCycleState] = None, params=None,
            opt_state=None, ckpt_cb=None, ckpt_every: int = 0,
            on_step=None) -> VCycleOutput:
        """Run (or resume) the V-cycle to completion.

        Fresh run: call with no arguments.  Resume: pass ``state`` +
        ``params`` (+ ``opt_state`` when mid-segment).  Data order is keyed
        on ``state.global_step`` and transitions replay deterministically, so
        a resumed run is equivalent to an uninterrupted one.
        """
        if state is None:
            state, params = self.init_state()
        elif params is None:
            raise ValueError("resuming from a VCycleState requires params")
        self.state = state
        tc = self.tc
        while state.seg_index < len(self.plan):
            plan = self.plan[state.seg_index]
            state.phase, state.level = plan.phase, plan.level
            fn = self.step_fn(plan.level)
            if opt_state is None:  # re-init at transitions (paper App. C)
                opt_state = adamw_init(params, tc)
            fps = flops_lib.train_step_flops(
                self.cfgs[plan.level], self.specs[plan.level],
                tc.batch_size, tc.seq_len)

            def _on_step(i, p, o, cum, g, stopping, dt):
                state.cum_flops, state.global_step = cum, g
                state.seg_step = i + 1
                # never checkpoint the stopping step: a restart from it would
                # resume into training the early exit already cut off
                if (ckpt_cb is not None and ckpt_every and not stopping
                        and g % ckpt_every == 0):
                    ckpt_cb(state, p, o)
                if on_step is not None:
                    on_step(state, p, o, stopping, dt)

            params, opt_state, state.cum_flops, state.global_step = _train_loop(
                fn, self.batch_fn, plan.steps, state.seg_step, params,
                opt_state, state.history, state.cum_flops, state.global_step,
                plan.level, fps, tc.log_every,
                self.target_loss if plan.phase == "final" else None,
                on_step=_on_step, sync_every_step=on_step is not None)
            params = self._transition(state, plan, params)
            state.seg_index += 1
            state.seg_step = 0
            opt_state = None
        return VCycleOutput(params=params, history=state.history,
                            configs=self.cfgs, total_flops=state.cum_flops)


def run_vcycle(
    cfg: ModelConfig,
    ml: MultiLevelConfig,
    tc: TrainConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    *,
    seed: int = 0,
    target_loss: Optional[float] = None,
    final_steps: Optional[int] = None,
    verbose: bool = False,
    device=None,
) -> VCycleOutput:
    """Paper Algorithm 1 (thin wrapper over :class:`VCycleRunner`)."""
    runner = VCycleRunner(cfg, ml, tc, batch_fn, seed=seed, target_loss=target_loss,
                          final_steps=final_steps, verbose=verbose, device=device)
    return runner.run()


def run_scratch(
    cfg: ModelConfig,
    tc: TrainConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    *,
    seed: int = 0,
    steps: Optional[int] = None,
    device=None,
) -> Tuple[Any, History]:
    """The from-scratch baseline: ``steps`` (default ``tc.steps``) steps of
    the full model on the same batches."""
    dev = default_device(device)
    model = build_model(cfg)
    params, _, hist, _, _ = train_segment(
        model, tc, batch_fn, steps or tc.steps, seed=seed, level=0, device=dev)
    return params, hist
