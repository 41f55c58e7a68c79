"""Training launcher: the counterpart of ``repro/launch/train.py``.

* the V-cycle schedule (``--vcycle``) or training from scratch;
* data, tensor and expert parallelism across processes: ``--mesh DxM`` (or
  ``PxDxM``) with ``--coordinator HOST:PORT --num-processes N --process-id
  I`` runs one process per device (``launch/mesh.py``); each process trains
  on its data coordinate's rows of the same global batch.  Each process
  holds its blocks of the parameters and moments (``models/api.py::
  train_state_shardings``): split over the data axes by ``embed`` (FSDP,
  the default ``--grad-compression none``: the weights gathered per layer,
  ``distributed/fsdp.py``) and, on a "model" axis of M > 1, over heads, FFN
  columns, experts, vocabulary rows, Mamba channels and xLSTM heads (tensor
  and expert parallelism: the layers meet at their collectives).
  ``--grad-compression dense|int8_ef`` names an explicit reduction over the
  data axes instead (``distributed/reduce.py``; int8 + error feedback
  across the "pod" axis, or across "data" without one), on the same
  layout.  Replicated leaves stay bit-identical on every process.  Logging
  and the watchdog are process 0's;
* fault tolerance: atomic asynchronous checkpoints every ``--ckpt-every``
  steps with auto-resume; V-cycle runs save and restore the whole mid-cycle
  state (phase, level, step within the segment, the FLOPs history, the
  interpolation stashes), so a kill at any point -- in the middle of the
  upward sweep too -- resumes to the same result as an uninterrupted run, and
  a terminal ``phase="done"`` checkpoint makes a re-invocation a no-op;
* preemption: SIGTERM sets a flag; the loop takes one final blocking
  checkpoint at the next step boundary and exits 0;
* a step-time watchdog flagging steps slower than ``factor`` times the
  median of the steps before them;
* deterministic synthetic data: every batch is a function of (seed, step).

It runs on the CUDA card unless given ``--device cpu``.  Checkpoints hold
logical arrays (a coordinated save writes each split leaf's blocks once and
each replicated leaf once), so a dense run resumes on another mesh shape or
process count.  The EF state is checkpointed with the rest
(``payload["ef"]``, ``meta["has_ef"]``, the reference's layout; the port
adds ``meta["ef_rows"]``, the slow axis's size, to refuse another mesh).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-base --vcycle \\
      --steps 40 --batch 8 --seq 1024 --ckpt-dir /path/to/ck --ckpt-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-proxy --vcycle \\
      --steps 20 --batch 2 --seq 16 --ckpt-dir /path/to/ck --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
      --smoke --vcycle --steps 20 --batch 2 --seq 16 --device cpu
  # two processes (one per terminal; the same command but --process-id),
  # sharing a checkpoint directory (or --ckpt-local-dir DIR_OF_THIS_PROCESS)
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-proxy --vcycle \\
      --steps 20 --batch 4 --seq 16 --device cpu --mesh 2x1 \\
      --grad-compression int8_ef --coordinator 127.0.0.1:PORT \\
      --num-processes 2 --process-id 0 --ckpt-dir /path/to/ck --ckpt-every 5
  # FSDP: the same without --grad-compression (each process half of every
  # leaf with an embed dim); tensor parallelism: --mesh 1x2 (each process
  # half the heads, FFN columns and vocabulary rows)
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig, MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config, paper_models
from repro_torch.core.vcycle import History, VCycleOutput, VCycleRunner, VCycleState
from repro_torch.data import (MarkovLM, lm_batch, masked_lm_batch, stub_frontend_inputs,
                              vision_batch)
from repro_torch.device import default_device
from repro_torch.distributed import (FusedDrainFlag, any_process_flag, as_global_batch_fn,
                                     data_shard_index, is_primary, make_grad_reduce,
                                     process_count, put_global_tree, shard_tree)
from repro_torch.launch.mesh import (init_distributed, make_cli_mesh, parse_mesh_arg,
                                     rank_device)
from repro_torch.models.api import (build_model, init_train_state,
                                    make_train_step, train_state_shardings,
                                    zero_train_state)
from repro_torch.optim import adamw_init
from repro_torch.models.vit import n_patches, patch_dim


def make_batch_fn(cfg: ModelConfig, tc: TrainConfig, shard: int = 0, *,
                  device=None) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``step -> batch`` on ``device`` (the CUDA card unless given): class-
    conditional patches for the ViT family, MLM batches for encoders (the
    last vocabulary id is [MASK]), causal LM batches otherwise.  The VLM and
    audio families' stub frontends add ``img_embeds`` / ``enc_frames``:
    tensors of ones in the compute dtype, as the reference feeds them."""
    dev = default_device(device)
    if cfg.family == "vit":
        return lambda step: vision_batch(tc.seed, step, tc.batch_size, n_patches(cfg),
                                         patch_dim(cfg), cfg.n_classes, shard, device=dev)
    chain = MarkovLM(cfg.vocab_size)
    if cfg.family == "encoder":
        mask_id = cfg.vocab_size - 1
        return lambda step: masked_lm_batch(chain, tc.seed, step, tc.batch_size, tc.seq_len,
                                            mask_id, shard=shard, device=dev)
    extras = stub_frontend_inputs(cfg, tc.batch_size, dev)
    return lambda step: dict(lm_batch(chain, tc.seed, step, tc.batch_size, tc.seq_len, shard,
                                      device=dev), **extras)


def make_driver_batch_fn(cfg: ModelConfig, tc: TrainConfig, mesh=None, *, device=None):
    """The launcher's batch stream of this process.  One process: the shard
    ``data_shard_index`` names (0), the whole batch.  Several: every process
    regenerates the canonical shard-0 batch and keeps the rows its data
    coordinate addresses, so the global stream does not depend on the
    process count."""
    if process_count() > 1:
        return as_global_batch_fn(make_batch_fn(cfg, tc, shard=0, device=device), mesh)
    return make_batch_fn(cfg, tc, shard=data_shard_index(mesh), device=device)


class Watchdog:
    """Step-time straggler detector."""

    def __init__(self, factor: float = 3.0):
        self.times: list = []
        self.factor = factor
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        # the median over PRIOR samples only (a spike must not dilute its own
        # baseline), over a trailing window of 50
        prior = self.times[-50:]
        self.times = prior + [dt]
        if len(prior) >= 10:
            med = float(np.median(prior))
            if dt > self.factor * med:
                self.flagged += 1
                print(f"[watchdog] slow step: {dt*1e3:.0f}ms vs median {med*1e3:.0f}ms")
                return True
        return False


class PreemptionGuard:
    """SIGTERM-aware preemption notice, agreed across processes.

    The handler only sets a flag; the training loops poll
    :meth:`should_stop` once per step and take ONE final blocking checkpoint
    before exiting 0, instead of waiting for the ``--ckpt-every`` cadence.
    With several processes the poll is a collective, so the drivers call it
    on every process every step: a SIGTERM on any one process drains all of
    them at the same step, through the same coordinated save.  With a
    ``distributed.FusedDrainFlag`` attached (both drivers attach one on a
    multi-process mesh) the OR rides each step's metrics all-reduce;
    without one, ``should_stop`` all-reduces the flag itself, a branch that
    serves one process and library callers (the drivers never take it with
    several processes).
    """

    def __init__(self):
        self.triggered = False
        self.fused: Optional[FusedDrainFlag] = None

    def attach(self, drain_flag: FusedDrainFlag) -> FusedDrainFlag:
        """Bind a fused drain flag: ``should_stop`` then reads the last
        step's summed flag instead of all-reducing."""
        self.fused = drain_flag
        drain_flag.guard = self
        return drain_flag

    def install(self, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        for s in signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:  # not the main thread (e.g. embedded in a test)
                break
        return self

    def _handler(self, signum, frame):
        self.triggered = True
        print(f"[preempt] caught signal {signum}; will checkpoint and exit at "
              "the next step boundary", flush=True)

    def should_stop(self) -> bool:
        """True when ANY process holds a preemption notice (a collective with
        several processes: call it on every process, once per step)."""
        if self.fused is not None:
            # the OR ran inside the step; with one process the local flag
            # also covers a notice that came before the first step
            return self.fused.last() or (process_count() == 1 and self.triggered)
        return any_process_flag(self.triggered)


def _attach_drain(preempt: Optional[PreemptionGuard], mesh) -> Optional[FusedDrainFlag]:
    """A fused drain flag bound to ``preempt`` on a multi-process mesh."""
    if preempt is None or mesh is None or process_count() == 1:
        return None
    return preempt.attach(FusedDrainFlag())


def _block(metrics) -> None:
    """Wait for the step's device work (the loss is its last result)."""
    loss = metrics["loss"]
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def _report_reduce_probe(tc: TrainConfig, verbose: bool) -> None:
    """Check that the compressed reduction really ran (its call probe), not
    only that it was configured, and say so."""
    if tc.grad_compression != "int8_ef":
        return
    from repro_torch.distributed.compression import ef_psum_calls

    n = ef_psum_calls()
    if n <= 0:
        raise RuntimeError("--grad-compression int8_ef was requested but ef_int8_psum "
                           "never ran")
    if verbose:
        print(f"[reduce] probe: ef_int8_psum ran {n} time(s)", flush=True)


def _refuse_ef(meta: dict, gr) -> bool:
    """Whether the checkpoint of ``meta`` carries EF state; raises unless
    ``gr`` can take it: a stateful strategy whose slow axis has as many
    ranks as the state has rows (the same mesh shape)."""
    if not meta.get("has_ef"):
        return False
    if gr is None or not gr.stateful:
        raise ValueError("checkpoint carries grad-reduction (EF) state; resume with "
                         "--grad-compression int8_ef on the same mesh shape")
    rows = meta.get("ef_rows", gr.dcn_size)
    if rows != gr.dcn_size:
        raise ValueError(f"checkpoint carries EF state of {rows} rows, one per rank of "
                         f"its mesh's slow axis, and this mesh's has {gr.dcn_size}: "
                         f"resume with --grad-compression int8_ef on the same mesh shape")
    return True


def _ef_meta(gr, ef) -> dict:
    """The EF entries of a checkpoint's meta."""
    if ef is None:
        return {"has_ef": False}
    return {"has_ef": True, "ef_rows": gr.dcn_size}


def train_plain(cfg: ModelConfig, tc: TrainConfig, *, ckpt: Optional[CheckpointManager],
                ckpt_every: int, verbose: bool = True,
                preempt: Optional[PreemptionGuard] = None, device=None, mesh=None):
    """Training from scratch with checkpoints and auto-resume; returns the
    parameters (this process's blocks on a mesh).  With a ``mesh`` the step
    is the FSDP one ("none") or the 4-ary one of ``tc.grad_compression``,
    whose stateful strategy's EF state is checkpointed with the rest."""
    dev = default_device(device)
    model = build_model(cfg)
    batch_fn = make_driver_batch_fn(cfg, tc, mesh, device=dev)
    params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
    gr = make_grad_reduce(tc.grad_compression, mesh)
    psh = osh = None
    if mesh is not None:  # every process drew the same values: keep its blocks
        psh, osh = train_state_shardings(model, tc, mesh)
        params = put_global_tree(params, psh, mesh)
        opt = adamw_init(params, tc)
    ef = gr.init_state(params, psh) if gr is not None and gr.stateful else None
    start = 0
    if ckpt is not None:
        has_ef = _refuse_ef((ckpt.latest() or {}).get("meta", {}), gr)
        like = {"params": shard_tree(params, psh, mesh), "opt": shard_tree(opt, osh, mesh)}
        if has_ef:
            like["ef"] = gr.state_shards(ef, psh)
        restored, meta = ckpt.restore(like)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            if has_ef:
                ef = restored["ef"]
            start = int(meta.get("step", 0))
            if verbose:
                print(f"[train] resumed from step {start}")
    if gr is None:
        step_fn = make_train_step(model, tc, mesh=mesh, drain_flag=_attach_drain(preempt, mesh))
    else:
        fn4 = make_train_step(model, tc, grad_reduce=gr, mesh=mesh,
                              drain_flag=_attach_drain(preempt, mesh))

        def step_fn(p, o, b):
            nonlocal ef
            p, o, ef, m = fn4(p, o, ef, b)
            return p, o, m

    def _snapshot(step):
        payload = {"params": shard_tree(params, psh, mesh), "opt": shard_tree(opt, osh, mesh)}
        if ef is not None:
            payload["ef"] = gr.state_shards(ef, psh)  # the residuals resume with the run
        return payload, {"step": step, **_ef_meta(gr, ef)}

    wd = Watchdog() if is_primary() else None
    for i in range(start, tc.steps):
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch_fn(i))
        # a heartbeat every step: wait for the device, fetch the loss only
        # on log steps
        _block(metrics)
        if wd is not None:
            wd.observe(time.time() - t0)
        # polled on every process every step (a collective with several)
        if preempt is not None and preempt.should_stop():
            if ckpt is not None:
                payload, meta = _snapshot(i + 1)
                ckpt.save(i + 1, payload, meta=meta, blocking=True)
                print(f"[preempt] SIGTERM: final checkpoint at step {i + 1}; "
                      "exiting", flush=True)
            raise SystemExit(0)
        if i % tc.log_every == 0 and verbose:
            print(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}")
        if ckpt is not None and ckpt_every and i and i % ckpt_every == 0:
            payload, meta = _snapshot(i + 1)
            ckpt.save(i, payload, meta=meta, blocking=False)
    if ckpt is not None:
        payload, meta = _snapshot(tc.steps)
        ckpt.save(tc.steps, payload, meta=meta)
    _report_reduce_probe(tc, verbose)
    return params


def _schedule_meta(plan) -> list:
    """JSON form of a segment schedule, stored with every mid-cycle
    checkpoint so restore can refuse a mismatched (phase, level, step)."""
    return [[p.phase, p.level, p.steps] for p in plan]


def make_vcycle_save_cb(ckpt: CheckpointManager, schedule=None, grad_reduce=None,
                        runner: Optional[VCycleRunner] = None):
    """A ``VCycleRunner`` checkpoint hook writing the whole resumable state:
    the in-segment ``params`` and ``opt`` plus every stashed
    ``params_before_<level>`` tree, and as metadata (phase, level, seg_index,
    seg_step, global_step, cum_flops, stashed_levels, history, has_ef) plus
    the segment ``schedule`` (pass the runner's ``plan``); a stateful
    gradient reduction's EF state rides as ``ef``, as this process's rows of
    the global state (the runner's ``grad_reduce`` unless given).  With a
    ``runner`` on a mesh every tree is written as this process's blocks of
    its level's layout (``runner.level_shardings``); with several processes
    the trees are blocks, so the runner is required.  Saves are
    asynchronous with one process; ``CheckpointManager.save`` copies to the
    host before the loop updates anything."""
    sched = _schedule_meta(schedule) if schedule is not None else None
    if runner is None and process_count() > 1:
        raise ValueError("on several processes a V-cycle's trees are blocks of the mesh's "
                         "layout: pass the runner")
    if grad_reduce is None and runner is not None:
        grad_reduce = runner.grad_reduce

    def specs(level, which=0):
        return None if runner is None else runner.level_shardings(level)[which]

    def blocks(tree, level, which=0):
        return tree if runner is None else shard_tree(tree, specs(level, which), runner.mesh)

    def save_cb(state: VCycleState, params, opt_state, blocking: bool = False) -> None:
        stashed = sorted(state.params_before)
        payload = {"params": blocks(params, state.level),
                   "opt": blocks(opt_state, state.level, 1),
                   **{f"params_before_{l}": blocks(state.params_before[l], l)
                      for l in stashed}}
        if state.ef is not None:
            # the carried residuals: resuming without them would bias the
            # first steps after the restore
            payload["ef"] = (state.ef if grad_reduce is None
                             else grad_reduce.state_shards(state.ef, specs(state.level)))
        meta = {
            "step": state.global_step, "phase": state.phase, "level": state.level,
            "seg_index": state.seg_index, "seg_step": state.seg_step,
            "global_step": state.global_step, "cum_flops": state.cum_flops,
            "stashed_levels": stashed, "history": state.history.to_dict(),
            "has_ef": state.ef is not None}
        if state.ef is not None and grad_reduce is not None:
            meta["ef_rows"] = grad_reduce.dcn_size
        if sched is not None:
            meta["schedule"] = sched
        ckpt.save(state.global_step, payload, meta=meta, blocking=blocking)

    return save_cb


def restore_vcycle_state(ckpt: CheckpointManager, runner: VCycleRunner, tc: TrainConfig):
    """(state, params, opt_state) from the newest mid-cycle checkpoint, landed
    on the runner's device, with the EF state when the checkpoint carries
    one (the runner's strategy must be stateful then).  The like-trees come
    from ``zero_train_state`` of the checkpointed level's model, so no
    generator is drawn from.  Raises
    ``ValueError`` if the checkpoint's schedule (or its position) does not
    fit ``runner``'s -- resuming under other ``--steps``/``--levels`` would
    otherwise train the wrong schedule."""
    meta = ckpt.latest()["meta"]
    current = _schedule_meta(runner.plan)
    saved = meta.get("schedule")
    if saved is not None and [list(s) for s in saved] != current:
        raise ValueError(
            f"checkpoint was written under a different V-cycle schedule "
            f"({saved} vs current {current}); restart with the original "
            f"--steps/--levels or use a fresh --ckpt-dir")
    seg_index = int(meta["seg_index"])
    if (seg_index >= len(runner.plan)
            or int(meta["seg_step"]) > runner.plan[seg_index].steps):
        raise ValueError(
            f"checkpoint position (seg_index={seg_index}, "
            f"seg_step={meta['seg_step']}) lies outside the current schedule "
            f"{current}; restart with the original --steps/--levels")
    has_ef = _refuse_ef(meta, runner.grad_reduce)
    level = int(meta["level"])
    # global like-trees on the meta device, laid out for this runner's mesh
    # (none: whole), landed on its device
    like_p, like_o = zero_train_state(runner.models[level], tc, device="meta")
    like = {"params": like_p, "opt": like_o}
    psh, osh = runner.level_shardings(level)
    sh = {"params": psh, "opt": osh}
    if has_ef:  # this process's rows only
        like["ef"] = zero_train_state(runner.models[level], tc, device="meta",
                                      grad_reduce=runner.grad_reduce)[2]
        sh["ef"] = runner.ef_shardings(level)
    stashed = [int(l) for l in meta.get("stashed_levels", [])]
    for l in stashed:
        like[f"params_before_{l}"] = zero_train_state(runner.models[l], tc, device="meta")[0]
        sh[f"params_before_{l}"] = runner.level_shardings(l)[0]
    restored, meta = ckpt.restore(like, device=runner.device,
                                  shardings=sh if runner.mesh is not None else None,
                                  mesh=runner.mesh)
    state = VCycleState(
        phase=meta["phase"], level=level,
        seg_index=int(meta["seg_index"]), seg_step=int(meta["seg_step"]),
        global_step=int(meta["global_step"]), cum_flops=float(meta["cum_flops"]),
        history=History(**{k: list(v) for k, v in meta["history"].items()}),
        params_before={l: restored[f"params_before_{l}"] for l in stashed},
        ef=restored.get("ef"))
    return state, restored["params"], restored["opt"]


def train_vcycle_ckpt(cfg: ModelConfig, ml: MultiLevelConfig, tc: TrainConfig, *,
                      ckpt: Optional[CheckpointManager], ckpt_every: int,
                      verbose: bool = True, preempt: Optional[PreemptionGuard] = None,
                      device=None, mesh=None) -> VCycleOutput:
    """The V-cycle with (phase, level, step) checkpoint and resume; with a
    ``mesh``, data-parallel across its processes (``VCycleRunner(mesh=)``).

    Every ``ckpt_every`` global steps the runner's hook saves ``{params, opt,
    params_before_*}`` and the V-cycle state.  On restart this restores the
    newest checkpoint and re-enters ``VCycleRunner.run`` at the exact
    (phase, level, seg_step) -- in the middle of the upward sweep too, where
    the pending de-coalesce and interpolation replay from the in-segment
    parameters.  The batches are functions of the global step, so the
    resumed run equals an uninterrupted one.  A terminal ``phase="done"``
    checkpoint makes re-invocation after completion a no-op.  Checkpoints
    hold logical arrays, so the process count at restore may differ from
    the one that saved (the dense reduction).  The per-step hook carries the
    watchdog heartbeat and the preemption poll: a SIGTERM on any one process
    drains every process through one final blocking checkpoint at the same
    global step, then exit 0.
    """
    dev = default_device(device)
    batch_fn = make_driver_batch_fn(cfg, tc, mesh, device=dev)
    runner = VCycleRunner(cfg, ml, tc, batch_fn, seed=tc.seed, verbose=verbose, device=dev,
                          mesh=mesh, drain_flag=_attach_drain(preempt, mesh))
    state = params = opt = None
    if ckpt is not None:
        meta = (ckpt.latest() or {}).get("meta", {})
        if "phase" in meta:
            if meta["phase"] == "done":
                like_p, _ = zero_train_state(runner.models[0], tc, device="meta")
                restored, _ = ckpt.restore({"params": like_p}, device=dev,
                                           shardings={"params": runner.level_shardings(0)[0]},
                                           mesh=mesh)
                if verbose:
                    print("[vcycle] checkpoint already complete; returning saved params")
                return VCycleOutput(
                    params=restored["params"],
                    history=History(**{k: list(v) for k, v in
                                       meta.get("history", {}).items()}),
                    configs=runner.cfgs,
                    total_flops=float(meta.get("cum_flops", 0.0)))
            state, params, opt = restore_vcycle_state(ckpt, runner, tc)
            if verbose:
                print(f"[vcycle] resumed at phase={state.phase} level={state.level} "
                      f"seg_step={state.seg_step} global_step={state.global_step}",
                      flush=True)
    save_cb = (make_vcycle_save_cb(ckpt, schedule=runner.plan, grad_reduce=runner.grad_reduce,
                                   runner=runner)
               if ckpt is not None else None)
    # one watchdog PER LEVEL: a half-width level's steps are much cheaper, so
    # a shared median would flag every full-size step of the upward sweep
    wds: Optional[Dict[int, Watchdog]] = {} if is_primary() else None  # process 0's role

    def on_step(st: VCycleState, p, o, stopping: bool, dt: float) -> None:
        # dt is the runner's device-blocked step time; a segment's first step
        # may carry one-time costs and is not observed
        if wds is not None and st.seg_step > 1:
            wds.setdefault(st.level, Watchdog()).observe(dt)
        # the poll is a collective with several processes: every process
        # runs it every step.  A stopping step is never persisted (see
        # VCycleRunner.run), so a preemption on it lets the normal
        # completion path finish
        drain = preempt is not None and preempt.should_stop()
        if drain and not stopping:
            if save_cb is not None:
                save_cb(st, p, o, blocking=True)
                print(f"[preempt] SIGTERM: blocking V-cycle checkpoint at "
                      f"global_step {st.global_step}; exiting", flush=True)
            raise SystemExit(0)

    out = runner.run(state=state, params=params, opt_state=opt,
                     ckpt_cb=save_cb, ckpt_every=ckpt_every, on_step=on_step)
    if ckpt is not None:
        gs = runner.state.global_step
        ckpt.save(gs, {"params": shard_tree(out.params, runner.level_shardings(0)[0], mesh)},
                  meta={"step": gs, "phase": "done", "level": 0,
                        "global_step": gs, "cum_flops": out.total_flops,
                        "history": out.history.to_dict()})
    _report_reduce_probe(tc, verbose)
    if verbose:
        print(f"[vcycle] total training FLOPs: {out.total_flops:.3e}", flush=True)
    return out


PROXIES = {"gpt-proxy": paper_models.gpt_proxy, "bert-proxy": paper_models.bert_proxy,
           "deit-proxy": paper_models.deit_proxy}


def main(argv=None):
    """The launcher; returns what the driver returns (the V-cycle's
    ``VCycleOutput``, or the parameters), None for ``--describe-plans``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="a config of repro_torch.configs, or gpt-proxy, bert-proxy, "
                         "deit-proxy; for the ViT family the sequence length is "
                         "n_patches + 1 whatever --seq says")
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vcycle", action="store_true")
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--mesh", default="",
                    help="DxM ('data', 'model') mesh, e.g. 2x1 or 1x2, or PxDxM ('pod', "
                         "'data', 'model') with a leading slow axis, e.g. 2x2x1: one process "
                         "per device; 'model' > 1 splits heads, FFN columns, experts and "
                         "the vocabulary (tensor and expert parallelism)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "dense", "int8_ef"],
                    help="gradient reduction (distributed/reduce.py): 'none' is the "
                         "FSDP step on a mesh; 'dense' the explicit full-precision mean; "
                         "'int8_ef' "
                         "is dense within 'data' and int8 + error feedback across "
                         "'pod' (across 'data' without one). Needs --mesh")
    ap.add_argument("--coordinator", default="127.0.0.1:9876",
                    help="host:port of process 0's process-group store (several "
                         "processes), or file://PATH: process 0 binds a free port "
                         "and writes it there")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="process count; every process runs the same command with its "
                         "own --process-id")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--f32", action="store_true",
                    help="force float32 compute (default keeps the config's dtype)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory; with several processes, one directory "
                         "they all share")
    ap.add_argument("--ckpt-local-dir", default="",
                    help="a private checkpoint directory per process, for clusters "
                         "without a shared filesystem: each process passes its OWN "
                         "path; chunks stay on the local disk, manifests and missing "
                         "objects travel through the process group's store (overrides "
                         "--ckpt-dir)")
    ap.add_argument("--ckpt-dedup", action=argparse.BooleanOptionalAction, default=True,
                    help="content-addressed v3 checkpoint layout: unchanged leaves cost "
                         "no I/O across consecutive saves (--no-ckpt-dedup writes the "
                         "v2 whole-file layout)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--describe-plans", action="store_true",
                    help="print each V-cycle level transition's ProjectionPlan and exit "
                         "without training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args(argv)

    # the reference's argument checks
    if args.grad_compression != "none" and not args.mesh:
        ap.error("--grad-compression needs --mesh (the reduction axes live on the "
                 "mesh; use e.g. --mesh 2x1 or --mesh 2x1x1)")
    if args.num_processes > 1 and not args.mesh:
        args.mesh = f"{args.num_processes}x1"  # pure data-parallel default
    dims = parse_mesh_arg(args.mesh) if args.mesh else None
    if args.ckpt_local_dir and not args.ckpt_dedup:
        # the per-process protocol exchanges digests, which only the
        # content-addressed layout has
        ap.error("--no-ckpt-dedup is incompatible with --ckpt-local-dir (the "
                 "per-host store is content-addressed by design)")
    if args.arch in PROXIES:
        cfg = PROXIES[args.arch]()
    else:
        cfg = get_config(args.arch, smoke=args.smoke)
    if args.f32:
        cfg = cfg.replace(compute_dtype=torch.float32)
    ml = MultiLevelConfig(n_levels=args.levels, alpha=args.alpha)
    if args.describe_plans:
        from repro_torch.core import plans as plans_lib

        c = cfg
        for _ in range(ml.n_levels - 1):
            p = plans_lib.build_plan(c, ml)
            print(p.describe())
            c = p.small_cfg
        return
    dev = default_device(args.device)
    mesh = None
    if args.mesh:
        if args.num_processes > 1:
            dev = rank_device(dev, args.process_id)
            init_distributed(args.coordinator, args.num_processes, args.process_id,
                             device=dev)
        mesh = make_cli_mesh(args.mesh, num_processes=args.num_processes, device=dev)
        if args.num_processes > 1:
            print(f"[launch] process {args.process_id}/{args.num_processes} up on {dev}; "
                  f"data shard {data_shard_index(mesh)}", flush=True)
    primary = is_primary()
    tc = TrainConfig(steps=args.steps, warmup_steps=max(args.steps // 20, 1),
                     peak_lr=args.lr, batch_size=args.batch, seq_len=args.seq,
                     seed=args.seed, grad_compression=args.grad_compression)
    if cfg.family == "vit":
        tc = dataclasses.replace(tc, seq_len=n_patches(cfg) + 1)
    if args.grad_compression != "none" and primary:
        print(f"[reduce] grad-compression={args.grad_compression} over mesh {args.mesh} "
              f"(axes {mesh.mesh_dim_names})", flush=True)
    if args.ckpt_local_dir:
        ckpt = CheckpointManager(args.ckpt_local_dir, local=True)
    elif args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, dedup=args.ckpt_dedup)
    else:
        ckpt = None
    preempt = PreemptionGuard().install() if ckpt is not None else None
    try:
        if args.vcycle:
            return train_vcycle_ckpt(cfg, ml, tc, ckpt=ckpt, ckpt_every=args.ckpt_every,
                                     preempt=preempt, device=dev, mesh=mesh, verbose=primary)
        return train_plain(cfg, tc, ckpt=ckpt, ckpt_every=args.ckpt_every, preempt=preempt,
                           device=dev, mesh=mesh, verbose=primary)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
