"""The paper's five comparison baselines (Tables 1-3; the counterpart of
``repro/core/baselines.py``), against the same FLOPs-indexed ``History`` as
the V-cycle so savings are computed identically for every method.  All
"grow" methods include the small model's training cost, as the paper does
for fairness (§4.1 Baselines).

* StackBERT          -- depth-only: train an L/2 model, stack it.
* bert2BERT          -- width-only: function-preserving expansion (the width
                        de-coalescing matrices ARE the averaged Net2Net FPI).
* LiGO               -- learn the (width x depth) linear growth operator by
                        SGD on the mapped model's loss, then train on.
* Network Expansion  -- expand the EMA of the small model's parameters.
* KI                 -- knowledge inheritance: train the large model with a
                        distillation term from the trained small teacher.

Every entry point runs on the CUDA card unless given ``device=``; with
neither it raises.  The port's train step updates parameters in place,
which shapes two methods: Network Expansion's EMA starts as a copy of the
small model's initial parameters (not the tensors the optimizer then
writes), and LiGO fits its matrices against a detached copy of the trained
small model.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import flops as flops_lib
from repro_torch.core import operators as ops
from repro_torch.core import plans as plans_lib
from repro_torch.core import projections as proj
from repro_torch.core.vcycle import History, train_segment
from repro_torch.device import default_device
from repro_torch.models.api import build_model, make_train_step
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.param import flatten, tree_map, unflatten


def _grow_then_train(cfg, ml, tc, batch_fn, *, width: bool, depth: bool,
                     small_steps: int, final_steps: int, seed: int,
                     target_loss=None, ema_decay: Optional[float] = None,
                     depth_variant: Optional[str] = None, device=None) -> History:
    """Shared scaffold: train small -> expand -> train large."""
    dev = default_device(device)
    if depth_variant is not None:
        ml = dataclasses.replace(ml, depth_variant=depth_variant)
    plan = plans_lib.build_plan(cfg, ml, width=width, depth=depth)
    small_cfg = plan.small_cfg
    small = build_model(small_cfg)
    hist = History()
    params_s = small.init(torch.Generator(device=dev).manual_seed(seed))

    if ema_decay is None:
        params_s, _, hist, cum, g = train_segment(
            small, tc, batch_fn, small_steps, params=params_s, history=hist,
            level=1, seed=seed)
    else:  # Network Expansion: maintain an EMA during small training
        ema = tree_map(torch.clone, params_s)
        step_fn = make_train_step(small, tc)
        opt = adamw_init(params_s, tc)
        fps = flops_lib.train_step_flops(small_cfg, small.specs(), tc.batch_size, tc.seq_len)
        cum, g = 0.0, 0
        for i in range(small_steps):
            params_s, opt, metrics = step_fn(params_s, opt, batch_fn(g))
            with torch.no_grad():
                ema = tree_map(lambda a, b: ema_decay * a + (1 - ema_decay) * b,
                               ema, params_s)
            cum += fps
            g += 1
            if i % tc.log_every == 0:
                hist.log(cum, float(metrics["loss"]), g, 1)
        params_s = ema

    model = build_model(cfg)
    grow = ops.make_decoalesce_fn(model.specs(), cfg, ml, width=width, depth=depth,
                                  plan=plan)
    _, _, hist, cum, g = train_segment(
        model, tc, batch_fn, final_steps, params=grow(params_s), history=hist,
        start_flops=cum, start_step=g, level=0, seed=seed, target_loss=target_loss)
    return hist


def run_stackbert(cfg, ml, tc, batch_fn, *, small_steps=None, final_steps=None,
                  seed=0, target_loss=None, device=None) -> History:
    return _grow_then_train(
        cfg, ml, tc, batch_fn, width=False, depth=True, depth_variant="stack",
        small_steps=small_steps or tc.steps // 2, final_steps=final_steps or tc.steps,
        seed=seed, target_loss=target_loss, device=device)


def run_bert2bert(cfg, ml, tc, batch_fn, *, small_steps=None, final_steps=None,
                  seed=0, target_loss=None, device=None) -> History:
    return _grow_then_train(
        cfg, ml, tc, batch_fn, width=True, depth=False,
        small_steps=small_steps or tc.steps // 2, final_steps=final_steps or tc.steps,
        seed=seed, target_loss=target_loss, device=device)


def run_network_expansion(cfg, ml, tc, batch_fn, *, small_steps=None, final_steps=None,
                          seed=0, target_loss=None, device=None) -> History:
    return _grow_then_train(
        cfg, ml, tc, batch_fn, width=True, depth=True, ema_decay=0.999,
        small_steps=small_steps or tc.steps // 2, final_steps=final_steps or tc.steps,
        seed=seed, target_loss=target_loss, device=device)


# ---------------------------------------------------------------------------
# LiGO: learned linear growth operator


def run_ligo(cfg, ml, tc, batch_fn, *, small_steps=None, final_steps=None,
             fit_steps: int = 30, fit_lr: float = 1e-2, seed=0,
             target_loss=None, device=None) -> History:
    dev = default_device(device)
    plan = plans_lib.build_plan(cfg, ml)
    small = build_model(plan.small_cfg)
    model = build_model(cfg)
    specs = model.specs()
    hist = History()
    params_s, _, hist, cum, g = train_segment(
        small, tc, batch_fn, small_steps or tc.steps // 2, history=hist, level=1,
        seed=seed, device=dev)
    params_s = tree_map(torch.Tensor.detach, params_s)  # constants of the fit

    # trainable expansion: start from the plan's analytic de-coalescing
    # matrices.  WidthMats without a variant take the dense contraction,
    # which autograd records.
    maps0 = plan.build_maps().as_torch(dev)
    theta = flatten({
        "width": {ax: {"T_out": m.T_out, "T_in": m.T_in} for ax, m in maps0.width.items()},
        "depth": {k: {"G": d.G} for k, d in maps0.depth.items()},
    })

    def project(theta):
        t = unflatten(theta)
        width = {ax: proj.WidthMats(F_out=None, F_in=None, T_out=m["T_out"], T_in=m["T_in"])
                 for ax, m in t["width"].items()}
        depth = {k: proj.DepthMats(R=None, G=d["G"]) for k, d in t["depth"].items()}
        return ops.project_tree(params_s, specs, plans_lib.LevelMaps(width=width, depth=depth),
                                "decoalesce", plan.role_overrides)

    fit_fps = flops_lib.train_step_flops(cfg, specs, tc.batch_size, tc.seq_len)
    for i in range(fit_steps):  # SGD on the growth operator (LiGO's inner loop)
        leaves = {k: v.detach().requires_grad_() for k, v in theta.items()}
        batch = {k: v.to(dev) for k, v in batch_fn(g).items()}
        with torch.enable_grad():
            loss = model.loss(project(leaves), batch)[0]
            # an axis no leaf carries (embed_cat2) gets a zero gradient
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        theta = {k: v.detach() - fit_lr * d for (k, v), d in zip(leaves.items(), grads)}
        cum += fit_fps
        g += 1
        if i % tc.log_every == 0:
            hist.log(cum, loss.item(), g, 0)

    with torch.no_grad():
        params = project(theta)
    _, _, hist, cum, g = train_segment(
        model, tc, batch_fn, final_steps or tc.steps, params=params, history=hist,
        start_flops=cum, start_step=g, level=0, seed=seed, target_loss=target_loss)
    return hist


# ---------------------------------------------------------------------------
# KI: knowledge inheritance (distill the small teacher into the large student)


def run_ki(cfg, ml, tc, batch_fn, *, small_steps=None, final_steps=None,
           seed=0, target_loss=None, kd_weight: float = 0.5, device=None) -> History:
    dev = default_device(device)
    small_cfg = plans_lib.build_plan(cfg, ml).small_cfg
    small = build_model(small_cfg)
    model = build_model(cfg)
    hist = History()
    teacher, _, hist, cum, g = train_segment(
        small, tc, batch_fn, small_steps or tc.steps // 2, history=hist, level=1,
        seed=seed, device=dev)

    fs = final_steps or tc.steps

    def kd_grads(params, batch, step_frac):
        """Gradients of (1 - w) CE + w KL(teacher || student), with the
        inheritance weight w decaying over the run, and the metrics."""
        leaves = list(flatten(params).values())
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = model.loss(params, batch)
            with torch.no_grad():
                t_logits = small.forward_logits(teacher, batch)
            s_logits = model.forward_logits(params, batch)
            t_lp = torch.log_softmax(t_logits.float(), -1)
            s_lp = torch.log_softmax(s_logits.float(), -1)
            kl = (t_lp.exp() * (t_lp - s_lp)).sum(-1).mean()
            w = kd_weight * (1.0 - step_frac)
            grads = torch.autograd.grad((1 - w) * loss + w * kl, leaves,
                                        materialize_grads=True)
        return (unflatten(dict(zip(flatten(params), grads))),
                {k: v.detach() for k, v in metrics.items()})

    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(params, tc)
    # the student pays its own step, its extra forward and the teacher's
    fps = (flops_lib.train_step_flops(cfg, model.specs(), tc.batch_size, tc.seq_len)
           + flops_lib.forward_flops(cfg, model.specs(), tc.batch_size, tc.seq_len)
           + flops_lib.forward_flops(small_cfg, small.specs(), tc.batch_size, tc.seq_len))
    for i in range(fs):
        batch = {k: v.to(dev) for k, v in batch_fn(g).items()}
        grads, metrics = kd_grads(params, batch, i / fs)
        params, opt, _ = adamw_update(params, grads, opt, tc)
        cum += fps
        g += 1
        if i % tc.log_every == 0 or i == fs - 1:
            hist.log(cum, float(metrics["loss"]), g, 0)
            if target_loss is not None:
                _, sm = hist.smoothed(5)
                if len(sm) and sm[-1] <= target_loss:
                    break
    return hist


BASELINES: Dict[str, Callable] = {
    "stackbert": run_stackbert,
    "bert2bert": run_bert2bert,
    "ligo": run_ligo,
    "network_expansion": run_network_expansion,
    "ki": run_ki,
}
