#!/usr/bin/env python3
"""Why xLSTM-125m at full width shows no falling loss in ``chip_smoke.py``
phase 19, measured on the port (which draws its weights as the reference
does).

* ``slstm_growth``: one sLSTM layer at xLSTM-125m's width (d 768, 4 heads of
  192), f32, B 1: the largest |d y[T-1] / d x[0]| over a sequence of T, for
  each T in ``GROWTH_SEQS``.  Its recurrent matrices r_* are drawn at std
  1/sqrt(their first dim) (the fan-in rule's fallback when no dim has role
  "in"): 0.5 for this lone layer (4 heads), 0.707 stacked in the model (2
  repeats), where 1/sqrt(192) would be 0.072; so the gradient grows with T.
* ``grad_norm``: the whole model's gradient norm (f32, remat "full") at
  batch 8 and each T in ``NORM_SEQS``: the norm AdamW clips by.
* ``loss_trend``: ``STEPS`` AdamW steps (peak rate 6e-4, 2 warm-up steps,
  bf16 compute over f32 weights) of xLSTM-125m and of GPT-Base at batch 8 x
  ``SEQ`` tokens on ``MarkovLM`` batches: each step's loss and gradient
  norm, the first against the mean of the last five.

Runs on the card unless given ``--device cpu``:

    python3 scripts/xlstm_trainability.py [--device cpu]

Prints one JSON line per part.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 20
SEQ = 32
GROWTH_SEQS = (16, 32, 64, 128, 256)
NORM_SEQS = (16, 32, 64, 128)


def slstm_growth(dev, seqs):
    from repro_torch.configs import get_config
    from repro_torch.layers import ssm
    from repro_torch.param import init_tree

    cfg = get_config("xlstm-125m").replace(compute_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_tree(gen, ssm.slstm_specs(cfg))
    out = {}
    for T in seqs:
        x = torch.randn(1, T, cfg.d_model, generator=gen, device=dev).requires_grad_()
        y, _ = ssm.slstm_apply(p, x, cfg)
        g = torch.autograd.grad(y[:, -1].sum(), x)[0]
        out[T] = g[0, 0].abs().max().item()
    return {"r_z_std": p["r_z"].std().item(), "max_abs_dy_last_dx_first": out}


def grad_norm(dev, seqs, batch=8):
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model
    from repro_torch.param import flatten, unflatten

    cfg = get_config("xlstm-125m").replace(compute_dtype=torch.float32)
    init = flatten(build_model(cfg).init(torch.Generator(device=dev).manual_seed(0)))
    leaves = [v.requires_grad_() for v in init.values()]
    out = {}
    for T in seqs:
        b = make_batch_fn(cfg, TrainConfig(batch_size=batch, seq_len=T), device=dev)(0)
        loss, _ = build_model(cfg).loss(unflatten(dict(zip(init, leaves))), b)
        gs = torch.autograd.grad(loss, leaves)
        out[T] = torch.sqrt(sum(g.double().square().sum() for g in gs)).item()
    return {"batch": batch, "grad_norm_f64": out}


def loss_trend(dev, arch, steps, seq, batch=8):
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    tc = TrainConfig(steps=steps, warmup_steps=2, peak_lr=6e-4, batch_size=batch,
                     seq_len=seq, log_every=1)
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params, tc)
    step = make_train_step(model, tc)
    losses, norms = [], []
    for i in range(steps):
        params, opt, m = step(params, opt, batch_fn(i))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"arch": arch, "batch": batch, "seq": seq, "losses": losses, "grad_norms": norms,
            "first": losses[0], "mean_last_5": sum(losses[-5:]) / 5}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("xlstm_trainability: no CUDA device (pass --device cpu)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"device": str(dev), "slstm_growth": slstm_growth(dev, GROWTH_SEQS)}),
          flush=True)
    print(json.dumps({"grad_norm": grad_norm(dev, NORM_SEQS)}), flush=True)
    for arch in ("xlstm-125m", "gpt-base"):
        print(json.dumps({"loss_trend": loss_trend(dev, arch, STEPS, SEQ)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
