"""End-to-end driver: pre-train with the V-cycle schedule, fault-tolerant
checkpointing and auto-resume -- for any model family.

It runs the launcher's code path (``repro_torch.launch.train``).  The default
invocation uses a reduced width; ``--full-100m`` runs the ~100M config
(GPT-Base's widths: 12 layers, d 768).

``--config`` picks the model family: a tiny same-family config runs the same
V-cycle end to end -- the family's ProjectionPlan (printed at startup)
decides what coalesces, what is protected, and which scalars carry across
levels:

    PYTHONPATH=src python -m repro_torch.examples.vcycle_pretrain [--steps 200] [--full-100m]
    PYTHONPATH=src python -m repro_torch.examples.vcycle_pretrain --config moe --steps 40
    PYTHONPATH=src python -m repro_torch.examples.vcycle_pretrain --config ssm --steps 40 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig,
                                uniform_stages)
from repro_torch.core.flops import total_params
from repro_torch.device import default_device
from repro_torch.examples import Printer
from repro_torch.launch.train import train_vcycle_ckpt
from repro_torch.models.api import build_model

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vit")
ML = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.05, e_small_frac=0.5)


def gpt_100m() -> ModelConfig:
    # ~100M params: 12L, d=768 (GPT-Base shape), vocab 8192 synthetic
    return ModelConfig(name="gpt-100m", family="dense", d_model=768, n_heads=12,
                       n_kv_heads=12, d_ff=3072, vocab_size=8192,
                       stages=uniform_stages(12, BlockSpec("attn", "dense")),
                       act="gelu", norm="layernorm", use_bias=True, remat="none")


def gpt_small() -> ModelConfig:
    return gpt_100m().replace(name="gpt-12m", d_model=256, n_heads=4, n_kv_heads=4,
                              d_ff=1024, stages=uniform_stages(8, BlockSpec("attn", "dense")))


def family_config(name: str) -> ModelConfig:
    """A tiny same-family config per ``--config`` choice.  MoE and hybrid turn
    on expert coalescing so the router-consistent merge path is exercised."""
    from repro_torch.configs import get_config, paper_models

    if name == "dense":
        return gpt_small()
    if name == "moe":
        return get_config("phi3.5-moe-42b-a6.6b", smoke=True).replace(coalesce_experts=True)
    if name == "ssm":
        return get_config("xlstm-125m", smoke=True)
    if name == "hybrid":
        return get_config("jamba-1.5-large-398b", smoke=True).replace(coalesce_experts=True)
    if name == "vit":
        return paper_models.deit_proxy(d_model=64, n_layers=4)
    raise SystemExit(f"unknown --config {name!r} (choose from {FAMILIES})")


def example_config(config: str = "dense", full_100m: bool = False) -> ModelConfig:
    return gpt_100m() if full_100m else family_config(config)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--config", default="dense", choices=FAMILIES,
                    help="model family to pre-train (tiny same-family config)")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "vcycle_pretrain_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N global steps; a live server "
                         "polling --ckpt-dir (serve --reload-from) swaps "
                         "each published step in by digest diff")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    pr = Printer()

    cfg = example_config(args.config, args.full_100m)
    model = build_model(cfg)
    n = total_params(model.specs())
    pr.say(f"model {cfg.name}: {n/1e6:.1f}M params, {cfg.n_layers} layers")
    plan = model.projection_plan(ML).describe()
    pr.say(plan)
    # registry smoke configs are narrower than gpt_small: shorter sequences
    # keep the non-dense families fast without changing the schedule
    seq = 128 if args.config == "dense" or args.full_100m else 32
    tc = TrainConfig(steps=args.steps, warmup_steps=max(args.steps // 20, 1),
                     peak_lr=6e-4, batch_size=8, seq_len=seq, log_every=10)
    ckpt = CheckpointManager(args.ckpt_dir)
    out = train_vcycle_ckpt(cfg, ML, tc, ckpt=ckpt, ckpt_every=args.ckpt_every, device=dev)
    pr.say(f"done; final loss {out.history.loss[-1]:.4f}; "
           f"checkpoint in {args.ckpt_dir}")
    pr.out.update(params_m=n / 1e6, plan=plan, output=out,
                  final_loss=out.history.loss[-1], ckpt_dir=args.ckpt_dir)
    return pr.out


if __name__ == "__main__":
    main()
