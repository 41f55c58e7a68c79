"""Quickstart: train a small GPT with the multi-level V-cycle and compare its
FLOPs-to-quality against from-scratch training.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch

from repro_torch.config import (BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig,
                                uniform_stages)
from repro_torch.core.vcycle import run_scratch, run_vcycle, saving_vs_baseline
from repro_torch.data import MarkovLM, lm_batch
from repro_torch.device import default_device
from repro_torch.examples import Printer

ML = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.05, e_small_frac=0.5)


def quickstart_config() -> ModelConfig:
    return ModelConfig(
        name="quickstart-gpt", family="dense", d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, stages=uniform_stages(4, BlockSpec("attn", "dense")),
        remat="none", attn_impl="plain")


def quickstart_train_config(steps: int = 120) -> TrainConfig:
    return TrainConfig(steps=steps, warmup_steps=10, peak_lr=3e-3, batch_size=16,
                       seq_len=32, log_every=5)


def run(cfg: ModelConfig, tc: TrainConfig, batch_fn: Callable[[int], Dict[str, torch.Tensor]],
        entropy: float, *, device=None) -> Dict:
    """The scratch baseline, then the 2-level V-cycle to its smoothed final
    loss, and the FLOPs saving; returns what it printed, with ``base`` (the
    baseline's ``History``), ``vcycle`` (the V-cycle's output) and
    ``saving`` (``saving_vs_baseline``)."""
    pr = Printer()
    pr.say(f"== from-scratch baseline ({tc.steps} steps) ==")
    _, base = run_scratch(cfg, tc, batch_fn, seed=0, device=device)
    pr.say(f"final loss {base.loss[-1]:.3f} (chain entropy floor {entropy:.3f})")
    pr.say("== 2-level V-cycle (paper Algorithm 1) ==")
    target = float(base.smoothed(5)[1][-1])
    out = run_vcycle(cfg, ML, tc, batch_fn, seed=0, target_loss=target, verbose=True,
                     device=device)
    s = saving_vs_baseline(base, out.history)
    pr.say(f"V-cycle reached loss {s['target_loss']:.3f} with "
           f"{s['flops_saving']*100:.1f}% fewer training FLOPs "
           f"({s['ours_flops']:.2e} vs {s['base_flops']:.2e})")
    pr.out.update(base=base, vcycle=out, saving=s, final_loss=base.loss[-1],
                  entropy=entropy)
    return pr.out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    cfg, tc = quickstart_config(), quickstart_train_config()
    chain = MarkovLM(cfg.vocab_size)
    batch_fn = lambda step: lm_batch(chain, 0, step, tc.batch_size, tc.seq_len, device=dev)
    return run(cfg, tc, batch_fn, chain.entropy(), device=dev)


if __name__ == "__main__":
    main()
