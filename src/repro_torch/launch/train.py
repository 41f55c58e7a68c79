"""Training launcher pieces (the counterpart of part of
``repro/launch/train.py``): the per-family batch stream."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import MarkovLM, lm_batch, masked_lm_batch, vision_batch
from repro_torch.device import default_device
from repro_torch.models.vit import n_patches, patch_dim


def make_batch_fn(cfg: ModelConfig, tc: TrainConfig, shard: int = 0, *,
                  device=None) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``step -> batch`` on ``device`` (the CUDA card unless given): class-
    conditional patches for the ViT family, MLM batches for encoders (the
    last vocabulary id is [MASK]), causal LM batches otherwise."""
    dev = default_device(device)
    if cfg.family == "vit":
        return lambda step: vision_batch(tc.seed, step, tc.batch_size, n_patches(cfg),
                                         patch_dim(cfg), cfg.n_classes, shard, device=dev)
    chain = MarkovLM(cfg.vocab_size)
    if cfg.family == "encoder":
        mask_id = cfg.vocab_size - 1
        return lambda step: masked_lm_batch(chain, tc.seed, step, tc.batch_size, tc.seq_len,
                                            mask_id, shard=shard, device=dev)
    return lambda step: lm_batch(chain, tc.seed, step, tc.batch_size, tc.seq_len, shard,
                                 device=dev)
