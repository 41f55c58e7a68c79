"""Meta-tensor stand-ins for every (arch x shape) cell of the dry run, and
the per-arch training hyperparameters it uses (the counterpart of
``repro/launch/specs.py``): microbatches (grad-accum), the optimizer's
dtype, the bf16 state of the 100B+ models.

The ``*_inputs`` functions return a tree of global-shape meta tensors and
its tree of logical axes; :func:`local_tree` cuts either kind of tree to
this rank's blocks (``distributed/sharding.py::local_slices`` at its mesh
coordinate), so the step sees this rank's rows and weights.  Nothing is
allocated.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import local_slices, logical_spec
from repro_torch.models import lm as lm_lib
from repro_torch.param import tree_map

# grad-accum per arch for the train_4k cell: keeps a device's microbatch
# activations (and the MoE dispatch tensors) inside HBM
TRAIN_ACCUM: Dict[str, int] = {
    "deepseek-v3-671b": 8,
    "jamba-1.5-large-398b": 8,
    "command-r-35b": 4,
    "qwen3-14b": 4,
    "phi3.5-moe-42b-a6.6b": 4,
    "llama-3.2-vision-11b": 4,
    "whisper-large-v3": 2,
    "qwen3-4b": 2,
    "tinyllama-1.1b": 2,
    "xlstm-125m": 1,
}

# >= 100B parameters: bf16 parameters and bf16 AdamW moments; every other
# arch keeps f32 parameters and moments
BF16_STATE = ("deepseek-v3-671b", "jamba-1.5-large-398b")


def train_config_for(cfg: ModelConfig, shape: ShapeConfig) -> TrainConfig:
    accum = TRAIN_ACCUM.get(cfg.name, 1) if shape.kind == "train" else 1
    opt_dtype = torch.bfloat16 if cfg.name in BF16_STATE else torch.float32
    return TrainConfig(steps=10000, warmup_steps=500, grad_accum=accum,
                       opt_dtype=opt_dtype, batch_size=shape.global_batch,
                       seq_len=shape.seq_len, pregather_params=False)


def model_config_for(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The cell's config: bf16 parameters for ``BF16_STATE``; for a causal
    prefill the "pairs" attention (the flash op, causal pairs only) and no
    context parallelism, as the reference's."""
    if cfg.name in BF16_STATE and cfg.param_dtype != torch.bfloat16:
        cfg = cfg.replace(param_dtype=torch.bfloat16)
    if shape.kind == "prefill" and cfg.causal:
        cfg = cfg.replace(attn_impl="pairs", attn_seq_shard=False)
    return cfg


def _tok(shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.long, device="meta")


def _act(shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, accum: int):
    """(batch, axes) of the training batch; with ``accum > 1`` the global
    batch is split into ``accum`` leading microbatches."""
    B, S = shape.global_batch, shape.seq_len
    lead: Tuple[int, ...] = (accum, B // accum) if accum > 1 else (B,)
    lax: Tuple[str, ...] = ("accum", "batch") if accum > 1 else ("batch",)
    batch = {"tokens": _tok(lead + (S,)), "labels": _tok(lead + (S,))}
    axes = {"tokens": lax + ("seq",), "labels": lax + ("seq",)}
    if cfg.family == "vlm":
        batch["img_embeds"] = _act(lead + (cfg.n_image_tokens, cfg.vision_dim or cfg.d_model))
        axes["img_embeds"] = lax + ("img_seq", "vision_embed")
    if cfg.family == "audio":
        batch["enc_frames"] = _act(lead + (cfg.encoder_seq, cfg.d_model))
        axes["enc_frames"] = lax + ("enc_seq", "act_embed")
    return batch, axes


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {"tokens": _tok((B, S))}
    axes: Dict[str, Any] = {"tokens": ("batch", "seq")}
    if cfg.family == "vlm":
        batch["img_embeds"] = _act((B, cfg.n_image_tokens, cfg.vision_dim or cfg.d_model))
        axes["img_embeds"] = ("batch", "img_seq", "vision_embed")
    if cfg.family == "audio":
        batch["enc_frames"] = _act((B, cfg.encoder_seq, cfg.d_model))
        axes["enc_frames"] = ("batch", "enc_seq", "act_embed")
    return batch, axes


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens [B,1], pos [B], the dense caches' ``Spec`` tree)."""
    B = shape.global_batch
    return _tok((B, 1)), _tok((B,)), lm_lib.cache_specs(cfg, B, shape.seq_len)


def local_shape(shape, axes, mesh, rules=None) -> Tuple[int, ...]:
    """This rank's block of a global ``shape`` laid out by logical ``axes``."""
    sl = local_slices(tuple(shape), logical_spec(tuple(shape), tuple(axes), mesh, rules), mesh)
    return tuple(s.stop - s.start for s in sl)


def local_tree(tree, mesh, rules=None, axes=None, dtype=None):
    """This rank's blocks as meta tensors: of a ``Spec`` tree (each leaf in
    its own dtype or ``dtype``), or of a tree of meta tensors and its
    ``axes`` tree."""
    if axes is None:
        return tree_map(lambda s: torch.empty(local_shape(s.shape, s.axes, mesh, rules),
                                              dtype=s.dtype or dtype, device="meta"), tree)
    return tree_map(lambda t, ax: torch.empty(local_shape(t.shape, ax, mesh, rules),
                                              dtype=t.dtype, device="meta"), tree, axes)
