"""Configuration: blocks, stages, ``ModelConfig``, ``ShapeConfig`` and the
assigned ``SHAPES``, ``TrainConfig``, ``MultiLevelConfig`` and
``MeshConfig``.

A copy of ``repro/config.py`` with torch dtypes.  Every model field is kept
so the config modules stay data-only copies of the reference's; the port
builds only what its layers implement and raises ``NotImplementedError`` for
the rest (``models/api.py::build_model``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block in a stage pattern."""

    mixer: str = "attn"  # attn | cross_attn | enc_attn | mamba | mlstm | slstm
    ffn: str = "dense"  # dense | moe | none

    @property
    def tag(self) -> str:
        return f"{self.mixer}.{self.ffn}"


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio | vit | encoder
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"  # gqa | mla
    causal: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0

    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0

    # xLSTM
    xlstm_proj_factor: float = 2.0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # VLM cross attention
    n_image_tokens: int = 0
    cross_attn_period: int = 0
    vision_dim: int = 0

    # ViT
    image_size: int = 224
    patch_size: int = 16
    n_classes: int = 1000

    # embeddings / head
    tie_embeddings: bool = True
    vocab_pad_to: int = 128
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    # numerics
    act: str = "silu"  # silu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    use_bias: bool = False

    # performance knobs
    ssm_chunk: int = 128
    attn_seq_shard: bool = False
    attn_impl: str = "blockwise"  # plain | blockwise | pallas | pairs
    attn_block_k: int = 512
    kernel_backend: str = ""  # "" = auto; else cuda | torch
    # (per-op resolution lives in repro_torch.kernels.dispatch)
    remat: str = "full"
    scan_layers: bool = True
    seq_shard_cache: bool = True
    coalesce_experts: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def uniform_stages(n_layers: int, block: BlockSpec) -> Tuple[Stage, ...]:
    return (Stage(pattern=(block,), repeats=n_layers),)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell of the dry run (``launch/dryrun.py``)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's ``TrainConfig``.  ``grad_compression`` names the
    data-parallel gradient reduction (``distributed/reduce.py``: none | dense
    | int8_ef); with "none" on a mesh the step is the FSDP one, whose weights
    are gathered per layer, or once a step with ``pregather_params``
    (``distributed/fsdp.py``)."""

    steps: int = 300
    warmup_steps: int = 20
    peak_lr: float = 1e-3
    end_lr_frac: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    opt_dtype: Any = torch.float32  # adam moment dtype
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 64
    log_every: int = 10
    grad_compression: str = "none"  # none | dense | int8_ef
    z_loss: float = 0.0
    pregather_params: bool = False  # per-step FSDP weight gather (vs per-layer
    # per-microbatch); opt-in where the whole model in compute_dtype fits


@dataclasses.dataclass(frozen=True)
class MultiLevelConfig:
    """Paper Algorithm 1 hyper-parameters (fractions of total step budget).
    The optimizer always re-initialises at a level transition (paper App. C);
    expert coalescing is ``ModelConfig.coalesce_experts``."""

    n_levels: int = 2
    alpha: float = 0.25  # interpolation ratio (paper: 0.25 GPT/DeiT, 0.5 BERT)
    e_a_frac: float = 0.033  # E_a: init steps per level before coalescing
    e_small_frac: float = 0.5  # E_small: small-model steps
    width_variant: str = "stack"  # stack | adj  (Appendix E)
    depth_variant: str = "adj"  # adj | stack   (Appendix E)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (the reference's; the launchers
    build theirs from ``--mesh``, the dry run from
    ``launch/mesh.py::PRODUCTION_MESHES``)."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
