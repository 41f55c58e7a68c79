"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk_norm, explicit head_dim=128.  [hf:Qwen/Qwen3-8B; hf]

Note: 40 query heads do not divide the 16-way "model" mesh axis; the sharding
rules therefore replicate the head axis and tensor-parallelism carries via the
FFN/vocab axes (visible in the roofline as a memory-heavier attention term).
"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="qwen3-14b",
    family="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    stages=uniform_stages(40, BlockSpec("attn", "dense")),
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    remat="full",
    attn_seq_shard=True,  # 40/20 heads don't divide model=16: context-parallel attn
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512,
        stages=uniform_stages(3, BlockSpec("attn", "dense")), remat="none")
