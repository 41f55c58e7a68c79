"""qwen3-4b [dense]: 36L d2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, explicit head_dim=128.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="qwen3-4b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    stages=uniform_stages(36, BlockSpec("attn", "dense")),
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512,
        stages=uniform_stages(3, BlockSpec("attn", "dense")), remat="none")
