"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (GQA kv=8) expert d_ff=6400
vocab=32064, 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    stages=uniform_stages(32, BlockSpec("attn", "moe")),
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=6400,
    tie_embeddings=False,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512,
        n_experts=4, moe_top_k=2, moe_d_ff=96,
        stages=uniform_stages(2, BlockSpec("attn", "moe")), remat="none")
