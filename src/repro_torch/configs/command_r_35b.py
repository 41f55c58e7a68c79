"""command-r-35b [dense]: 40L d8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="command-r-35b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    stages=uniform_stages(40, BlockSpec("attn", "dense")),
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8e6,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=176, vocab_size=512,
        stages=uniform_stages(3, BlockSpec("attn", "dense")), remat="none")
