"""tinyllama-1.1b [dense]: 22L d2048 32H (GQA kv=4) d_ff=5632 vocab=32000
llama2-arch small.  [arXiv:2401.02385; hf]"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    stages=uniform_stages(22, BlockSpec("attn", "dense")),
    tie_embeddings=False,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=176, vocab_size=512,
        stages=uniform_stages(3, BlockSpec("attn", "dense")), remat="none")
