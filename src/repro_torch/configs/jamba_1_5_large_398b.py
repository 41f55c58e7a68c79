"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) expert d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attn 1:7 interleave.  [arXiv:2403.19887; hf]

Period-8 super-block (Jamba block): attention at position 3, Mamba elsewhere;
MoE on every second layer.  72 layers = 9 super-blocks.

A data-only copy of the reference's config: its Mamba mixers, MoE FFNs and
attention layers are the port's existing blocks.
"""
from repro_torch.config import BlockSpec, ModelConfig, Stage

_PATTERN = tuple(
    BlockSpec(mixer=("attn" if i == 3 else "mamba"), ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    stages=(Stage(_PATTERN, 9),),
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=False,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512,
        n_experts=4, moe_top_k=2, moe_d_ff=96,
        stages=(Stage(_PATTERN[:4], 2),), remat="none")
