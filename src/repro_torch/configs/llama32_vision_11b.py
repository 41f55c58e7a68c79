"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

A data-only copy of the reference's config.  The vision frontend is a stub:
the image layers take precomputed patch embeddings [batch, 1601, vision_dim]
(``img_embeds``; the launchers feed ones), with vision_dim pinned at 4096 so
coalesced levels keep consuming the same frontend features.
"""
from repro_torch.config import BlockSpec, ModelConfig, Stage

_PATTERN = (BlockSpec("cross_attn", "dense"),) + (BlockSpec("attn", "dense"),) * 4

FULL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    stages=(Stage(_PATTERN, 8),),
    n_image_tokens=1601,
    vision_dim=4096,
    rope_theta=5e5,
    tie_embeddings=False,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=176, vocab_size=512,
        n_image_tokens=8, vision_dim=64,
        stages=(Stage(_PATTERN[:2], 2),), remat="none")
