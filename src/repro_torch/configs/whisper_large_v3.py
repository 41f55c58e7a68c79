"""whisper-large-v3 [audio]: enc-dec, 32L+32L d1280 20H d_ff=5120 vocab=51866.
[arXiv:2212.04356; unverified]

A data-only copy of the reference's config.  The conv frontend is a stub:
the encoder takes precomputed post-conv frame embeddings [batch, 1500,
d_model] (``enc_frames``; the launchers feed ones).  vocab is padded to 51968
(a multiple of 128).  ``attn_seq_shard`` only matters on a mesh; on one card
it has no effect and is carried as data.
"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    stages=uniform_stages(32, BlockSpec("dec_attn", "dense")),
    n_encoder_layers=32,
    encoder_seq=1500,
    act="gelu",
    norm="layernorm",
    use_bias=True,
    tie_embeddings=True,
    remat="full",
    attn_seq_shard=True,  # 40/20 heads don't divide model=16: context-parallel attn
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=176, vocab_size=512,
        stages=uniform_stages(2, BlockSpec("dec_attn", "dense")),
        n_encoder_layers=2, encoder_seq=16, remat="none")
