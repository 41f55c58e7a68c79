"""xlstm-125m [ssm]: 12L d768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.
[arXiv:2405.04517; unverified]

Blocks carry their own up/down projections (d_ff=0 per the assignment: no
separate FFN).  Pattern approximates xLSTM[7:1]: one sLSTM per 6-block period.
Pure recurrent state => runs long_500k with O(1) decode state.
"""
from repro_torch.config import BlockSpec, ModelConfig, Stage

_PATTERN = (
    BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"),
    BlockSpec("slstm", "none"), BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"),
)

FULL = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    stages=(Stage(_PATTERN, 2),),
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(d_model=64, n_heads=4, n_kv_heads=4, vocab_size=512,
                        stages=(Stage(_PATTERN[:2], 2),), remat="none")
