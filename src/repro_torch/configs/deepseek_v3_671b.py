"""deepseek-v3-671b [moe]: 61L d7168 128H MLA d_ff(expert)=2048 vocab=129280,
MoE 1 shared + 256 routed top-8, MTP.  [arXiv:2412.19437; hf]

Structure: first 3 layers dense-FFN (d_ff 18432, per the HF config), remaining
58 layers MoE.  MLA dims from the paper: q_lora 1536, kv_lora 512,
qk_nope 128 + qk_rope 64, v_head 128.
"""
from repro_torch.config import BlockSpec, ModelConfig, Stage

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab_size=129280,
    stages=(
        Stage((BlockSpec("attn", "dense"),), 3),
        Stage((BlockSpec("attn", "moe"),), 58),
    ),
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    tie_embeddings=False,
    mtp_depth=1,
    rope_theta=10000.0,
    remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=160, vocab_size=512,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, n_experts=4, moe_top_k=2, moe_d_ff=32,
        stages=(Stage((BlockSpec("attn", "dense"),), 1),
                Stage((BlockSpec("attn", "moe"),), 2)),
        remat="none",
    )
