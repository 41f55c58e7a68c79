"""The paper's own experimental models (BERT, GPT, DeiT): full-size configs
plus the proxy-scale variants the reproduction benchmarks use.

Pre-LN transformer, biases enabled, GELU, tied embeddings.  A data-only copy
of ``repro/configs/paper_models.py``.
"""
from repro_torch.config import BlockSpec, ModelConfig, uniform_stages

BERT_BASE = ModelConfig(
    name="bert-base", family="encoder", d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=30522,
    stages=uniform_stages(12, BlockSpec("enc_attn", "dense")),
    causal=False, act="gelu", norm="layernorm", use_bias=True, tie_embeddings=True)

BERT_LARGE = BERT_BASE.replace(
    name="bert-large", d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    stages=uniform_stages(24, BlockSpec("enc_attn", "dense")))

GPT_BASE = ModelConfig(
    name="gpt-base", family="dense", d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=50257,
    stages=uniform_stages(12, BlockSpec("attn", "dense")),
    act="gelu", norm="layernorm", use_bias=True, tie_embeddings=True)

DEIT_B = ModelConfig(
    name="deit-b", family="vit", d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=1, stages=uniform_stages(12, BlockSpec("enc_attn", "dense")),
    act="gelu", norm="layernorm", use_bias=True,
    image_size=224, patch_size=16, n_classes=1000)


def bert_proxy(d_model=128, n_layers=8, vocab=512) -> ModelConfig:
    return BERT_BASE.replace(
        name="bert-proxy", d_model=d_model, n_heads=4, n_kv_heads=4,
        d_ff=4 * d_model, vocab_size=vocab,
        stages=uniform_stages(n_layers, BlockSpec("enc_attn", "dense")),
        remat="none", attn_impl="plain")


def bert_large_proxy() -> ModelConfig:
    return bert_proxy(d_model=192, n_layers=12).replace(name="bert-large-proxy")


def gpt_proxy(d_model=128, n_layers=8, vocab=512) -> ModelConfig:
    return GPT_BASE.replace(
        name="gpt-proxy", d_model=d_model, n_heads=4, n_kv_heads=4,
        d_ff=4 * d_model, vocab_size=vocab,
        stages=uniform_stages(n_layers, BlockSpec("attn", "dense")),
        remat="none", attn_impl="plain")


def deit_proxy(d_model=128, n_layers=8, n_classes=16) -> ModelConfig:
    return DEIT_B.replace(
        name="deit-proxy", d_model=d_model, n_heads=4, n_kv_heads=4,
        d_ff=4 * d_model, image_size=32, patch_size=8, n_classes=n_classes,
        stages=uniform_stages(n_layers, BlockSpec("enc_attn", "dense")),
        remat="none", attn_impl="plain")
