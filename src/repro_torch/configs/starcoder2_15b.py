"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE, LayerNorm + GELU MLP with biases
[arXiv:2402.19173; hf]."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab=49152,
        head_dim=128,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        rope_theta=1e5,
        tie_embeddings=True,
    )
