"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b; unverified]. LayerNorm +
SwiGLU; partial-rotary detail simplified to full RoPE."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("stablelm-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
        act="swiglu",
        norm="layernorm",
        rope_theta=10000.0,
        tie_embeddings=False,
    )
