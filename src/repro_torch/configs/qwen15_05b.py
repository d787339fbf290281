"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (MHA kv=16) d_ff=2816
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("qwen1.5-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        act="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,
    )
