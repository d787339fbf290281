"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("yi-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        head_dim=128,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=5e6,
        tie_embeddings=False,
    )
