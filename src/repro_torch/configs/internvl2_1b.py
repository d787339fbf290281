"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B-style LM backbone
[arXiv:2404.16821; hf]. 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. The vision frontend is a STUB: the caller provides
precomputed patch embeddings (256 tokens, ``batch["vis_embeds"]``) projected
into the LM."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151655,
        head_dim=64,
        act="swiglu",
        norm="rmsnorm",
        qkv_bias=True,           # Qwen2-style QKV bias
        rope_theta=1e6,
        tie_embeddings=True,
        n_vis_tokens=256,
    )
