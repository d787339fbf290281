"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 (fine-grained)
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        head_dim=128,
        act="swiglu",
        norm="layernorm",
        rope_theta=5e5,
        tie_embeddings=False,
        n_experts=16,
        top_k=4,
    )
