"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert), vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
Qwen3 uses per-head q/k RMSNorm and no QKV bias."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,               # fine-grained per-expert FFN width
        vocab=151936,
        head_dim=128,
        act="swiglu",
        norm="rmsnorm",
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=False,
        n_experts=128,
        top_k=8,
    )
