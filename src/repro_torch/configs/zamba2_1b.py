"""zamba2-1.2b [hybrid] — 38L d_model=2048 Mamba2 backbone + ONE shared
attention(32H, kv=32)+MLP(d_ff=8192) block applied every 6 layers,
ssm_state=64 [arXiv:2411.15242; hf]. The SSM state is constant in the
sequence length; the shared block's KV is the only cache that grows."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,             # 6 groups of 6 SSM layers + 2 tail layers
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        rope_theta=10000.0,
        tie_embeddings=True,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        hybrid_attn_every=6,
    )
