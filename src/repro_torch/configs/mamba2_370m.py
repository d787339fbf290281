"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD/state-space duality [arXiv:2405.21060; unverified].
d_inner = 2·d_model = 2048, head_dim 64 => 32 SSD heads."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        rope_theta=None,
        tie_embeddings=True,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        sub_quadratic=True,      # constant-state decode: long_500k runs
    )
