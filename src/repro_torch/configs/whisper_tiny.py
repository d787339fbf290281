"""whisper-tiny [audio] — enc-dec, 4L encoder + 4L decoder, d_model=384 6H
d_ff=1536 vocab=51865 [arXiv:2212.04356; unverified]. Conv/audio frontend is
a STUB (precomputed frame embeddings)."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.registry import register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,              # decoder layers
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        rope_theta=None,         # sinusoidal positions
        tie_embeddings=True,
    )
