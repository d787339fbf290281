"""Architecture registry: name -> uniform model API, as the JAX package's
``repro.models.registry``:

    api = get_model(cfg)                   # on the card unless device="cpu"
    params = api.init(generator)           # an LM or Whisper on api.device
    params = api.init(generator, trainable=True)   # float32, with gradients
    params = api.build(tree, trainable=True)       # from a tree of tensors
    api.forward(params, batch)             -> logits [B,S,V]
    api.forward_hidden(params, batch)      -> (hidden [B,S,D], aux)
    api.unembed(params)                    -> [D, V]
    api.prefill(params, batch, max_len)    -> (logits [B,1,V], cache)
    api.decode(params, cache, tokens, pos) -> (logits [B,1,V], cache)
    api.init_cache(batch, max_len[, device]) / api.count_params()
    api.active_params()
    api.abstract_params() / api.param_axes()   # meta tensors / logical axes
    api.input_specs(shape)                 -> {name: meta tensor}

``batch`` holds ``tokens``, plus ``vis_embeds`` [B,n_vis,D] for the vlm
family and ``frames`` [B,T,D] for encdec. ``forward`` returns logits only
(the JAX API's ``(logits, aux)``: see ``lm.forward(..., return_aux=True)``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm, whisper
from repro_torch.models.blocks import count_specs
from repro_torch.models.lm import ModelConfig

# the cross-attention length of the encdec API's init_cache: whisper's 30 s
# window after the conv stack
WHISPER_FRAMES = 1500


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = [
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
]


def model_specs(cfg: ModelConfig) -> dict:
    """The spec tree of ``cfg``'s model (whisper's for encdec)."""
    if cfg.family == "encdec":
        return whisper.model_specs(cfg)
    return lm.model_specs(cfg)


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (torch.Generator, trainable=False) -> LM or
    #                         Whisper on device
    build: Callable         # (tree, trainable=False) -> LM or Whisper
    #                         holding the tree's tensors (DTensors, meta)
    forward: Callable       # (params, batch) -> logits
    forward_hidden: Callable  # (params, batch) -> (hidden, aux)
    unembed: Callable       # params -> [D, V]
    prefill: Callable       # (params, batch, max_len) -> (logits, cache)
    decode: Callable        # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable    # (batch, max_len, device=None) -> cache, on
    #                         device (meta for a dry run) or api.device
    abstract_params: Callable   # () -> tree of float32 meta tensors
    param_axes: Callable        # () -> tree of logical-axes tuples
    input_specs: Callable       # (ShapeSpec) -> {name: meta tensor}

    def count_params(self) -> int:
        return count_specs(model_specs(self.cfg))

    def active_params(self) -> int:
        """Per-token active parameters (MoE: only top-k experts)."""
        cfg = self.cfg
        total = self.count_params()
        if cfg.family != "moe" or not cfg.n_experts:
            return total
        expert = 3 * cfg.d_model * cfg.d_ff  # gate/up/down per expert
        inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert
        return total - inactive


def _vis_frames(cfg, spec: ShapeSpec) -> int:
    """The stub frontend's prefix length in the cell ``spec``: encdec
    frames scale with the tokens, capped at whisper's 30 s window; vlm
    patch tokens are fixed by the config."""
    if cfg.family == "encdec":
        return min(WHISPER_FRAMES, max(128, spec.seq_len // 2))
    return cfg.n_vis_tokens


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _input_specs(cfg, spec: ShapeSpec) -> dict:
    """{name: meta tensor} of a batch in the cell ``spec``: tokens (and
    labels for training) [B,S] int32, plus the stub frontend's prefix in
    float32 (decode: one new token against a cache of ``seq_len``)."""
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    out = {"tokens": _meta((B, S), torch.int32)}
    if spec.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        out["vis_embeds"] = _meta((B, cfg.n_vis_tokens, cfg.d_model),
                                  torch.float32)
    if cfg.family == "encdec":
        out["frames"] = _meta((B, _vis_frames(cfg, spec), cfg.d_model),
                              torch.float32)
    return out


def _lm_api(cfg: ModelConfig, dev: torch.device) -> ModelApi:
    def vis(batch):
        return batch["vis_embeds"] if cfg.family == "vlm" else None

    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda generator, trainable=False: lm.init_params(
            cfg, generator, dev, trainable),
        build=lambda tree, trainable=False: lm.LM(cfg, tree, trainable),
        forward=lambda params, batch: lm.forward(
            cfg, params, batch["tokens"], vis_embeds=vis(batch)),
        forward_hidden=lambda params, batch: lm.forward(
            cfg, params, batch["tokens"], vis_embeds=vis(batch),
            return_hidden=True),
        unembed=lambda params: lm.unembed_matrix(cfg, params),
        prefill=lambda params, batch, max_len: lm.prefill(
            cfg, params, batch["tokens"], max_len, vis_embeds=vis(batch)),
        decode=lambda params, cache, tokens, pos: lm.decode_step(
            cfg, params, cache, tokens, pos),
        init_cache=lambda batch, max_len, device=None: lm.init_cache(
            cfg, batch, max_len, device=device or dev),
        abstract_params=lambda: lm.abstract_params(cfg),
        param_axes=lambda: lm.param_axes(cfg),
        input_specs=lambda spec: _input_specs(cfg, spec),
    )


def _whisper_api(cfg: ModelConfig, dev: torch.device) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda generator, trainable=False: whisper.init_params(
            cfg, generator, dev, trainable),
        build=lambda tree, trainable=False: whisper.Whisper(cfg, tree,
                                                            trainable),
        forward=lambda params, batch: whisper.forward(
            cfg, params, batch["tokens"], batch["frames"]),
        forward_hidden=lambda params, batch: whisper.forward(
            cfg, params, batch["tokens"], batch["frames"],
            return_hidden=True),
        unembed=lambda params: whisper.unembed_matrix(cfg, params),
        prefill=lambda params, batch, max_len: whisper.prefill(
            cfg, params, batch["tokens"], batch["frames"], max_len),
        decode=lambda params, cache, tokens, pos: whisper.decode_step(
            cfg, params, cache, tokens, pos),
        init_cache=lambda batch, max_len, device=None: whisper.init_cache(
            cfg, batch, max_len, n_frames=WHISPER_FRAMES,
            device=device or dev),
        abstract_params=lambda: whisper.abstract_params(cfg),
        param_axes=lambda: whisper.param_axes(cfg),
        input_specs=lambda spec: _input_specs(cfg, spec),
    )


def get_model(cfg: ModelConfig, device=None) -> ModelApi:
    """The model API on ``device``: the CUDA card unless the caller asks
    for another device (raises without a card)."""
    dev = resolve_device(device)
    model_specs(cfg)               # raises for an unknown family
    if cfg.family == "encdec":
        return _whisper_api(cfg, dev)
    return _lm_api(cfg, dev)


# ---- config registry -------------------------------------------------------
_CONFIGS: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _CONFIGS[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        _load_all()
    return _CONFIGS[name]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_CONFIGS)


def _load_all():
    import importlib
    import pkgutil

    import repro_torch.configs as pkg

    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape cells applicable to this arch (long_500k only for
    sub-quadratic families)."""
    return [s for s in LM_SHAPES
            if s.name != "long_500k" or cfg.sub_quadratic]
