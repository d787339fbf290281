"""Architecture registry: name -> uniform model API, as the JAX package's
``repro.models.registry`` for the families the port serves:

    api = get_model(cfg)                   # on the card unless device="cpu"
    params = api.init(generator)           # an LM, weights on api.device
    api.forward(params, batch)             -> logits [B,S,V]
    api.prefill(params, batch, max_len)    -> (logits [B,1,V], cache)
    api.decode(params, cache, tokens, pos) -> (logits [B,1,V], cache)
    api.init_cache(batch, max_len) / api.count_params()
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.blocks import count_specs
from repro_torch.models.lm import ModelConfig


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (torch.Generator) -> LM on device
    forward: Callable       # (params, batch) -> logits
    prefill: Callable       # (params, batch, max_len) -> (logits, cache)
    decode: Callable        # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable    # (batch, max_len) -> cache

    def count_params(self) -> int:
        return count_specs(lm.model_specs(self.cfg))


def get_model(cfg: ModelConfig, device=None) -> ModelApi:
    """The model API on ``device``: the CUDA card unless the caller asks
    for another device (raises without a card)."""
    dev = resolve_device(device)
    lm.model_specs(cfg)            # raises for families not ported yet
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda generator: lm.init_params(cfg, generator, dev),
        forward=lambda params, batch: lm.forward(cfg, params,
                                                 batch["tokens"]),
        prefill=lambda params, batch, max_len: lm.prefill(
            cfg, params, batch["tokens"], max_len),
        decode=lambda params, cache, tokens, pos: lm.decode_step(
            cfg, params, cache, tokens, pos),
        init_cache=lambda batch, max_len: lm.init_cache(
            cfg, batch, max_len, device=dev),
    )


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
