"""Carry a JAX parameter tree across into the port's :class:`LM`.

The JAX package stacks layers on leading axes — ``layers`` [L, …], a
hybrid's ``groups`` [G, per, …] and ``tail`` [rem, …] — and keeps the shared
block, the embedding and the final norm unstacked. The port holds one
module per layer, so the stacks are cut apart here. The tree arrives as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this
module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import ParamSpec
from repro_torch.models.lm import LM, model_specs


def _unstack(tree: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _to_tensors(tree, specs, device, path: str = ""):
    if isinstance(specs, ParamSpec):
        a = np.asarray(tree, dtype=np.float32)
        if a.shape != tuple(specs.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{tuple(specs.shape)}")
        return torch.tensor(a, device=device)
    if isinstance(specs, list):
        if len(tree) != len(specs):
            raise ValueError(f"{path}: {len(tree)} layers, expected "
                             f"{len(specs)}")
        return [_to_tensors(t, s, device, f"{path}.{i}")
                for i, (t, s) in enumerate(zip(tree, specs))]
    if set(tree) != set(specs):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)}, "
                         f"expected {sorted(specs)}")
    return {k: _to_tensors(tree[k], s, device, f"{path}.{k}".lstrip("."))
            for k, s in specs.items()}


def params_from_jax(cfg, tree: dict, device=None) -> LM:
    """The port's model holding exactly the values of a JAX parameter tree
    (``repro.models.lm.init_params`` layout, leaves as numpy arrays), on
    ``device`` (default: the CUDA card; pass ``"cpu"`` to run without one)."""
    device = resolve_device(device)
    port = {k: v for k, v in tree.items()
            if k not in ("layers", "groups", "tail")}
    if "layers" in tree:
        port["layers"] = [_unstack(tree["layers"], i)
                          for i in range(cfg.n_layers)]
    if "groups" in tree:
        n_groups = np.shape(tree["groups"]["norm"]["w"])[0]
        per = cfg.hybrid_attn_every
        port["groups"] = [[_unstack(_unstack(tree["groups"], g), i)
                           for i in range(per)] for g in range(n_groups)]
    if "tail" in tree:
        rem = np.shape(tree["tail"]["norm"]["w"])[0]
        port["tail"] = [_unstack(tree["tail"], i) for i in range(rem)]
    return LM(cfg, _to_tensors(port, model_specs(cfg), device))
