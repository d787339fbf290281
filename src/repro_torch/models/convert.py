"""Carry a JAX parameter tree across into the port's :class:`LM` (or
:class:`Whisper`).

The JAX package stacks layers on leading axes — ``layers`` [L, …] (an MoE
layer's experts then sit at [L, E, …]), a hybrid's ``groups`` [G, per, …]
and ``tail`` [rem, …], whisper's ``enc_layers`` and ``dec_layers`` — and
keeps the shared block, the embedding, ``vis_proj``, ``frame_proj`` and the
norms unstacked. The port holds one module per layer, so the stacks are cut
apart here. The tree arrives as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this
module imports nothing of JAX. Any tree of that layout goes through the same
cut: parameters, a gradient, or the moments of the JAX package's
``AdamState`` (:func:`opt_state_from_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import ParamSpec
from repro_torch.models.lm import LM
from repro_torch.models.registry import model_specs
from repro_torch.models.whisper import Whisper
from repro_torch.train.optim import AdamState

_STACKS = ("layers", "tail", "enc_layers", "dec_layers")


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


def _depth(stack: dict) -> int:
    """The leading (layer) axis of a stacked subtree."""
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return np.shape(leaf)[0]


def params_from_jax(cfg, tree: dict, device=None,
                    trainable: bool = False) -> LM | Whisper:
    """The port's model holding exactly the values of a JAX parameter tree
    (``repro.models.lm.init_params`` or ``repro.models.whisper.init_params``
    layout, leaves as numpy arrays), on ``device`` (default: the CUDA card;
    pass ``"cpu"`` to run without one); float32 with gradients when
    ``trainable``."""
    device = resolve_device(device)
    port = {k: v for k, v in tree.items() if k not in (*_STACKS, "groups")}
    for k in _STACKS:
        if k in tree:
            port[k] = [_unstack(tree[k], i) for i in range(_depth(tree[k]))]
    if "groups" in tree:
        per = cfg.hybrid_attn_every
        port["groups"] = [[_unstack(_unstack(tree["groups"], g), i)
                           for i in range(per)]
                          for g in range(_depth(tree["groups"]))]
    cls = Whisper if cfg.family == "encdec" else LM
    return cls(cfg, _to_tensors(port, model_specs(cfg), device), trainable)


def named_from_jax(cfg, tree: dict, device=None) -> dict:
    """A JAX tree of the parameters' layout (parameters, a gradient, a
    moment) as float32 tensors by the port's parameter names
    (``groups.0.3.mamba.in_proj``, …)."""
    model = params_from_jax(cfg, tree, device, trainable=True)
    return {n: p.detach() for n, p in model.named_parameters()}


def opt_state_from_jax(cfg, state, device=None) -> AdamState:
    """The port's :class:`AdamState` from the JAX package's (``step``, and
    the moments ``m`` and ``v`` in the parameters' layout; numpy leaves)."""
    device = resolve_device(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamState(step=step, m=named_from_jax(cfg, state.m, device),
                     v=named_from_jax(cfg, state.v, device))
