"""Sharding trees for a step on a mesh, after the JAX package's
``repro.launch.shardings``: params, optimizer state, batches and decode
caches, derived from logical axes + the active policy rules.

A sharding tree has the layout of the tree it describes (the model's spec
tree: nested dicts, with lists where the port holds one module per layer),
with a :class:`~repro_torch.sharding.policy.NamedSharding` at each leaf.
:func:`place` and :func:`place_tree` put tensors on the mesh by such a
tree: a real tensor through ``distribute_tensor``, a meta tensor as a
DTensor whose local shard is a meta tensor too (no storage, no data
moved).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.sharding import policy as pol
from repro_torch.train.optim import AdamState

# Named rule presets:
#   baseline  — FSDP("embed"->data) + TP + SP (the paper-faithful default)
#   dp_wide   — no tensor parallelism: the model axis joins the batch
#               (right for small archs where TP fragments tiny matmuls)
#   no_sp     — disable sequence-parallel residuals (trades memory for
#               fewer activation collectives)
#   tp_seq    — TP + sequence sharding of long KV (serving, long context)
PRESETS: dict[str, dict] = {
    "baseline": {},
    "dp_wide": {
        "batch": ("pod", "data", "model"),
        "heads": None, "kv_heads": None, "mlp": None, "vocab": None,
        "experts": None, "inner": None, "act_seq": None, "kv_seq": None,
        "embed": ("data", "model"),
    },
    "no_sp": {"act_seq": None},
    "tp_seq": {"embed": None},
}

# rules overrides per phase
TRAIN_RULES: dict = {}   # defaults: FSDP ("embed"->data) + TP + SP
# Serving inherits FSDP weight sharding: replicating weights across the
# data axis does not fit the big archs.
SERVE_RULES: dict = {}


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one layout (dicts and lists;
    a tuple is a leaf)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def flatten(tree, prefix: str = "") -> dict:
    """{dotted name: leaf} of a tree, the names a model's
    ``named_parameters`` gives (``layers.0.attn.wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def param_shardings(mesh, api, rules: dict | None = None):
    """The sharding of each parameter, in the layout of the spec tree."""
    return _map2(
        lambda ax, a: pol.param_sharding(mesh, ax, tuple(a.shape), rules),
        api.param_axes(), api.abstract_params())


def batch_shardings(mesh, batch_specs: dict, rules=None) -> dict:
    out = {}
    for k, v in batch_specs.items():
        ax = ["batch"] + [None] * (len(v.shape) - 1)
        out[k] = pol.param_sharding(mesh, tuple(ax), tuple(v.shape), rules)
    return out


_CACHE_AXES = {
    ("k", 5): ("layers", "batch", "kv_seq", "kv_heads", None),
    ("v", 5): ("layers", "batch", "kv_seq", "kv_heads", None),
    ("xk", 5): ("layers", "batch", None, "kv_heads", None),
    ("xv", 5): ("layers", "batch", None, "kv_heads", None),
    ("k", 6): ("layers", "layers", "batch", "kv_seq", "kv_heads", None),
    ("v", 6): ("layers", "layers", "batch", "kv_seq", "kv_heads", None),
    ("conv", 4): ("layers", "batch", None, "inner"),
    ("conv", 5): ("layers", "layers", "batch", None, "inner"),
    ("ssm", 5): ("layers", "batch", "inner", None, None),
    ("ssm", 6): ("layers", "layers", "batch", "inner", None, None),
}


def cache_shardings(mesh, cache_ab: dict, rules=None) -> dict:
    """The sharding of each decode-cache buffer (nested dicts of tensors,
    as ``init_cache`` makes them), by its name and rank."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        ax = _CACHE_AXES.get((name, node.dim()))
        if ax is None:
            ax = ("layers", "batch") + (None,) * (node.dim() - 2)
        return pol.param_sharding(mesh, ax, tuple(node.shape), rules)
    return walk(cache_ab, None)


def replicated(mesh) -> pol.NamedSharding:
    return pol.NamedSharding(mesh, ())


def opt_shardings(mesh, params_sh) -> AdamState:
    """AdamState(step, m, v): step replicated; m/v mirror params, by
    parameter name as the port's AdamW keeps them."""
    named = flatten(params_sh)
    return AdamState(step=replicated(mesh), m=named, v=dict(named))


def local_shape(shape, sh: pol.NamedSharding) -> tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape``."""
    out = list(shape)
    for size, p in zip(sh.mesh.shape, sh.placements):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def place(t: torch.Tensor, sh: pol.NamedSharding) -> DTensor:
    """``t`` on ``sh``'s mesh with its placements."""
    if t.is_meta:
        local = torch.empty(local_shape(t.shape, sh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, sh.mesh, sh.placements)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed by the same-layout ``shardings``."""
    return _map2(place, tree, shardings)


