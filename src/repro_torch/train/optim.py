"""Optimizers and schedules, after the JAX package's ``repro.train.optim``.

AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule, on tensors. The JAX package's trees become mappings
of parameter name -> tensor: a model (an ``nn.Module``) is read through its
``named_parameters``, and the moments are dicts with the same names, on the
parameters' devices.

The arithmetic is the JAX package's, in float32: the clip scale is
``min(1, clip / max(gn, 1e-9))`` from the unclipped global norm, which is
also the norm :meth:`AdamW.update` returns; the schedule is read at the
1-based step; the update is ``-lr·(m̂/(√v̂ + eps) + wd·p)``. Nothing is
updated in place: :meth:`AdamW.update` returns new moments and
:func:`apply_updates` a new model, as the JAX functions return new trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.lm import rebuild


class AdamState(NamedTuple):
    step: torch.Tensor               # [] int32
    m: dict                          # name -> first moment
    v: dict                          # name -> second moment


def named(tree) -> dict:
    """name -> tensor of a model (its parameters, detached) or a mapping."""
    if isinstance(tree, nn.Module):
        return {n: p.detach() for n, p in tree.named_parameters()}
    return dict(tree)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``peak_lr`` over ``warmup`` steps, then a
    cosine to ``floor·peak_lr`` at ``total``. ``step`` is a tensor (or an
    int); the result is a float32 tensor on its device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant(lr_value: float) -> Callable:
    return lambda step: torch.tensor(
        lr_value, dtype=torch.float32,
        device=step.device if isinstance(step, torch.Tensor) else None)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ‖x‖²) over the leaves (of a model, a mapping or a list), in
    float32. DTensor leaves (a state on a mesh) go by their local shards
    (:func:`_mesh_norms`); the result is then replicated on their mesh."""
    leaves = (list(tree) if isinstance(tree, (list, tuple))
              else list(named(tree).values()))
    dts = [x for x in leaves if isinstance(x, DTensor)]
    if not dts:
        norms = torch._foreach_norm([x.float() for x in leaves])
        return torch.linalg.vector_norm(torch.stack(norms))
    mesh = dts[0].device_mesh
    gn = torch.linalg.vector_norm(torch.stack(_mesh_norms(leaves, mesh)))
    return DTensor.from_local(gn, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh_norms(leaves, mesh) -> list[torch.Tensor]:
    """Each leaf's norm, from its local shard: the shard's norm where the
    leaf is whole on every rank, else the square root of its shards'
    squared norms summed over the mesh dims that split it (one all-reduce
    of a vector of scalars per set of such dims). DTensor would gather
    every leaf whole for ``_foreach_norm``. A partial sum is reduced
    first. Plain leaves count as replicated."""
    locs, split = [], []
    for x in leaves:
        if isinstance(x, DTensor):
            if any(isinstance(q, Partial) for q in x.placements):
                x = x.redistribute(mesh, [Replicate() if isinstance(
                    q, Partial) else q for q in x.placements])
            locs.append(x.to_local())
            split.append(tuple(m for m, q in enumerate(x.placements)
                               if isinstance(q, Shard)))
        else:
            locs.append(x)
            split.append(())
    norms = list(torch._foreach_norm([t.float() for t in locs]))
    for dims in sorted(set(split) - {()}):
        idx = [i for i, d in enumerate(split) if d == dims]
        sq = torch.stack([norms[i] for i in idx]) ** 2
        sq = DTensor.from_local(sq, mesh, [
            Partial() if m in dims else Replicate()
            for m in range(mesh.ndim)], run_check=False).full_tensor()
        for i, n in zip(idx, torch.sqrt(sq)):
            norms[i] = n
    return norms


def _reduced(g):
    """A gradient with its pending partial sums reduced (a DTensor that is
    partial over some mesh dims: a leaf whose uses split its gradient),
    ``g`` itself otherwise. The moments then hold values, as the
    reference's do, and not a sum that each rank keeps a share of: a
    restored state, whose shares are not the ones the ranks kept, would
    round the next sums otherwise."""
    if not isinstance(g, DTensor) or not any(
            isinstance(q, Partial) for q in g.placements):
        return g
    return g.redistribute(g.device_mesh, [
        Replicate() if isinstance(q, Partial) else q for q in g.placements])


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else _f32(self.lr, step)

    def init(self, params) -> AdamState:
        """Zero moments like the parameters (DTensors for parameters on a
        mesh, with their placements) and step 0 (replicated on a mesh)."""
        p = named(params)
        first = next(iter(p.values()))
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        if isinstance(first, DTensor):
            step = DTensor.from_local(step, first.device_mesh,
                                      [Replicate()] * first.device_mesh.ndim,
                                      run_check=False)
        return AdamState(
            step=step,
            m={n: torch.zeros_like(t) for n, t in p.items()},
            v={n: torch.zeros_like(t) for n, t in p.items()})

    def update(self, grads: Mapping, state: AdamState, params):
        """Returns (updates by name, the new state, the unclipped global
        norm of ``grads``)."""
        names = list(state.m)
        p = named(params)
        g = [_reduced(grads[n]) for n in names]
        step = state.step + 1
        gn = global_norm(g)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            g = torch._foreach_mul(g, scale)
        b1, b2 = self.b1, self.b2
        m = torch._foreach_add(torch._foreach_mul(list(state.m.values()), b1),
                               torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul(list(state.v.values()), b2),
                               torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1 - b2))
        t = step.to(torch.float32)
        mc = 1 - _f32(b1, t) ** t
        vc = 1 - _f32(b2, t) ** t
        lr = self._lr(step)
        # u = (m / mc) / (sqrt(v / vc) + eps); update = -lr·(u + wd·p)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, vc)),
                                 self.eps)
        u = torch._foreach_div(torch._foreach_div(m, mc), den)
        u = torch._foreach_add(u, torch._foreach_mul([p[n] for n in names],
                                                     self.weight_decay))
        updates = torch._foreach_mul(u, -lr)
        return (dict(zip(names, updates)),
                AdamState(step=step, m=dict(zip(names, m)),
                          v=dict(zip(names, v))), gn)


def apply_updates(params, updates: Mapping):
    """params + updates: a new model of the same class (or a new dict, for
    a mapping of tensors)."""
    p = named(params)
    new = dict(zip(p, torch._foreach_add(list(p.values()),
                                         [updates[n] for n in p])))
    return rebuild(params, new) if isinstance(params, nn.Module) else new
