"""Kernels on the local shards of DTensors.

A kernel takes plain local tensors. On a ``DeviceMesh`` its wrapper reaches
it through ``local_map``, with placements read from the inputs' own (set by
the caller, as the model's ``shard_as`` sets them): each input keeps its
split of the tensor dims that the kernel can take split (batch, heads),
and is gathered along any other (a sequence split, a partial sum).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    (the same on every rank) as replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def kept(placements, dims) -> tuple:
    """``placements`` with ``Shard(d)`` kept for d in ``dims`` and every
    other placement made ``Replicate()``."""
    return tuple(p if type(p) is Shard and p.dim in dims else Replicate()
                 for p in placements)


def shard_index(mesh, placements, dim: int) -> tuple[int, int]:
    """(this rank's shard, the number of shards) of tensor dim ``dim``
    under ``placements``: the mesh coordinates of the dims that shard it,
    read major to minor."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.shape[m] + coord[m]
            count *= mesh.shape[m]
    return index, count


def unsplit(placements, dim: int) -> tuple:
    """``placements`` with tensor dim ``dim`` replicated."""
    return tuple(Replicate() if p == Shard(dim) else p for p in placements)
