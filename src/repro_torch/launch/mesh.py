"""Mesh construction, after the JAX package's ``repro.launch.mesh``.

A ``DeviceMesh`` needs a process group with one rank per device of the
mesh. Importing this module touches no distributed state:

* :func:`dry_world` opens a world of N ranks on the ``"fake"`` backend in
  this one process (rank 0 of N; collectives return at once and move
  nothing), for meshes larger than the machine: shapes, shardings and the
  collectives a step issues, on meta tensors;
* :func:`local_world` opens a real world of one rank (``gloo`` for the CPU,
  ``nccl`` for the card) on a free localhost port.

Both always tear the world down. Meshes are of the card's device type
unless the caller passes ``device_type="cpu"``, as entry points run on the
card unless asked for the CPU (a dry world's mesh holds meta tensors on
either). :func:`make_production_mesh` is the
16×16 ``("data", "model")`` mesh, or 2×16×16 ``("pod", "data", "model")``
with the ``"pod"`` axis between nodes.
"""
from __future__ import annotations

import contextlib
import math
import socket

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def make_mesh(shape, axes, device_type: str = DEFAULT_DEVICE) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the open world, whose size
    must be the product of ``shape``; raises for "cuda" without a card."""
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("no process group is open: use dry_world(n) or "
                           "local_world() around the mesh")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {n}")
    return init_device_mesh(resolve_device(device_type).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = DEFAULT_DEVICE) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(model_parallel: int = 1,
                    device_type: str = DEFAULT_DEVICE) -> DeviceMesh:
    """A ("data", "model") mesh over the open world's ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = math.gcd(model_parallel, n)
    return make_mesh((n // mp, mp), ("data", "model"), device_type)


@contextlib.contextmanager
def dry_world(n_ranks: int, rank: int = 0):
    """A world of ``n_ranks`` ranks on the ``"fake"`` backend, this process
    being ``rank``; destroyed on exit."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_world(device_type: str = DEFAULT_DEVICE):
    """A real world of one rank (``nccl`` on the card, ``gloo`` on the
    CPU) at a free localhost port; destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --- NVIDIA H100 SXM5 80GB hardware constants, at its 700 W power limit ----
# Dense bf16 tensor-core peak, no sparsity (NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 column: 1,979 TFLOP/s with sparsity, half that dense).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per GPU
# HBM3 bandwidth (same datasheet, SXM5 column: 3.35 TB/s).
HBM_BW = 3.35e12                # B/s per GPU
# HBM3 capacity (same datasheet, SXM5 column: 80 GB).
HBM_CAPACITY = 80e9             # B per GPU
# NVLink 4 within a node: 900 GB/s per GPU in both directions together
# (same datasheet), 450 GB/s each way.
NVLINK_BW = 450e9               # B/s per GPU, one direction
# Between nodes: one 400 Gb/s ConnectX-7 NDR InfiniBand port per GPU
# (NVIDIA DGX H100 datasheet), 50 GB/s each way; the "pod" axis.
INTER_NODE_BW = 50e9            # B/s per GPU, one direction
