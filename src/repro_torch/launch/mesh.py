"""Mesh construction, after the JAX package's ``repro.launch.mesh``.

A ``DeviceMesh`` needs a process group with one rank per device of the
mesh. Importing this module touches no distributed state:

* :func:`dry_world` opens a world of N ranks on the ``"fake"`` backend in
  this one process (rank 0 of N; collectives return at once and move
  nothing), for meshes larger than the machine: shapes, shardings and the
  collectives a step issues, on meta tensors;
* :func:`local_world` opens a real world of one rank (``gloo`` for the CPU,
  ``nccl`` for the card) on a free localhost port;
* :func:`spawn_world` opens a real world of N ranks, one process each
  (``spawn``), and runs a function on every rank: the counterpart of the
  JAX package's mesh over every local device, on which a step computes
  with real collectives.

Each always tears its world down. Meshes are of the card's device type
unless the caller passes ``device_type="cpu"``, as entry points run on the
card unless asked for the CPU (a dry world's mesh holds meta tensors on
either). :func:`make_production_mesh` is the
16×16 ``("data", "model")`` mesh, or 2×16×16 ``("pod", "data", "model")``
with the ``"pod"`` axis between nodes.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import queue
import socket
import time
import traceback

import torch
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


# after a rank fails, how long the others' reports are awaited
_GRACE_S = 5.0


def _rank_main(rank: int, n_ranks: int, port: int, device_type: str,
               timeout_s: float, fn, args, out) -> None:
    """One rank of :func:`spawn_world`: open the group, run ``fn``, report
    (rank, ok, result or traceback), and always destroy the group. The
    report goes first: a rank that raised then closes its connections,
    and the others' collectives fail after the cause is known."""
    opened = False
    try:
        torch.set_num_threads(1)
        backend = "gloo"
        if device_type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout_s))
        opened = True
        out.put((rank, True, fn(rank, *args)))
    except BaseException:           # noqa: BLE001 - reported to the caller
        out.put((rank, False, traceback.format_exc()))
    finally:
        if opened:
            dist.destroy_process_group()


def spawn_world(n_ranks: int, fn, *args, device_type: str = DEFAULT_DEVICE,
                timeout_s: float = 600.0) -> list:
    """``[fn(rank, *args) for rank in range(n_ranks)]``, each rank in a
    process of its own (the ``spawn`` start method) in a real world of
    ``n_ranks`` ranks at a free localhost port: ``gloo`` on the CPU,
    ``nccl`` on the card with one card per rank (``cuda:{rank}``, raises
    with fewer cards than ranks). Inside ``fn`` the world is open, so
    :func:`make_local_mesh` and :func:`make_mesh` span its ranks.

    ``fn`` must be picklable (a module-level function) and return picklable
    values: numpy arrays and Python objects, not tensors (a tensor sent
    from a child lives in shared memory that goes with the child). Each
    rank's torch runs one thread: the ranks share the host's cores.

    Nothing waits forever: every process group has ``timeout_s`` (a stalled
    collective raises in its rank), and the whole call has ``timeout_s``
    from its start, after which every rank still alive is killed and the
    call raises ``TimeoutError``. A rank that raises makes the call raise
    ``RuntimeError`` with its rank and traceback (and those of the ranks
    that raised within a few seconds after it, most often in a collective
    it left), the other ranks killed."""
    if device_type == "cuda":
        resolve_device("cuda")
        n_cards = torch.cuda.device_count()
        if n_cards < n_ranks:
            raise RuntimeError(f"a world of {n_ranks} ranks needs {n_ranks} "
                               f"cards, this machine has {n_cards}")
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, port, device_type, timeout_s,
                               fn, args, out))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout_s
    results: dict = {}
    failed: dict = {}
    try:
        for p in procs:
            p.start()
        while len(results) + len(failed) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                if failed:
                    break
                late = sorted(set(range(n_ranks)) - set(results))
                raise TimeoutError(f"ranks {late} of {n_ranks} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and r not in failed
                        and p.exitcode not in (None, 0)]
                for r in dead:
                    failed[r] = (f"died with exit code {procs[r].exitcode} "
                                 f"before it reported")
                continue
            if ok:
                results[rank] = value
            else:
                failed[rank] = value
                # the other ranks' reports that follow from this one
                deadline = min(deadline, time.monotonic() + _GRACE_S)
        if failed:
            raise RuntimeError("\n".join(
                f"rank {r} of {n_ranks} raised:\n{failed[r]}"
                for r in sorted(failed)))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
    return [results[r] for r in range(n_ranks)]


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
