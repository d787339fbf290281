"""Wrappers for the Hopper waterfill kernel (``csrc/waterfill.cu``).

Three entry points share the kernel:

* :func:`waterfill` — dense per-link [L, F] inputs (the oracle cross-check
  surface: every link may carry its own w/backlog/ρ);
* :func:`waterfill_flows` — per-flow [F] vectors shared by all links (the
  allocator hot path: only the on-link mask is per-link, so the dense
  broadcasts are never materialized);
* :func:`waterfill_fleet` — a fleet bucket's B solves in one launch: [B, F]
  flow state, one row per scenario, shared by that scenario's L links;
  B·L blocks, block ``l`` reading flow row ``l // L`` (the kernel's group
  stride).

Tensors on the CPU go through the plain version
(:func:`repro_torch.kernels.waterfill.ref.waterfill_plain`); CUDA tensors
launch the kernel on the current stream, without synchronising, or raise;
meta tensors get an empty [L, F] output of the kernel's shape (a shape
function: nothing runs, no launch is counted). The JAX kernel's
``block_links``/``block_flows`` tiling knobs and its padding to 128 lanes
are TPU layout concerns with no counterpart here: the CUDA kernel runs one
block per link and masks its own ragged flow edge.

The kernel lists each link's masked flows in shared memory, at most
:data:`LIST_BUDGET` of them; a row with more walks its row in device memory
on every pass (a branch the data chooses inside the kernel, so the
allocator never waits on the host). :func:`list_smem_bytes` and
:func:`streamed_rows` state that plan in plain Python.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.waterfill.ref import (
    waterfill_fleet_plain,
    waterfill_plain,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"

# Kernel launches in this process (CUDA tensors only; the CPU path never
# counts). Callers read and reset it to show which runs went through the
# kernel.
LAUNCHES = 0
# The same launches by (card index, CUDA stream handle) they were queued
# on: a sharded campaign's streams each launch their own.
STREAM_LAUNCHES: dict = {}

# Masked flows a link's on-chip list holds (16 bytes each: index, mask
# value and two floats of flow state). A datacenter downlink carries ~48,
# an allocator-benchmark link ~0.4; 2,048 (32 KB) leaves room for seven
# blocks per SM.
LIST_BUDGET = 2048
LIST_ENTRY_BYTES = 16

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = load("waterfill", SOURCE)
        vp = ctypes.c_void_p
        lib.waterfill_launch.argtypes = [
            vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, vp]
        lib.waterfill_launch.restype = ctypes.c_int
        lib.waterfill_list_entry_bytes.restype = ctypes.c_int
        if lib.waterfill_list_entry_bytes() != LIST_ENTRY_BYTES:
            raise RuntimeError("waterfill.cu's list entry is "
                               f"{lib.waterfill_list_entry_bytes()} bytes, "
                               f"ops.py plans {LIST_ENTRY_BYTES}")
        lib.waterfill_error_string.argtypes = [ctypes.c_int]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def list_smem_bytes(budget: int = LIST_BUDGET) -> int:
    """Dynamic shared memory of one block: the list of ``budget`` flows."""
    if budget < 0:
        raise ValueError(f"list budget must be >= 0, got {budget}")
    return budget * LIST_ENTRY_BYTES


def streamed_rows(mask: torch.Tensor, budget: int = LIST_BUDGET):
    """[L] bool: the rows whose masked flows overflow the list, and which the
    kernel therefore solves from device memory."""
    return (mask != 0).sum(1) > budget


def launch_plan(L: int, F: int, flow_stride: int, links_per_group: int = 0):
    """The kernel's grid and flow-row addressing for ``L`` link rows of
    ``F`` flows: one block of 256 threads per link row, and block ``l``
    reads its flow state at element offset ``(l // links_per_group) *
    group_stride + l * flow_stride``. ``links_per_group = 0`` is the
    legacy layouts (flow_stride 0: one shared row; F: dense rows); a fleet
    bucket of B scenarios is ``L = B·links``, flow_stride 0, one group of
    ``links`` rows per scenario with group stride F."""
    if links_per_group < 0:
        raise ValueError(f"links_per_group must be >= 0, got "
                         f"{links_per_group}")
    if links_per_group and L % links_per_group:
        raise ValueError(f"{L} link rows are not whole groups of "
                         f"{links_per_group}")
    return {"grid": L, "threads": 256, "flow_stride": flow_stride,
            "links_per_group": links_per_group,
            "group_stride": F if links_per_group else 0,
            "smem_bytes": list_smem_bytes()}


def _check(weights, backlog, rho, mask, capacity, kind, flow_shape):
    if mask.dim() != 2:
        raise ValueError(f"mask must be [L, F], got {tuple(mask.shape)}")
    L, F = mask.shape
    named = {"weights": weights, "backlog": backlog, "rho": rho,
             "mask": mask, "capacity": capacity, "kind": kind}
    for nm, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor")
        if t.device != mask.device:
            raise ValueError(f"{nm} is on {t.device}, mask on {mask.device}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
        want = torch.int32 if nm == "kind" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{nm} must be {want}, got {t.dtype}")
    for nm in ("weights", "backlog", "rho"):
        if tuple(named[nm].shape) != flow_shape(L, F):
            raise ValueError(f"{nm} must be {flow_shape(L, F)}, got "
                             f"{tuple(named[nm].shape)}")
    for nm in ("capacity", "kind"):
        if tuple(named[nm].shape) != (L,):
            raise ValueError(f"{nm} must be ({L},), got "
                             f"{tuple(named[nm].shape)}")


def _solve(weights, backlog, rho, mask, capacity, kind, dt, flow_stride,
           links_per_group=0):
    global LAUNCHES
    if mask.device.type == "cpu":
        if links_per_group:
            Bn, F = weights.shape
            return waterfill_fleet_plain(
                weights, backlog, rho,
                mask.reshape(Bn, links_per_group, F),
                capacity.reshape(Bn, links_per_group),
                kind.reshape(Bn, links_per_group), dt).reshape(-1, F)
        return waterfill_plain(weights, backlog, rho, mask, capacity, kind,
                               dt)
    if mask.device.type not in ("cuda", "meta"):
        raise ValueError(f"waterfill runs on cpu, cuda or meta, not "
                         f"{mask.device}")
    L, F = mask.shape
    out = torch.empty((L, F), dtype=torch.float32, device=mask.device)
    if L == 0 or F == 0 or mask.device.type == "meta":
        return out
    plan = launch_plan(L, F, flow_stride, links_per_group)
    lib = _lib()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.waterfill_launch(
            weights.data_ptr(), backlog.data_ptr(), rho.data_ptr(),
            plan["flow_stride"], plan["links_per_group"],
            plan["group_stride"], mask.data_ptr(), capacity.data_ptr(),
            kind.data_ptr(), out.data_ptr(), L, F, float(dt), LIST_BUDGET,
            stream)
    if err != 0:
        raise RuntimeError("waterfill kernel launch failed: "
                           + lib.waterfill_error_string(err).decode())
    LAUNCHES += 1
    key = (mask.device.index, stream)
    STREAM_LAUNCHES[key] = STREAM_LAUNCHES.get(key, 0) + 1
    return out


def waterfill(weights, backlog, rho, mask, capacity, kind,
              dt: float = 1.0) -> torch.Tensor:
    """Batched per-link allocator solve, dense per-link inputs.

    weights/backlog/rho/mask: [L, F] float32; capacity: [L] float32;
    kind: [L] int32 (1 = downlink, else uplink). Returns [L, F]."""
    _check(weights, backlog, rho, mask, capacity, kind, lambda L, F: (L, F))
    return _solve(weights, backlog, rho, mask, capacity, kind, dt,
                  mask.shape[1])


def waterfill_flows(weights, backlog, rho, mask, capacity, kind,
                    dt: float = 1.0) -> torch.Tensor:
    """Batched per-link solve with *shared* per-flow inputs.

    weights/backlog/rho: [F] (the same flow state is visible to every
    link); mask: [L, F]; capacity/kind: [L]. Returns [L, F]. Equivalent to
    :func:`waterfill` on ``v.expand(L, F)`` inputs without ever
    materializing the broadcasts."""
    _check(weights, backlog, rho, mask, capacity, kind, lambda L, F: (F,))
    return _solve(weights, backlog, rho, mask, capacity, kind, dt, 0)


def waterfill_fleet(weights, backlog, rho, mask, capacity, kind,
                    dt: float = 1.0) -> torch.Tensor:
    """A fleet bucket's per-link solves in one launch.

    weights/backlog/rho: [B, F] (scenario b's flow state, shared by its
    links); mask: [B, L, F]; capacity/kind: [B, L]. Returns [B, L, F],
    equal to :func:`waterfill_flows` on each scenario's slice. One launch
    of B·L blocks however many scenarios the bucket holds."""
    if mask.dim() != 3:
        raise ValueError(f"mask must be [B, L, F], got {tuple(mask.shape)}")
    Bn, L, F = mask.shape
    for nm, t, shape in (("weights", weights, (Bn, F)),
                         ("backlog", backlog, (Bn, F)),
                         ("rho", rho, (Bn, F)),
                         ("capacity", capacity, (Bn, L)),
                         ("kind", kind, (Bn, L))):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{nm} must be {shape}, got {tuple(t.shape)}")
    for nm, t in (("mask", mask), ("capacity", capacity), ("kind", kind)):
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    flat, cap, knd = (mask.reshape(Bn * L, F), capacity.reshape(Bn * L),
                      kind.reshape(Bn * L))
    _check(weights, backlog, rho, flat, cap, knd, lambda L_, F_: (Bn, F_))
    return _solve(weights, backlog, rho, flat, cap, knd, dt, 0,
                  links_per_group=L).reshape(Bn, L, F)
