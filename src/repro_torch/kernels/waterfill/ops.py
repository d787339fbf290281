"""Wrappers for the Hopper waterfill kernel (``csrc/waterfill.cu``).

Two entry points share the kernel:

* :func:`waterfill` — dense per-link [L, F] inputs (the oracle cross-check
  surface: every link may carry its own w/backlog/ρ);
* :func:`waterfill_flows` — per-flow [F] vectors shared by all links (the
  allocator hot path: only the on-link mask is per-link, so the dense
  broadcasts are never materialized).

Tensors on the CPU go through the plain version
(:func:`repro_torch.kernels.waterfill.ref.waterfill_plain`); CUDA tensors
launch the kernel on the current stream, without synchronising, or raise.
The JAX kernel's ``block_links``/``block_flows`` tiling knobs and its
padding to 128 lanes are TPU layout concerns with no counterpart here: the
CUDA kernel runs one block per link and masks its own ragged flow edge.

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
from repro_torch.kernels.waterfill.ref import waterfill_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"

# Kernel launches in this process (CUDA tensors only; the CPU path never
# counts). Callers read and reset it to show which runs went through the
# kernel.
LAUNCHES = 0

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
            vp, vp, vp, ctypes.c_longlong, vp, vp, vp, vp,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, vp]
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


def _solve(weights, backlog, rho, mask, capacity, kind, dt, flow_stride):
    global LAUNCHES
    if mask.device.type == "cpu":
        return waterfill_plain(weights, backlog, rho, mask, capacity, kind,
                               dt)
    if mask.device.type != "cuda":
        raise ValueError(f"waterfill runs on cpu or cuda, not {mask.device}")
    L, F = mask.shape
    out = torch.empty((L, F), dtype=torch.float32, device=mask.device)
    if L == 0 or F == 0:
        return out
    lib = _lib()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.waterfill_launch(
            weights.data_ptr(), backlog.data_ptr(), rho.data_ptr(),
            flow_stride, mask.data_ptr(), capacity.data_ptr(),
            kind.data_ptr(), out.data_ptr(), L, F, float(dt), LIST_BUDGET,
            stream)
    if err != 0:
        raise RuntimeError("waterfill kernel launch failed: "
                           + lib.waterfill_error_string(err).decode())
    LAUNCHES += 1
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
