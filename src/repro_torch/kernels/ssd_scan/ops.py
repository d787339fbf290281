"""SSD forward: the Hopper chunk kernel (``csrc/ssd_chunk.cu``) plus the
inter-chunk linear recurrence and the combine step in PyTorch, as the JAX
package's ``kernels/ssd_scan/ops.py::ssd_scan`` leaves them to XLA.

:func:`ssd_chunk` is the kernel's wrapper: CPU tensors go through the
plain version (:func:`repro_torch.kernels.ssd_scan.ref.ssd_chunk_plain`);
CUDA tensors launch the kernel on the current stream, without
synchronising, or raise. The kernel takes one (batch, chunk) and a group of
heads per block; :func:`ssd_plan` states that launch plan in plain Python.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain

NAME = "ssd_chunk"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
# the kernel's tiles: chunk length, head dim and state width
MAX_Q, MAX_P, MAX_N = 128, 64, 128
SMEM_LIMIT = 232_448      # shared memory one block may ask for on an H100
H100_SMS = 132

# Kernel launches in this process (CUDA tensors only; the CPU path never
# counts). Callers read and reset it to show which runs went through the
# kernel.
LAUNCHES = 0

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = load(NAME, SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                         i, i, i, i, i, i, i, vp]
        lib.ssd_chunk_launch.restype = i
        lib.ssd_chunk_smem_bytes.argtypes = [i]
        lib.ssd_chunk_smem_bytes.restype = i
        lib.ssd_chunk_error_string.argtypes = [i]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_dims(Q: int, P: int, N: int) -> None:
    if not (1 <= Q <= MAX_Q and 1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"chunk {Q}, head dim {P}, state {N} exceed the "
                         f"kernel's {MAX_Q}, {MAX_P}, {MAX_N}")


class SsdPlan(NamedTuple):
    """How the kernel is launched: ``group`` heads per block (C·Bᵀ is formed
    once per block and shared by them), ``blocks`` blocks of 384 threads,
    ``smem_bytes`` of dynamic shared memory each."""
    group: int
    blocks: int
    smem_bytes: int


def smem_bytes(N: int) -> int:
    """The kernel's shared memory at state width N: xᵀ as tf32 hi and lo
    [64][128] each, the next head's x [128][64], C·Bᵀ (its causal 64 × 64
    and 64 × 128 blocks, 48 KB), B raw [128][N padded to 64, + 4], cum, dt
    and the state weights of two heads [2][128] each, and 1 KB to align the
    swizzled tiles (``csrc/ssd_chunk.cu::smem_bytes``)."""
    n_pad = -(-N // 64) * 64
    return 1024 + 4 * (3 * MAX_P * MAX_Q + 64 * (64 + 128)
                       + MAX_Q * (n_pad + 4) + 6 * MAX_Q)


def ssd_plan(Bsz: int, H: int, nc: int, Q: int, P: int, N: int,
             sms: int = H100_SMS) -> SsdPlan:
    """The launch plan for Bsz·H heads, nc chunks of Q rows, head dim P and
    state width N on a card of ``sms`` SMs. One block runs per SM (182 or
    214 KB of shared memory), so the heads of each (batch, chunk) are cut
    into as many groups as fill about one wave of blocks, and no more:
    every extra group forms C·Bᵀ once more. Raises on shapes the kernel is
    not built for."""
    _check_dims(Q, P, N)
    if min(Bsz, H, nc, sms) < 1:
        raise ValueError(f"Bsz {Bsz}, H {H}, nc {nc} and sms {sms} must be "
                         ">= 1")
    units = Bsz * nc
    groups = min(H, max(1, sms // units))
    group = -(-H // groups)
    n_groups = -(-H // group)
    return SsdPlan(group=group, blocks=n_groups * units,
                   smem_bytes=smem_bytes(N))


def _check(x, dt, B, C, A) -> None:
    named = {"x": x, "dt": dt, "B": B, "C": C, "A": A}
    for nm, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{nm} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{nm} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"x must be [BH, nc, Q, P], got {tuple(x.shape)}")
    BH, nc, Q, P = x.shape
    if B.dim() != 4 or B.shape[1:3] != (nc, Q) or C.shape != B.shape:
        raise ValueError(f"B and C must be [Bsz, {nc}, {Q}, N], got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if B.shape[0] == 0 or BH % B.shape[0]:
        raise ValueError(f"BH = {BH} is not a multiple of Bsz = {B.shape[0]}")
    if tuple(dt.shape) != (BH, nc, Q, 1):
        raise ValueError(f"dt must be ({BH}, {nc}, {Q}, 1), got "
                         f"{tuple(dt.shape)}")
    if tuple(A.shape) != (BH, 1):
        raise ValueError(f"A must be ({BH}, 1), got {tuple(A.shape)}")
    _check_dims(Q, P, B.shape[3])


def ssd_chunk(x, dt, B, C, A):
    """Per (batch·head, chunk) intra-chunk SSD. x: [BH,nc,Q,P]; dt:
    [BH,nc,Q,1]; B, C: [Bsz,nc,Q,N] (the heads of a batch row share them);
    A: [BH,1]; all float32. Returns (y_intra [BH,nc,Q,P], states
    [BH,nc,P,N], cum [BH,nc,Q,1])."""
    global LAUNCHES
    _check(x, dt, B, C, A)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, B, C, A)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {x.device}")
    BH, nc, Q, P = x.shape
    Bsz, N = B.shape[0], B.shape[3]
    y = torch.empty_like(x)
    st = torch.empty((BH, nc, P, N), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(dt)
    if x.numel() == 0:
        return y, st, cum
    H = BH // Bsz
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ssd_plan(Bsz, H, nc, Q, P, N, sms=sms)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), y.data_ptr(), st.data_ptr(), cum.data_ptr(),
            Bsz, H, nc, Q, P, N, plan.group, stream)
    if err != 0:
        raise RuntimeError("ssd_chunk kernel launch failed: "
                           + lib.ssd_chunk_error_string(err).decode())
    LAUNCHES += 1
    return y, st, cum


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """Full SSD: x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,N]. Returns
    (y [B,S,H,P], final_state [B,H,P,N]), float32."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by ssd chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32

    # the kernel's layout: one [Q, P] tile per (batch·head, chunk)
    xk = x.to(f32).permute(0, 2, 1, 3).reshape(Bsz * H, nc, chunk, P)
    dtk = dt.to(f32).permute(0, 2, 1).reshape(Bsz * H, nc, chunk, 1)
    Bk = B.to(f32).reshape(Bsz, nc, chunk, N).contiguous()
    Ck = C.to(f32).reshape(Bsz, nc, chunk, N).contiguous()
    Ak = A.to(f32)[None, :].expand(Bsz, H).reshape(Bsz * H, 1)
    y_intra, states, cum = ssd_chunk(xk.contiguous(), dtk.contiguous(), Bk,
                                     Ck, Ak.contiguous())
    cum = cum[..., 0]                                     # [BH, nc, Q]
    chunk_decay = torch.exp(cum[:, :, -1])                # [BH, nc]

    # inter-chunk recurrence: the state entering each chunk
    h = torch.zeros((Bsz * H, P, N), dtype=f32, device=x.device)
    h_prev = torch.empty((Bsz * H, nc, P, N), dtype=f32, device=x.device)
    for c in range(nc):
        h_prev[:, c] = h
        h = h * chunk_decay[:, c, None, None] + states[:, c]

    # combine: y = y_intra + exp(cum)·(C · h_prev); C is read per batch row
    y_inter = torch.einsum("bcqn,bhcpn->bhcqp", Ck,
                           h_prev.view(Bsz, H, nc, P, N))
    y_inter = y_inter * torch.exp(cum).view(Bsz, H, nc, chunk, 1)
    y = (y_intra.view(Bsz, H, nc, chunk, P) + y_inter).reshape(Bsz, H, S, P)
    return y.permute(0, 2, 1, 3), h.view(Bsz, H, P, N)
