"""SSD forward: the Hopper chunk kernel (``csrc/ssd_chunk.cu``) plus the
inter-chunk linear recurrence and the combine step in PyTorch, as the JAX
package's ``kernels/ssd_scan/ops.py::ssd_scan`` leaves them to XLA.

:func:`ssd_chunk` is the kernel's wrapper: CPU tensors go through the
plain version (:func:`repro_torch.kernels.ssd_scan.ref.ssd_chunk_plain`);
CUDA tensors launch the kernel on the current stream, without
synchronising, or raise. The kernel takes one (batch, chunk) and a group of
heads per block; :func:`ssd_plan` states that launch plan in plain Python.

Training differentiates the chunk step through :class:`SsdChunk`, a
``torch.autograd.Function`` whose forward is the kernel (the plain version
on the CPU) and whose backward is the vector-Jacobian product of
:func:`ssd_chunk_plain`, recomputed from the saved inputs; the JAX package
has no backward kernel either. A call that needs no gradient (serving,
under ``torch.no_grad``) runs the forward alone. The rest of
:func:`ssd_scan` is PyTorch ops, which autograd differentiates itself.

On meta tensors :func:`ssd_chunk` is a shape function: empty outputs of
the kernel's shapes and dtypes, nothing run, no launch counted; it adds
the plain version's FLOPs for the same call (:func:`plain_flops`), and
the kernel's input and output bytes, to the open collective record
(``launch.comm_stats.count_flops``). DTensors
(a step on a ``DeviceMesh``) enter at :func:`ssd_scan`, which runs whole
on each rank's shard through ``local_map`` (:mod:`repro_torch.kernels.local`):
x keeps the batch and head splits its caller gave it, and dt, A, B and C
follow x's. B and C are shared by the heads of a batch row, so every rank
holds them whole; the kernel then infers the local head count H = BH / Bsz
from its own shard, and the gradients of B and C are partial sums over the
ranks that split the heads.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.build import load
from repro_torch.kernels.local import as_dtensor, kept, shard_index, unsplit
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain
from repro_torch.launch.comm_stats import count_flops, tensor_bytes

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
    [BH,nc,P,N], cum [BH,nc,Q,1]). Differentiable (:class:`SsdChunk`) where
    autograd asks for it."""
    _check(x, dt, B, C, A)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, B, C, A)):
        return SsdChunk.apply(x, dt, B, C, A)
    return _forward(x, dt, B, C, A)


class SsdChunk(torch.autograd.Function):
    """The kernel's forward; the backward is the vector-Jacobian product of
    :func:`ssd_chunk_plain`, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A):
        ctx.save_for_backward(x, dt, B, C, A)
        return _forward(x, dt, B, C, A)

    @staticmethod
    def backward(ctx, dy, dst, dcum):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            outs = ssd_chunk_plain(*leaves)
            return torch.autograd.grad(outs, leaves, (dy, dst, dcum))


def plain_flops(BH: int, nc: int, Q: int, P: int, N: int) -> int:
    """The FLOPs that ``torch.utils.flop_counter`` counts for
    :func:`ssd_chunk_plain` on x [BH,nc,Q,P] and B, C [·,nc,Q,N]: its three
    batched products C·Bᵀ, M·x and xᵀ·wB."""
    return 2 * BH * nc * Q * (Q * N + Q * P + P * N)


def _forward(x, dt, B, C, A):
    """The kernel on CUDA tensors, the plain version on CPU tensors, empty
    outputs on meta tensors (their plain version's FLOPs counted)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, B, C, A)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunk runs on cpu, cuda or meta, not "
                         f"{x.device}")
    BH, nc, Q, P = x.shape
    Bsz, N = B.shape[0], B.shape[3]
    y = torch.empty_like(x)
    st = torch.empty((BH, nc, P, N), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(dt)
    if x.device.type == "meta":
        count_flops(plain_flops(BH, nc, Q, P, N),
                    tensor_bytes(x, dt, B, C, A, y, st, cum))
        return y, st, cum
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


def _on_mesh(x, dt, A, B, C, chunk: int):
    """:func:`ssd_scan` on each rank's shard of DTensor inputs (see the
    module docstring); returns DTensors."""
    mesh = next(t for t in (x, dt, A, B, C)
                if isinstance(t, DTensor)).device_mesh
    x, dt, A, B, C = (as_dtensor(t, mesh) for t in (x, dt, A, B, C))
    x_pl = kept(x.placements, (0, 2))
    if x.shape[2] % shard_index(mesh, x_pl, 2)[1]:
        x_pl = unsplit(x_pl, 2)
    # dt [B,S,H] splits as x [B,S,H,P]; A [H] by heads, B/C [B,S,N] by
    # batch, the final state [B,H,P,N] by batch and heads
    a_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in x_pl)
    bc_pl = unsplit(x_pl, 2)
    h_pl = tuple(Shard(1) if p == Shard(2) else p for p in x_pl)
    # a rank that holds some of the heads holds a partial sum of B's and
    # C's gradients, and one that holds some of the batch rows a partial
    # sum of A's
    bc_grad = tuple(Partial() if p == Shard(2) else p for p in x_pl)
    a_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(x_pl, a_pl))
    return local_map(
        lambda *t: ssd_scan(*t, chunk=chunk), out_placements=(x_pl, h_pl),
        in_placements=(x_pl, x_pl, a_pl, bc_pl, bc_pl),
        in_grad_placements=(x_pl, x_pl, a_grad, bc_grad, bc_grad),
        device_mesh=mesh, redistribute_inputs=True)(x, dt, A, B, C)


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """Full SSD: x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,N]. Returns
    (y [B,S,H,P], final_state [B,H,P,N]), float32. DTensors go through
    :func:`_on_mesh`."""
    if any(isinstance(t, DTensor) for t in (x, dt, A, B, C)):
        return _on_mesh(x, dt, A, B, C, chunk)
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

    # inter-chunk recurrence: the state entering each chunk (collected in a
    # list and stacked, not written into a buffer, so that autograd keeps
    # every chunk's state)
    h = torch.zeros((Bsz * H, P, N), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, None, None] + states[:, c]
    h_prev = torch.stack(entering, dim=1)                 # [BH, nc, P, N]

    # combine: y = y_intra + exp(cum)·(C · h_prev); C is read per batch row
    y_inter = torch.einsum("bcqn,bhcpn->bhcqp", Ck,
                           h_prev.view(Bsz, H, nc, P, N))
    y_inter = y_inter * torch.exp(cum).view(Bsz, H, nc, chunk, 1)
    y = (y_intra.view(Bsz, H, nc, chunk, P) + y_inter).reshape(Bsz, H, S, P)
    return y.permute(0, 2, 1, 3), h.view(Bsz, H, P, N)
