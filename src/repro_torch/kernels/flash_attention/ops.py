"""Wrapper for the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` takes the model's [B,S,H,hd] layout, like the JAX
package's ``kernels/flash_attention/ops.py::flash_attention``; the CUDA
kernel reads that layout in place, so nothing is transposed on the card.
Tensors on the CPU go through the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_plain`); CUDA
tensors launch the kernel on the current stream, without synchronising, or
raise. The JAX kernel's ``block_q``/``block_k`` knobs and its
``S % block_q == 0`` requirement have no counterpart: the CUDA kernels use
fixed 64-row tiles and mask their own ragged edge.

Training differentiates it through :class:`FlashAttention`, a
``torch.autograd.Function``: its forward is the kernel (the plain version on
the CPU), and its backward recomputes :func:`attention_plain` from the saved
q, k and v in float32 and returns that function's vector-Jacobian product
in the inputs' dtype. The JAX package has no backward kernel either (its
training differentiates XLA's attention). A call that needs no gradient
(serving, under ``torch.no_grad``) runs the forward alone, as before.

The source holds two kernels, and :func:`kernel_for` picks one by dtype:
both run on the tensor cores with their tiles brought in by TMA, bfloat16
as bf16 products, float32 as split-TF32 products (three tf32 products per
float32 product, near float32; one tf32 product would round float32 inputs
past the tolerance). Both read q, k and v through tensor maps whose plan
(:func:`tma_plan`) the wrapper computes and checks (:func:`check_tma_operand`)
before the library encodes it.

On meta tensors the wrapper is a shape function: it returns an empty
output of the kernel's shape and dtype, runs nothing and counts no launch.
It adds the plain version's FLOPs for the same call (:func:`plain_flops`),
and the kernel's input and output bytes, to the open collective record
(``launch.comm_stats.count_flops``), without allocating the [B,H,S,T]
scores the plain version would.
DTensors (a step on a ``DeviceMesh``) reach the kernel through
``local_map`` (:mod:`repro_torch.kernels.local`), so that each rank hands
the kernel plain local tensors: q keeps the batch and head splits its
caller gave it, k and v follow q's batch split, and their heads follow
q's where the caller split them over the same mesh dims and evenly. Else
the KV heads are whole on every rank while the query heads are split; a
rank's query heads then read only some of the KV heads, and the rank
passes exactly those (:func:`kv_heads_for`), so that the kernel's map from
query head h to KV head h // G holds locally; their gradients are then
partial sums over the ranks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.local import as_dtensor, kept, shard_index, unsplit
from repro_torch.launch.comm_stats import count_flops, tensor_bytes

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)     # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535                # the CUDA limit on gridDim.y
TILE_ROWS = 64                    # rows of a q or k/v tile (a TMA box)
PLAN_LEN = 12                     # int64s of one operand's tensor-map plan

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
        lib.flash_attention_f32_launch.argtypes = [vp, vp, vp, vp, vp, i, i,
                                                   i, i, i, i, i, vp]
        lib.flash_attention_f32_launch.restype = i
        lib.flash_attention_bf16_launch.argtypes = [vp, vp, vp, vp, vp, i, i,
                                                    i, i, i, i, i, vp]
        lib.flash_attention_bf16_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_for(dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` takes inputs of ``dtype``:
    ``"bf16"`` (bf16 products) or ``"f32"`` (split-TF32 products), both on
    the tensor cores with TMA."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")


class TmaPlan(NamedTuple):
    """A 4-D tensor map over a contiguous [B, N, X, hd] tensor (N rows: S or
    T; X heads: H or K), innermost first: (hd, X, N, B). A box is one head's
    64 rows of ``box[0]`` columns; a row of hd elements is swizzled at its
    own width up to 128 bytes, and wider rows take several 128-byte boxes
    (bf16: hd 128 in two; float32: hd 64 in two, hd 128 in four). Rows past
    N are zero-filled by TMA and never reach into the next batch."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]        # bytes, of dims 1..3
    box: tuple[int, int, int, int]
    swizzle: int                          # bytes
    boxes: int                            # boxes per 64-row tile

    def flat(self) -> list[int]:
        return [*self.dims, *self.strides, *self.box, self.swizzle]


def _elem_bytes(dtype: torch.dtype) -> int:
    kernel_for(dtype)
    return torch.empty((), dtype=dtype).element_size()


def tma_plan(shape, dtype: torch.dtype = torch.bfloat16) -> TmaPlan:
    """The tensor-map plan of a contiguous tensor of ``shape`` [B, N, X, hd]
    and ``dtype`` (bfloat16 or float32)."""
    size = _elem_bytes(dtype)
    B, N, X, hd = (int(d) for d in shape)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    swizzle = min(size * hd, 128)
    cols = swizzle // size
    row = size * hd
    return TmaPlan(dims=(hd, X, N, B), strides=(row, X * row, N * X * row),
                   box=(cols, 1, TILE_ROWS, 1), swizzle=swizzle,
                   boxes=hd // cols)


def check_tma_operand(name: str, ptr: int, shape,
                      dtype: torch.dtype = torch.bfloat16) -> None:
    """TMA reads from a 16-byte aligned base, with every stride a multiple of
    16 bytes: raise on a tensor (a view, say) that breaks that."""
    if ptr % 16:
        raise ValueError(f"{name}: base address {ptr:#x} is not 16-byte "
                         "aligned, which the kernels' TMA needs")
    row = _elem_bytes(dtype) * int(shape[2]) * int(shape[3])
    if row % 16:
        raise ValueError(f"{name}: row stride {row} bytes is not a multiple "
                         "of 16, which the kernels' TMA needs")


def _check(q, k, v) -> None:
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{nm} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{nm} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{nm} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{nm} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    B, S, H, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v must be [{B}, T, K, {hd}], got "
                         f"{tuple(k.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: [B,S,H,hd]; k, v: [B,T,K,hd] with H = K·G -> [B,S,H,hd] in q's
    dtype. Causal means key j is seen by query i iff j <= i.
    Differentiable (:class:`FlashAttention`) where autograd asks for it.
    DTensors go through :func:`_on_mesh`."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return _on_mesh(q, k, v, causal)
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def kv_heads_for(shard: int, local_heads: int, group: int) -> tuple[int, int]:
    """(first, count) of the KV heads that query heads ``shard·local_heads``
    .. ``(shard+1)·local_heads - 1`` read, G = ``group`` query heads per KV
    head. The local map h // (local_heads / count) then equals the global
    one, h // G, less ``first``. Raises where the local heads straddle KV
    heads unevenly (neither of ``local_heads`` and G divides the other)."""
    if group % local_heads and local_heads % group:
        raise ValueError(f"{local_heads} local query heads do not split "
                         f"evenly over KV heads of {group} query heads")
    return shard * local_heads // group, max(1, local_heads // group)


def _on_mesh(q, k, v, causal: bool):
    """The kernel on each rank's shard of DTensor inputs (see the module
    docstring); returns a DTensor with q's local layout."""
    mesh = next(t for t in (q, k, v) if isinstance(t, DTensor)).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    H, K = q.shape[2], k.shape[2]
    q_pl = kept(q.placements, (0, 2))
    shard, n = shard_index(mesh, q_pl, 2)
    if n > 1 and (H % n or (H // K) % (H // n) and (H // n) % (H // K)):
        # the local query heads would straddle KV heads unevenly
        q_pl = unsplit(q_pl, 2)
        shard, n = 0, 1
    heads = [m for m, p in enumerate(q_pl) if p == Shard(2)]
    aligned = K % n == 0 and all(k.placements[m] == Shard(2) for m in heads)
    kv_pl = q_pl if aligned else unsplit(q_pl, 2)
    first, count = (0, K) if aligned else kv_heads_for(shard, H // n, H // K)
    # a rank that reads only some KV heads holds a partial sum of their
    # gradients
    kv_grad = tuple(Partial() if m in heads and not aligned else p
                    for m, p in enumerate(kv_pl))

    def local(ql, kl, vl):
        if count < kl.shape[2]:
            kl, vl = kl[:, :, first:first + count], vl[:, :, first:first + count]
        return flash_attention(ql.contiguous(), kl.contiguous(),
                               vl.contiguous(), causal)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _plain(q, k, v, causal: bool) -> torch.Tensor:
    """:func:`attention_plain` in the model's [B,S,H,hd] layout."""
    o = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal)
    return o.transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; the backward is the vector-Jacobian product of
    :func:`attention_plain`, recomputed in float32 from the saved inputs
    (the [B,H,S,T] scores exist only inside the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            out = _plain(qf, kf, vf, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf),
                                             grad_out.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def plain_flops(q_shape, k_shape) -> int:
    """The FLOPs that ``torch.utils.flop_counter`` counts for
    :func:`attention_plain` on q [B,S,H,hd] and k, v [B,T,K,hd]: its two
    einsums are batched products of 2·B·H·S·T·hd each, and an einsum whose
    contracted dim (hd, then T) has size 1 is a product without a sum,
    which the counter does not count."""
    B, S, H, hd = q_shape
    T = k_shape[1]
    return 2 * B * H * S * T * hd * ((hd > 1) + (T > 1))


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors, an
    empty output on meta tensors (its plain version's FLOPs counted)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return _plain(q, k, v, causal)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        count_flops(plain_flops(q.shape, k.shape),
                    tensor_bytes(q, k, v, out))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    launch = f"flash_attention_{kernel_for(q.dtype)}_launch"
    # gridDim.y counts the query tiles
    if -(-S // TILE_ROWS) > MAX_GRID_Y:
        raise ValueError(f"{-(-S // TILE_ROWS)} query tiles exceed "
                         f"{MAX_GRID_Y}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plans = []
    for nm, t in (("q", q), ("k", k), ("v", v)):
        check_tma_operand(nm, t.data_ptr(), t.shape, t.dtype)
        plans += tma_plan(t.shape, t.dtype).flat()
    plans = (ctypes.c_longlong * (3 * PLAN_LEN))(*plans)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, launch)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), plans,
            B, S, T, H, K, hd, int(causal), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES += 1
    return out
