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

The source holds two kernels, and :func:`kernel_for` picks one by dtype:
both run on the tensor cores with their tiles brought in by TMA, bfloat16
as bf16 products, float32 as split-TF32 products (three tf32 products per
float32 product, near float32; one tf32 product would round float32 inputs
past the tolerance). Both read q, k and v through tensor maps whose plan
(:func:`tma_plan`) the wrapper computes and checks (:func:`check_tma_operand`)
before the library encodes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import attention_plain

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
    dtype. Causal means key j is seen by query i iff j <= i."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        o = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal)
        return o.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
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
