"""Wrapper for the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` takes the model's [B,S,H,hd] layout, like the JAX
package's ``kernels/flash_attention/ops.py::flash_attention``; the CUDA
kernel reads that layout in place, so nothing is transposed on the card.
Tensors on the CPU go through the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_plain`); CUDA
tensors launch the kernel on the current stream, without synchronising, or
raise. The JAX kernel's ``block_q``/``block_k`` knobs and its
``S % block_q == 0`` requirement have no counterpart: the CUDA kernel uses
fixed 64-row tiles and masks its own ragged edge.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import attention_plain

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)     # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535                # B·H rides on gridDim.y

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
        lib.flash_attention_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                               i, i, i, vp]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B·H = {B * H} exceeds {MAX_GRID_Y}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, int(q.dtype == torch.bfloat16), int(causal),
            stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES += 1
    return out
