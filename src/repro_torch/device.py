"""Device selection and numeric settings for the PyTorch port.

Entry points (``compile_sim``, ``simulate``, ``OnlineAllocator``,
``Scenario.compile``) take a ``device`` argument that defaults to the CUDA
card. There is no silent CPU fallback: without a card the caller must ask
for ``device="cpu"`` explicitly (the tests do), otherwise
:func:`resolve_device` raises.

Precision is float32 throughout, and every float32 product runs in full
fp32: the max-min solver's rank-prefix GEMM (``core/tcp.py``) is exact only
when its {0, 1} operands and f32 demands are not rounded to TF32, and the
link loads ``x @ R`` feed the capacity checks.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA card. Raises when a CUDA device is asked for (or defaulted to) and
    none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
