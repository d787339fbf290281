"""repro_torch: the PyTorch/CUDA port of ``repro`` (the JAX package, kept
beside it as the reference). Same module layout and public names; the
appaware allocator's per-link solve runs through a hand-written CUDA
waterfill kernel for Hopper (``repro_torch.kernels.waterfill``).

Importing the package sets the float32 precision flags (see
:mod:`repro_torch.device`)."""
from repro_torch.device import DEFAULT_DEVICE, resolve_device  # noqa: F401

__version__ = "0.1.0"
