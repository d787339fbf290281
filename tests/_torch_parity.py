"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``):
the same numpy inputs go to a ``repro`` (JAX) function and to its
``repro_torch`` counterpart, and the results are compared at a stated
tolerance. The port always runs on the CPU here."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flowstate import FlowState
from repro_torch.streams.simulator import DATA_FIELDS, sim_from_numpy

CPU = "cpu"


def t32(a) -> torch.Tensor:
    """A float32 CPU tensor from an array-like (numpy or JAX)."""
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def tint(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a).astype(np.int64))


def port_sim(jsim):
    """The port's CompiledSim holding exactly a JAX CompiledSim's state."""
    return sim_from_numpy({f: np.asarray(getattr(jsim, f))
                           for f in DATA_FIELDS},
                          tuples_per_mb=jsim.tuples_per_mb,
                          n_apps=jsim.n_apps, device=CPU)


def port_state(jstate) -> FlowState:
    return FlowState(*[t32(a) for a in jstate])


def assert_close(got, want, rtol: float, atol: float) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
