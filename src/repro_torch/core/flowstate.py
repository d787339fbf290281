"""Flow-state model (paper Fig. 5), on tensors.

Per flow ``f`` and measurement interval ``(t, t+dt)`` the profiler reports the
5-metric tuple

    ⟨ L_f^s(t),  L_f^r(t),  V_f(t,t+dt),  L_f^s(t+dt),  L_f^r(t+dt) ⟩

where ``L^s`` is the *sender* queue backlog (MB of tuples awaiting transfer —
fork side), ``L^r`` the *receiver* queue backlog (MB received but not yet
processed — join side) and ``V`` the bytes actually transferred. The state is
non-clairvoyant: it needs no knowledge of the (unbounded) flow volume.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class FlowState:
    """Tensors of shape [F] (MB / MB units). ``dt`` in seconds."""

    ls_t: torch.Tensor    # L_f^s(t)       sender backlog at interval start
    lr_t: torch.Tensor    # L_f^r(t)       receiver backlog at interval start
    v: torch.Tensor       # V_f(t, t+dt)   bytes transferred in the interval
    ls_t1: torch.Tensor   # L_f^s(t+dt)    sender backlog at interval end
    lr_t1: torch.Tensor   # L_f^r(t+dt)    receiver backlog at interval end

    # ---- derived quantities used by Alg. 1 ---------------------------
    def uplink_demand(self) -> torch.Tensor:
        """Predicted next-interval transfer demand w_f (numerator of eq. 3).

        Data generated in (t, t+dt) is V + (L^s(t+dt) − L^s(t)); if the
        generation rate holds, V + 2·L^s(t+dt) − L^s(t) must be moved in the
        next interval (paper §IV-B derivation).
        """
        return torch.clamp_min(self.v + 2.0 * self.ls_t1 - self.ls_t, 0.0)

    def drain_rate(self, dt: float, eps: float = 1e-9) -> torch.Tensor:
        """Receiver processing rate ρ_f (denominator of eq. 4):
        data processed in the interval = V − (L^r(t+dt) − L^r(t)), per second.
        """
        return torch.clamp_min((self.v - self.lr_t1 + self.lr_t) / dt, eps)

    def any_backlog(self) -> torch.Tensor:
        """Alg. 1 line 31 loop condition: some flow still has backlog."""
        return torch.any((self.ls_t1 > 0.0) | (self.lr_t1 > 0.0))


def zeros(n_flows: int,
          device: "str | torch.device | None" = None) -> FlowState:
    z = torch.zeros((n_flows,), dtype=torch.float32,
                    device=resolve_device(device))
    return FlowState(z, z, z, z, z)


def flowstate_from_numpy(fields: Sequence[np.ndarray],
                         device: "str | torch.device") -> FlowState:
    """A FlowState from five [F] arrays in field order (``ls_t, lr_t, v,
    ls_t1, lr_t1``) — e.g. ``[np.asarray(a) for a in jax_state]`` — as
    float32 tensors on ``device``."""
    return FlowState(*[torch.as_tensor(np.asarray(a, np.float32),
                                       device=device) for a in fields])
