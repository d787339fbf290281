"""Plain PyTorch versions of the batched per-link allocator solve.

Link semantics (paper Alg. 1):
  kind 0 (uplink, eq. 3):  x_f = C · w_f / Σ w   (proportional-to-demand)
  kind 1 (downlink, eq. 4): water-filling x_f = max(0, (θ ρ_f − L_f)/dt)
                            with θ s.t. Σ x_f = C  (equal drain times)

* :func:`waterfill_plain` — the CUDA kernel's own algorithm on tensors:
  ``N_BISECT`` bisection rounds on θ, float32, the same constants and
  branches. The wrapper (``ops.py``) runs it for CPU tensors; on the card
  it is the yardstick the kernel is held to.
* :func:`waterfill_ref` — the exact sort-based oracle: the allocator's
  ``solve_uplink``/``solve_downlink`` over the link batch.
"""
from __future__ import annotations

import torch

N_BISECT = 48
_EPS = 1e-9


def waterfill_plain(weights, backlog, rho, mask, capacity, kind,
                    dt: float = 1.0) -> torch.Tensor:
    """weights/backlog/rho: [F] rows shared by every link, or dense [L, F];
    mask: [L, F]; capacity: [L]; kind: [L] (1 = downlink, else uplink).
    Returns [L, F]."""
    w, L_r = weights, backlog
    r = torch.clamp_min(rho, _EPS)
    m = mask
    cap = capacity[:, None]

    # ---- pass 1: per-link reductions ----------------------------------
    w_pos = torch.clamp_min(w, 0.0)
    s_w = (w_pos * m).sum(1, keepdim=True)
    s_m = m.sum(1, keepdim=True)
    s_rho = (r * m).sum(1, keepdim=True)
    th = torch.where(m > 0, L_r / r, 0.0)                # activation points
    mx = torch.clamp_min(th.amax(1, keepdim=True), 0.0)

    # ---- eq. (4): drain-time equalization via bisection (downlinks) ---
    lo = torch.zeros_like(cap)
    hi = mx + cap * dt / torch.clamp_min(s_rho, _EPS) + 1.0
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        alloc = (torch.clamp_min(mid * r - L_r, 0.0) * m).sum(
            1, keepdim=True) / dt
        too_much = alloc > cap
        lo, hi = torch.where(too_much, lo, mid), torch.where(too_much, mid, hi)
    theta = 0.5 * (lo + hi)

    # downlink mass at θ: renormalize residual bisection error to capacity
    s_dn = (torch.clamp_min(theta * r - L_r, 0.0) * m).sum(
        1, keepdim=True) / dt
    dn_scale = torch.where(s_dn > _EPS, cap / s_dn, 1.0)

    # ---- eq. (3): zero demand falls back to equal split ---------------
    up_fb = s_w <= _EPS
    up_den = torch.where(up_fb, torch.clamp_min(s_m, 1.0), s_w)
    wm = torch.where(up_fb, m, w_pos * m)
    x_up = cap * wm / up_den
    x_dn = torch.clamp_min(theta * r - L_r, 0.0) * m / dt * dn_scale
    return torch.where(kind[:, None] == 1, x_dn, x_up)


def waterfill_ref(weights, backlog, rho, mask, capacity, kind,
                  dt: float) -> torch.Tensor:
    """weights/backlog/rho/mask: [L, F]; capacity/kind: [L]. -> rates [L, F]."""
    from repro_torch.core.allocator import solve_downlink, solve_uplink

    up = solve_uplink(weights, mask, capacity)
    down = solve_downlink(backlog, rho, mask, capacity, dt)
    return torch.where(kind[:, None] == 1, down, up)
