"""Multi-application bandwidth sharing & application-level fairness (§VII),
on tensors.

TCP's flow-level fairness hands an app with many flows a proportionally large
slice of each bottleneck. The paper's `App-Fair` point solution:

  * track per-app throughput with the EWMA of eq. (5):
        μ_i(t+Δt) = α μ_i(t) + (1−α) μ_i(Δt)
  * cluster apps by μ into priority groups (lowest throughput → highest
    priority), at most ``m`` groups (m = 8 queues in the paper's switches);
  * strict-priority allocation: fill group by group with max-min inside a
    group; displacement between groups every interval avoids starvation;
  * measured with the Jain fairness index (paper: 0.98–0.99 vs TCP 0.84).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tcp import maxmin_fused, maxmin_rates
from repro_torch.device import resolve_device

_EPS = 1e-9


def ewma_throughput(mu_t, mu_dt, alpha: float):
    """Eq. (5)."""
    return alpha * mu_t + (1.0 - alpha) * mu_dt


def jain_index(x: torch.Tensor) -> torch.Tensor:
    """Jain, Chiu & Hawe fairness index: (Σx)² / (n Σx²) ∈ (0, 1]."""
    n = x.shape[0]
    return x.sum() ** 2 / torch.clamp_min(n * (x * x).sum(), _EPS)


def group_by_throughput(mu: torch.Tensor, n_groups: int) -> torch.Tensor:
    """'Simple clustering': rank apps by EWMA throughput and split into
    ``n_groups`` quantile buckets. Returns priority per app — 0 is HIGHEST
    (lowest achieved throughput), as in the paper. Ties rank by app index
    (both sorts are stable)."""
    n_apps = mu.shape[0]
    rank = torch.argsort(torch.argsort(mu, stable=True), stable=True)
    per = -(-n_apps // n_groups)                 # ceil
    return torch.clamp_max(rank // per, n_groups - 1).to(torch.int64)


def strict_priority_alloc(
    R: torch.Tensor,            # [F, L]
    capacity: torch.Tensor,     # [L]
    app_of_flow: torch.Tensor,  # [F] int app ids
    app_priority: torch.Tensor, # [A] 0 = highest
    n_groups: int = 8,
) -> torch.Tensor:
    """Multi-level strict-priority scheduler: per priority level (high→low)
    run max-min among that level's flows on the residual capacity.

    Uses the fused fixed-trip solver (`maxmin_fused`) with an
    always-slack demand cap (no single flow can exceed the total network
    capacity): a level's flows that cross no congested link get the slack
    cap, which the caller clamps by its link mask."""
    prio_of_flow = app_priority[app_of_flow]
    x = torch.zeros((R.shape[0],), dtype=R.dtype, device=R.device)
    on_net = R.sum(1) > 0
    # any on-net flow's rate is bounded by the largest link it crosses, so
    # the total capacity is a demand cap that never binds below saturation
    cap_bound = capacity.sum() + 1.0
    for p in range(n_groups):
        used = (R * x[:, None]).sum(0)
        resid = torch.clamp_min(capacity - used, 0.0)
        sel = prio_of_flow == p
        demand = torch.where(sel & on_net, cap_bound, 0.0)
        rates = maxmin_fused(R, resid, demand)
        x = x + rates * sel.to(R.dtype)
    return x


class AppFairState(NamedTuple):
    total: torch.Tensor     # [A] cumulative throughput per app
    n: torch.Tensor         # [] intervals observed
    priority: torch.Tensor  # [A]


class AppFairScheduler:
    """§VII App-Fair: blend the cumulative average μ(t) ('achieved average
    throughput up to time t') with the recent interval μ(Δt) via eq. (5),
    regroup every interval (displacement), allocate with strict priority.
    The state lives on ``device``: the CUDA card unless the caller asks
    for another device (raises without a card)."""

    def __init__(self, n_apps: int, alpha: float = 0.5, n_groups: int = 8,
                 device: "str | torch.device | None" = None):
        self.alpha = float(alpha)
        self.n_groups = int(n_groups)
        self.n_apps = int(n_apps)
        self.device = resolve_device(device)

    def init(self) -> AppFairState:
        return AppFairState(
            total=torch.zeros((self.n_apps,), dtype=torch.float32,
                              device=self.device),
            n=torch.zeros((), dtype=torch.float32, device=self.device),
            priority=torch.zeros((self.n_apps,), dtype=torch.int64,
                                 device=self.device),
        )

    def step(
        self,
        state: AppFairState,
        mu_interval: torch.Tensor,   # [A] throughput achieved this Δt
        R: torch.Tensor,
        capacity: torch.Tensor,
        app_of_flow: torch.Tensor,
    ) -> tuple[AppFairState, torch.Tensor]:
        total = state.total + mu_interval
        n = state.n + 1.0
        mu_hist = total / torch.clamp_min(n, 1.0)  # μ(t): running average
        mu = ewma_throughput(mu_hist, mu_interval, self.alpha)
        # displacement: regrouping *every interval* moves apps between groups,
        # guaranteeing no app is starved indefinitely (paper §VII).
        prio = group_by_throughput(mu, self.n_groups)
        x = strict_priority_alloc(
            R, capacity, app_of_flow, prio, n_groups=self.n_groups
        )
        return AppFairState(total=total, n=n, priority=prio), x


def tcp_app_throughput(R, capacity, app_of_flow, n_apps: int):
    """Baseline for Fig. 13: per-app aggregate of flow-level max-min rates.
    The per-app sum is a reduction over a one-hot [F, A] product, not an
    atomic scatter, so the card gives the same bits on every run."""
    x = maxmin_rates(R, capacity)
    x = torch.where(torch.isfinite(x), x, 0.0)
    apps = torch.arange(n_apps, device=x.device)
    onehot = (app_of_flow[:, None] == apps[None, :]).to(x.dtype)
    return (x[:, None] * onehot).sum(0)
