"""App-aware online bandwidth allocation (paper §IV, Algorithm 1), on tensors.

Vectorized over links. Every ``dt`` the allocator maps the observed
:class:`repro_torch.core.flowstate.FlowState` to a rate vector ``x`` [F]:

  1. per bottleneck *uplink* (Fork stage) solve eq. (3)
         min_x max_f w_f / x_f        s.t. Σ_f x_f = C_u,  x ≥ 0
     with w_f = V_f + 2 L_f^s(t+dt) − L_f^s(t). The min-max is attained when
     all transfer times w_f/x_f are equal → closed form x_f = C_u w_f / Σ w.

  2. per bottleneck *downlink* (Join stage) solve eq. (4)
         min_x max_f (L_f^r(t+dt) + x_f dt) / ρ_f     s.t. Σ_f x_f = C_d
     with ρ_f the receiver drain rate. Equalizing the queue-drain time θ
     gives the water-filling solution x_f = max(0, (θ ρ_f − L_f^r)/dt) with
     θ fixed by Σ_f x_f(θ) = C_d. Flows whose join partner is starved
     (small L^r, healthy ρ) get MORE bandwidth — the paper's stall-avoidance.

  3. x_f = min(x_f^u, x_f^d)  (Alg. 1 line 22);

  4. congested *internal* links scale their flows down proportionally and a
     flow takes the min across its links (lines 24–29);

  5. a backfill pass re-distributes leftover capacity proportionally to the
     previous pass's shares (§VI-C, link-utilization experiment).

The per-link solves run either as the exact sort-based batched solve
(``solver="sort"``) or through the hand-written CUDA waterfill kernel
(``solver="waterfill"``, :mod:`repro_torch.kernels.waterfill`) — at
datacenter scale (10⁴ links × 10³ flows each interval) this is the
allocator's compute hot-spot. Every sort is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.flowstate import FlowState
from repro_torch.device import resolve_device
from repro_torch.net.topology import LinkKind

_EPS = 1e-9
_INF = float("inf")

# Auto-chunk threshold for the sort solver's link axis: above 2x this many
# links, `allocate(block_links=None)` switches to `_per_link_rates_chunked`
# in blocks of this size (the [L, F] solver intermediates stay bounded at
# datacenter scale). Simulator topologies (L <= ~32) stay single-pass.
ALLOC_BLOCK_LINKS = 256


def _last(capacity, like: torch.Tensor) -> torch.Tensor:
    """Capacity as a tensor with a trailing unit axis ([..., 1])."""
    return torch.as_tensor(capacity, dtype=like.dtype,
                           device=like.device)[..., None]


def solve_uplink(weights: torch.Tensor, mask: torch.Tensor,
                 capacity) -> torch.Tensor:
    """Eq. (3): proportional-to-demand allocation on one uplink.

    weights: [..., F] demand w_f (≥ 0); mask: [..., F] flows on this link;
    capacity: C_u (scalar or [...]). Returns x [..., F] with x·mask summing
    to C_u (if any flow is masked). Leading axes batch over links.
    """
    cap = _last(capacity, weights)
    w = torch.clamp_min(weights, 0.0) * mask
    total = w.sum(-1, keepdim=True)
    n = mask.sum(-1, keepdim=True)
    # all-zero demand: fall back to equal split (still work-conserving)
    w = torch.where(total > _EPS, w, mask)
    total = torch.where(total > _EPS, total, torch.clamp_min(n, 1.0))
    return cap * w / total


def solve_downlink(backlog: torch.Tensor, rho: torch.Tensor,
                   mask: torch.Tensor, capacity, dt: float) -> torch.Tensor:
    """Eq. (4): equalize queue-drain times via exact water-filling (one sort
    per link).

    backlog: [..., F] L_f^r(t+dt); rho: [..., F] drain rates (>0); mask:
    [..., F]; capacity: C_d (scalar or [...]). Leading axes batch over links.

    θ solves Σ_f max(0, (θ ρ_f − L_f)/dt) = C. x_f(θ) is piecewise-linear,
    nondecreasing; flows activate at θ_f = L_f/ρ_f. Sorting by θ_f and
    scanning prefixes yields the unique consistent active set.
    """
    cap = _last(capacity, backlog)
    F = backlog.shape[-1]
    on = mask > 0
    rho = torch.clamp_min(rho, _EPS)
    theta_act = torch.where(on, backlog / rho, _INF)     # activation points
    order = torch.argsort(theta_act, dim=-1, stable=True)
    th_s = theta_act.gather(-1, order)
    rho_s = torch.where(on, rho, 0.0).gather(-1, order)
    L_s = torch.where(on, backlog, 0.0).gather(-1, order)
    cum_rho = torch.cumsum(rho_s, -1)
    cum_L = torch.cumsum(L_s, -1)
    # candidate θ for prefix of size k (index k-1)
    theta_k = (cap * dt + cum_L) / torch.clamp_min(cum_rho, _EPS)
    next_th = torch.cat([th_s[..., 1:], torch.full_like(th_s[..., :1], _INF)],
                        -1)
    ks = torch.arange(F, device=backlog.device)
    n_active = mask.sum(-1, keepdim=True).to(torch.int64)
    valid = ((theta_k >= th_s) & (theta_k <= next_th) & (ks < n_active)
             & torch.isfinite(th_s))
    # the unique valid prefix (fall back to the full active set)
    k_star = torch.where(valid.any(-1, keepdim=True),
                         valid.to(torch.int32).argmax(-1, keepdim=True),
                         torch.clamp_min(n_active - 1, 0))
    theta = theta_k.gather(-1, k_star)
    x = torch.clamp_min(theta * rho - backlog, 0.0) / dt * mask
    # numerical cleanup: renormalize to the capacity exactly
    s = x.sum(-1, keepdim=True)
    return torch.where(s > _EPS, x * (cap / s), x)


class LinkProgram(NamedTuple):
    """Static routing context for the allocator (from a Topology)."""

    R: torch.Tensor          # [F, L] binary routing matrix
    capacity: torch.Tensor   # [L]
    kind: torch.Tensor       # [L] LinkKind values


def _per_link_rates_vmap(program: LinkProgram, state: FlowState, dt: float):
    """Reference path: the per-link solvers across ALL links (one sort per
    link, batched over the link axis); select by link kind. Kept as the
    parity oracle for the fused solve below."""
    mask = (program.R.T > 0).to(torch.float32)           # [L, F]
    L = mask.shape[0]
    w_up = state.uplink_demand().expand(L, -1)
    rho = state.drain_rate(dt).expand(L, -1)
    L_r = state.lr_t1.expand(L, -1)
    x_u = solve_uplink(w_up, mask, program.capacity)
    x_d = solve_downlink(L_r, rho, mask, program.capacity, dt)
    return torch.where((program.kind == int(LinkKind.DOWNLINK))[:, None],
                       x_d, x_u)


def _flow_sort_ctx(state: FlowState, dt: float) -> dict:
    """Flow-axis preprocessing shared by every link of a solve: the
    per-flow inputs (demand w, backlog L^r, drain ρ) are the same for all
    links — only the on-link mask differs — so the downlink water-filling
    activation order ``θ_f = L_f/ρ_f`` is ONE global permutation, computed
    once (one argsort total, vs one per link in the reference)."""
    rho = torch.clamp_min(state.drain_rate(dt), _EPS)
    L_r = state.lr_t1
    theta_act = L_r / rho
    order = torch.argsort(theta_act, stable=True)
    return {
        "w_pos": torch.clamp_min(state.uplink_demand(), 0.0),
        "rho": rho, "L_r": L_r, "order": order,
        "th_s": theta_act[order], "rho_s": rho[order], "L_s": L_r[order],
    }


def _solve_link_block(mask, cap, kind, ctx, dt: float):
    """Fused eqs. (3)/(4) for one [B_l, F] block of links against the
    shared flow context — the single source of the solver math for both
    the full-axis and the chunked paths.

    Per link, the prefix sums over its masked flows in global θ-order
    equal the prefix sums over its own sorted active set, so masked
    batched cumsums replace per-link sorts; the unique consistent active
    prefix (and the uplink proportional closed form) drop out of one
    [B_l, F] pass."""
    capc = cap[:, None]                                  # [B_l, 1]
    F = mask.shape[1]

    # ---- eq. (3): proportional-to-demand ------------------------------
    wm = ctx["w_pos"][None, :] * mask
    tot = wm.sum(1, keepdim=True)
    n = mask.sum(1, keepdim=True)
    wm = torch.where(tot > _EPS, wm, mask)      # zero demand: equal split
    tot = torch.where(tot > _EPS, tot, torch.clamp_min(n, 1.0))
    x_up = capc * wm / tot

    # ---- eq. (4): batched prefix scans in global θ-order ---------------
    m_s = mask.index_select(1, ctx["order"])             # [B_l, F]
    cum_rho = torch.cumsum(ctx["rho_s"][None, :] * m_s, 1)
    cum_L = torch.cumsum(ctx["L_s"][None, :] * m_s, 1)
    theta_k = (capc * dt + cum_L) / torch.clamp_min(cum_rho, _EPS)
    # active-set selection à la weighted simplex projection (Duchi et al.):
    # the consistent prefix is the LARGEST masked k whose candidate level
    # still covers its own activation point, θ_k ≥ θ̂_(k)
    ks = torch.arange(F, device=mask.device)[None, :]
    ok = (m_s > 0) & (theta_k >= ctx["th_s"][None, :])
    k_star = torch.where(ok, ks, 0).amax(1, keepdim=True)   # [B_l, 1]
    theta = theta_k.gather(1, k_star)
    x_dn = torch.clamp_min(theta * ctx["rho"][None, :]
                           - ctx["L_r"][None, :], 0.0) / dt * mask
    s = x_dn.sum(1, keepdim=True)
    x_dn = torch.where(s > _EPS, x_dn * (capc / s), x_dn)

    is_down = (kind == int(LinkKind.DOWNLINK))[:, None]
    return torch.where(is_down, x_dn, x_up)


def _per_link_rates(program: LinkProgram, state: FlowState, dt: float):
    """Fused batched [L, F] solve of eqs. (3) and (4) for every link at
    once: one global argsort (:func:`_flow_sort_ctx`) + one
    :func:`_solve_link_block` pass over the full link axis."""
    mask = (program.R.T > 0).to(torch.float32)          # [L, F]
    return _solve_link_block(mask, program.capacity, program.kind,
                             _flow_sort_ctx(state, dt), dt)


def _per_link_rates_chunked(program: LinkProgram, state: FlowState,
                            dt: float, block_links: int):
    """Chunked-links variant of the fused solve: the same
    :func:`_solve_link_block` math over ``block_links``-row slices of the
    link axis, so the [L, F] intermediates (masked cumsums, candidate
    levels, prefix selections) are capped at [block_links, F]. Only the
    [L, F] *output* (and the routing mask) stay full-size. The flow context
    (one global argsort) is shared across chunks."""
    ctx = _flow_sort_ctx(state, dt)
    maskT = (program.R.T > 0).to(torch.float32)         # [L, F]
    blk = max(int(block_links), 1)
    rows = [
        _solve_link_block(maskT[i:i + blk], program.capacity[i:i + blk],
                          program.kind[i:i + blk], ctx, dt)
        for i in range(0, maskT.shape[0], blk)
    ]
    return torch.cat(rows, 0)


def _per_link_rates_waterfill(program: LinkProgram, state: FlowState,
                              dt: float):
    """Same [L, F] solve through the Hopper waterfill kernel
    (:mod:`repro_torch.kernels.waterfill`) — bisection on θ instead of the
    sort; the counterpart of the JAX package's Pallas path.

    The per-flow state ships as [F] vectors (``waterfill_flows``); only the
    on-link mask is [L, F], so no dense per-link broadcasts of w/backlog/ρ
    are materialized. INTERNAL links are fed as uplinks; ``allocate`` never
    reads their rows (it handles internal links by proportional
    scale-down), so only the UPLINK/DOWNLINK selection has to agree with
    the exact solvers.
    """
    from repro_torch.kernels.waterfill.ops import waterfill_flows

    mask = (program.R.T > 0).to(torch.float32).contiguous()   # [L, F]
    kind01 = (program.kind == int(LinkKind.DOWNLINK)).to(torch.int32)
    return waterfill_flows(
        state.uplink_demand().contiguous(), state.lr_t1.contiguous(),
        state.drain_rate(dt).contiguous(), mask,
        program.capacity.to(torch.float32).contiguous(), kind01, dt=dt)


def backfill(x: torch.Tensor, program: LinkProgram, iters: int = 8,
             damping: float = 0.9) -> torch.Tensor:
    """§VI-C backfill: hand leftover link capacity to flows proportionally to
    their share from the previous pass, never violating any link.

    A flow's headroom min over its links of ``x_f·resid_l/load_l`` factors as
    ``x_f · min_l(resid_l/load_l)`` (x ≥ 0), so each iteration reduces to one
    [L] residual-ratio vector and one masked min.
    """
    R, cap = program.R, program.capacity
    on_link = R > 0
    on_net = R.sum(1) > 0  # flows that traverse ≥1 link
    for _ in range(iters):
        load = x @ R                                   # [L]
        ratio = torch.clamp_min(cap - load, 0.0) / torch.clamp_min(load, _EPS)
        r_min = torch.where(on_link, ratio[None, :], _INF).amin(1)
        inc = torch.where(on_net & torch.isfinite(r_min), x * r_min, 0.0)
        x = x + damping * inc
    return x


def allocate(
    program: LinkProgram,
    state: FlowState,
    dt: float = 1.0,
    backfill_iters: int = 8,
    solver: str = "sort",
    block_links: int | None = None,
) -> torch.Tensor:
    """Algorithm 1, one interval: FlowState -> rate vector x [F] (MB/s).

    Runs on the device the program's tensors live on.

    solver: "sort" — exact sort-based per-link solves;
            "waterfill" — the batched bisection waterfill kernel (CUDA on
            the card; its plain PyTorch version for CPU tensors). Both
            satisfy the same KKT conditions.
    block_links: with the "sort" solver, process links in chunks of this
            size — exact same results, bounded working set at datacenter
            link counts (ignored by "waterfill"). ``None`` (the default)
            dispatches on the link count: single-pass below
            ``2 * ALLOC_BLOCK_LINKS`` links, chunks of ``ALLOC_BLOCK_LINKS``
            above it. Pass ``0`` to force the single-pass form at any size.
    """
    if solver == "sort":
        if block_links is None and program.R.shape[1] > 2 * ALLOC_BLOCK_LINKS:
            block_links = ALLOC_BLOCK_LINKS
        if block_links:
            per_link = _per_link_rates_chunked(program, state, dt,
                                               block_links)   # [L, F]
        else:
            per_link = _per_link_rates(program, state, dt)     # [L, F]
    elif solver == "waterfill":
        per_link = _per_link_rates_waterfill(program, state, dt)  # [L, F]
    else:
        raise ValueError(f"unknown solver {solver!r}")
    kind = program.kind
    on_link_T = program.R.T > 0

    # Alg. 1 line 22 collapsed: min(x^u, x^d) over a flow's links is the min
    # of per_link over its non-internal links (each row already carries the
    # kind-appropriate solve), so one masked reduction replaces the two
    # per-kind passes.
    sel = (kind != int(LinkKind.INTERNAL))[:, None] & on_link_T
    x = torch.where(sel, per_link, _INF).amin(0)
    x = torch.where(torch.isfinite(x), x, 0.0)   # flows with no links: caller

    # Internal links: proportional scale-down, min across links (lines 24-29)
    load = x @ program.R                                       # [L]
    is_int = kind == int(LinkKind.INTERNAL)
    scale_l = torch.where(
        is_int & (load > program.capacity),
        program.capacity / torch.clamp_min(load, _EPS),
        1.0,
    )
    per_flow_scale = torch.where(
        (program.R > 0) & is_int[None, :], scale_l[None, :], 1.0
    ).amin(1)
    x = x * per_flow_scale

    if backfill_iters:
        x = backfill(x, program, iters=backfill_iters)
    return x


class OnlineAllocator:
    """Alg. 1 driver: wraps a static LinkProgram; call once per Δt."""

    def __init__(self, R, capacity, kind, dt: float = 1.0,
                 backfill_iters: int = 8, solver: str = "sort",
                 device: "str | torch.device | None" = None):
        dev = resolve_device(device)
        self.program = LinkProgram(
            R=torch.as_tensor(R, dtype=torch.float32, device=dev),
            capacity=torch.as_tensor(capacity, dtype=torch.float32,
                                     device=dev),
            kind=torch.as_tensor(kind, dtype=torch.int64, device=dev),
        )
        self.dt = float(dt)
        self.backfill_iters = int(backfill_iters)
        self.solver = solver

    def __call__(self, state: FlowState) -> torch.Tensor:
        return allocate(self.program, state, dt=self.dt,
                        backfill_iters=self.backfill_iters, solver=self.solver)

    @classmethod
    def from_topology(cls, topo, flows, **kw) -> "OnlineAllocator":
        return cls(
            topo.routing_matrix(flows), topo.capacities, topo.link_kinds, **kw
        )
