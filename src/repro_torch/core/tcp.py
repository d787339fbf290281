"""TCP baseline: per-flow max-min fair *rate* allocation (paper §VI-A.3), on
tensors.

The paper's baseline is the default transport of Storm/Heron/Flink — TCP
congestion control, which (idealized) converges to max-min fair rates among
flows sharing bottleneck links.

* :func:`maxmin_fused` — the **hot-path solver**: a fused, fixed-trip-count
  progressive fill with per-flow demand caps folded directly into each
  round. Per round each link's exact saturation water level
  (``Σ_f min(d_f, θ) = resid_l``) drops out of rank-prefix sums in stable
  demand order, and every *locally minimal* link (no cheaper neighbor in
  the link-conflict graph) freezes, so the trip count tracks the depth of
  the strictly-increasing bottleneck-level chain, not the link count.

  Two *forms* of the per-round water-level evaluation exist behind a
  shape-dependent crossover (:data:`MAXMIN_CROSSOVER_F`): the **GEMM form**
  keeps the rank prefixes as one ``[F+1, F] @ [F, 2L]`` matmul against the
  order-only operand ``[W; 1]`` (demand folded into the *right* operand —
  exact in {0, 1} arithmetic, which needs full fp32 products: see
  :mod:`repro_torch.device`); the **sorted form** replaces the O(F²·L) GEMM
  with one stable argsort + two batched cumsums (O(F·L)). The GEMM form
  chunks its candidate rows in ``block_flows`` blocks above
  ``2 * MAXMIN_BLOCK_FLOWS`` flows.

* :func:`maxmin_fused_step` / :func:`maxmin_order_init` — the **order-
  cached** variant for per-tick re-solves inside the simulator's tick loop:
  the carry holds ``(valid, perm, A1)`` and an O(F) monotonicity check
  against the carried permutation decides whether the carried operand is
  still the exact stable order. Both arms are computed and selected with
  ``torch.where`` (a device-side decision: the host never waits on it),
  and ``rebuilt`` reports the decision for the rebuild count.

The while-loop oracles of the JAX package (``maxmin_rates``,
``demand_limited_maxmin``) are not ported; the tests hold this module
against them and against ``repro.core.tcp.demand_limited_maxmin_np``.
"""
from __future__ import annotations

import torch

_EPS = 1e-9
_INF = float("inf")

# Trip count of the hot-path fused fill: rounds + 1 (the closing sweep
# resolves one further level) must cover the depth of the strictly-
# increasing bottleneck-level chain in the link-conflict graph — ≤ 3 on the
# seed-corpus routing structure, which 2 + sweep covers exactly. Deeper
# instances stay link-feasible (the sweep assigns min(demand, bottleneck
# level), which never oversubscribes a link). Pass ``rounds=None`` for the
# provably exact shape bound min(F, L) + 1.
FILL_ROUNDS = 2

_RTOL = 1e-6   # tie tolerance for water-level comparisons (relative)
_ATOL = 1e-6   # ... and absolute, for levels near zero

# Crossover between the two water-level forms, by flow count: below it the
# rank-prefix GEMM form, at or above it the argsort+cumsum form. The value
# is the reference's (calibrated there on CPU); keeping it keeps the two
# packages on the same form for every shape, so their results compare
# like with like.
MAXMIN_CROSSOVER_F = 256

# GEMM-form candidate rows are processed in chunks of this size once F
# outgrows ``2 * MAXMIN_BLOCK_FLOWS``.
MAXMIN_BLOCK_FLOWS = 64


# --------------------------------------------------------------------------
# fused fixed-trip solver (the policy hot path)
# --------------------------------------------------------------------------
def _order_matrix(d: torch.Tensor):
    """Demand rank order as a 0/1 matrix plus the matching stable-sort
    permutation: ``W[f, g] = [(d_g, g) ≤lex (d_f, f)]`` (ties broken by
    flow index — exactly ``argsort(d, stable=True)``'s order). ``rank[f]``
    is f's position in the stable order, so scattering ``f → rank[f]``
    inverts it into the permutation."""
    F = d.shape[0]
    idx = torch.arange(F, device=d.device)
    W = ((d[None, :] < d[:, None])
         | ((d[None, :] == d[:, None])
            & (idx[None, :] <= idx[:, None]))).to(torch.float32)
    rank = W.sum(1).to(torch.int64) - 1                          # [F]
    perm = torch.empty_like(idx).scatter_(0, rank, idx)
    return W, perm


def _order_operand(d: torch.Tensor):
    """The order-only left GEMM operand ``A1 = [W; 1]`` ([F+1, F]) and the
    stable permutation it encodes. A1 is a pure function of the demand
    *order*, so a kept operand equals a rebuilt one whenever the order
    check passes."""
    F = d.shape[0]
    W, perm = _order_matrix(d)
    A1 = torch.cat([W, torch.ones((1, F), dtype=torch.float32,
                                  device=d.device)], 0)
    return A1, perm


def _theta_from_parts(m_or_ms, n_l, sum_d, cum_n, cum_d, resid):
    """Shared tail of every water-level form: candidate chord roots →
    max-selection → saturability gate (see :func:`_link_levels`)."""
    denom = n_l[None, :] - cum_n
    theta_k = (resid[None, :] - cum_d) / torch.clamp_min(denom, 0.5)
    cand = torch.where((m_or_ms > 0) & (denom > 0.5), theta_k, -_INF)
    theta = torch.maximum(cand.amax(0), resid / torch.clamp_min(n_l, 1.0))
    saturable = (n_l > 0) & (sum_d > resid * (1.0 + _RTOL) + _ATOL)
    return torch.where(saturable, theta, _INF)


def _link_levels(A1, d, m, resid):
    """Exact demand-capped saturation level θ_l per link: the unique θ with
    ``Σ_{unfrozen f on l} min(d_f, θ) = resid_l`` (+inf if the link cannot
    saturate: no unfrozen flows, or their total demand fits in resid).

    GEMM form: ``P = A1 @ [m | d·m]`` ([F+1, 2L]) yields every per-link
    quantity the prefix rule needs (rank prefixes of counts and demands,
    plus their totals) in one matmul per round in *original* flow order.
    The candidate level for the prefix capped at flow f is the root of the
    chord ``Σ_{d_g ≤ d_f} d_g + (#rest)·θ``, which upper-bounds
    ``Σ min(d, θ)`` pointwise, so θ is the MAX over candidates (incl. the
    nothing-capped chord ``resid/n``). ``m`` [F, L] is the routing mask
    restricted to unfrozen flows. Returns θ [L].
    """
    F, L = m.shape
    P = A1 @ torch.cat([m, d[:, None] * m], 1)               # [F+1, 2L]
    return _theta_from_parts(m, P[F, :L], P[F, L:], P[:F, :L], P[:F, L:],
                             resid)


def _link_levels_blocked(A1, d, m, resid, block_flows: int):
    """GEMM form with the candidate rows processed in ``block_flows``
    chunks: the [F, 2L] prefix / [F, L] candidate intermediates are capped
    at [block, ·] while only the rank operand and routing mask stay
    full-size. The per-chunk maxima combine by ``max`` — exact and
    associative."""
    F, L = m.shape
    rhs = torch.cat([m, d[:, None] * m], 1)                  # [F, 2L]
    tot = A1[F] @ rhs                                        # [2L]
    n_l, sum_d = tot[:L], tot[L:]
    blk = max(int(block_flows), 1)
    theta = resid / torch.clamp_min(n_l, 1.0)
    for i in range(0, F, blk):
        Pc = A1[i:min(i + blk, F)] @ rhs                     # [blk, 2L]
        denom = n_l[None, :] - Pc[:, :L]
        theta_k = (resid[None, :] - Pc[:, L:]) / torch.clamp_min(denom, 0.5)
        cand = torch.where((m[i:i + blk] > 0) & (denom > 0.5), theta_k,
                           -_INF)
        theta = torch.maximum(theta, cand.amax(0))
    saturable = (n_l > 0) & (sum_d > resid * (1.0 + _RTOL) + _ATOL)
    return torch.where(saturable, theta, _INF)


def _link_levels_sorted(perm, d_s, m, resid):
    """Sorted (argsort + cumsum) form of the same water level: gather the
    mask rows into stable demand order once, then the rank prefixes are
    two batched cumsums — O(F·L). The max over candidates is
    order-independent, so no un-sort is needed."""
    m_s = m.index_select(0, perm)                             # [F, L]
    cum_n = torch.cumsum(m_s, 0)
    cum_d = torch.cumsum(d_s[:, None] * m_s, 0)
    return _theta_from_parts(m_s, cum_n[-1], cum_d[-1], cum_n, cum_d, resid)


def _fill(R, on_net, d, levels, capacity, rounds: int):
    """The progressive fill itself, generic over the water-level form.

    Per round: compute every link's exact demand-capped water level θ_l,
    then freeze every link that is *locally minimal* — θ_l ≤ θ_m for every
    link m sharing an unfrozen flow — at its level, its flows at
    ``min(d_f, θ_l)``, plus every flow whose demand is covered by all of
    its links (``d_f ≤ min_l θ_l``). A closing sweep assigns any
    still-unfrozen flow ``min(d_f, min_l θ_l)``, which never
    oversubscribes a link, so truncated runs stay feasible."""
    on_link = R > 0
    x = torch.zeros((R.shape[0],), dtype=torch.float32, device=R.device)
    frozen = ~on_net
    resid = capacity.to(torch.float32)
    for _ in range(rounds):
        u = (~frozen) & on_net
        m = R * u[:, None].to(R.dtype)                       # [F, L]
        theta = levels(m, resid)                             # [L]
        # per-flow bottleneck level: tightest link on the flow's route
        th_flow = torch.where(on_link, theta[None, :], _INF).amin(1)
        # locally minimal links: no unfrozen flow of theirs sees a tighter
        # link elsewhere (th_flow ≤ θ_l always, so this is a tie test)
        nbr = torch.where(m > 0, th_flow[:, None], _INF).amin(0)
        freeze_l = torch.isfinite(theta) & (
            theta <= nbr * (1.0 + _RTOL) + _ATOL)
        hit = ((R * freeze_l[None, :].to(R.dtype)).sum(1) > 0) & u
        sated = u & (d <= th_flow * (1.0 + _RTOL) + _ATOL)
        newf = hit | sated
        vals = torch.minimum(d, th_flow)      # th_flow=inf → demand
        x = torch.where(newf, vals, x)
        resid = torch.clamp_min(
            resid - torch.where(newf, vals, 0.0) @ R, 0.0)
        frozen = frozen | newf
    # closing sweep: any leftover flow rides its current bottleneck level —
    # always link-feasible, exact when the loop already converged
    m = R * ((~frozen) & on_net)[:, None].to(R.dtype)
    theta = levels(m, resid)
    th_flow = torch.where(on_link, theta[None, :], _INF).amin(1)
    return torch.where(frozen, x, torch.minimum(d, th_flow))


def _resolve_form(F: int, form: str | None) -> str:
    if form is None:
        return "sorted" if F >= MAXMIN_CROSSOVER_F else "gemm"
    if form not in ("gemm", "sorted"):
        raise ValueError(f"unknown maxmin form {form!r}")
    return form


def _resolve_block_flows(F: int, form: str, block_flows: int | None):
    if form != "gemm":
        return None
    if block_flows is None:
        return MAXMIN_BLOCK_FLOWS if F > 2 * MAXMIN_BLOCK_FLOWS else None
    return int(block_flows) if block_flows > 0 else None


def _levels_fn(form: str, d, A1, perm, block_flows):
    """Bind the chosen water-level form over its order machinery."""
    if form == "gemm":
        if block_flows is not None:
            return lambda m, resid: _link_levels_blocked(
                A1, d, m, resid, block_flows)
        return lambda m, resid: _link_levels(A1, d, m, resid)
    d_s = d[perm]
    return lambda m, resid: _link_levels_sorted(perm, d_s, m, resid)


def _prepare(R, demand):
    R = R.to(torch.float32)
    on_net = R.sum(1) > 0
    d = torch.where(on_net, torch.clamp_min(demand, 0.0), 0.0)
    return R, on_net, d


def maxmin_fused(R: torch.Tensor, capacity: torch.Tensor,
                 demand: torch.Tensor, rounds: int | None = FILL_ROUNDS,
                 form: str | None = None,
                 block_flows: int | None = None) -> torch.Tensor:
    """Demand-limited max-min fair rates as a fused fixed-trip program.

    R: [F, L] binary routing; capacity: [L]; demand: [F] per-flow caps.
    Flows traversing no link get their demand (unconstrained).
    ``rounds=None`` selects the provably exact shape bound min(F, L) + 1;
    the default ``FILL_ROUNDS`` is exact whenever the bottleneck-level
    chain is no deeper and link-feasible regardless.

    ``form`` picks the water-level evaluation: ``"gemm"``, ``"sorted"``, or
    ``None`` — the default — for the crossover on the flow count against
    :data:`MAXMIN_CROSSOVER_F`. ``block_flows`` chunks the GEMM form's
    candidate rows (``None`` = auto).
    """
    F, L = R.shape
    if rounds is None:
        rounds = min(F, L) + 1
    form = _resolve_form(F, form)
    block_flows = _resolve_block_flows(F, form, block_flows)
    R, on_net, d = _prepare(R, demand)
    if form == "gemm":
        A1, perm = _order_operand(d)
    else:
        A1 = None
        perm = torch.argsort(d, stable=True)
    levels = _levels_fn(form, d, A1, perm, block_flows)
    x = _fill(R, on_net, d, levels, capacity, rounds)
    return torch.where(on_net, x, demand)


# --------------------------------------------------------------------------
# order-cached per-tick stepping (the tick-loop hot path)
# --------------------------------------------------------------------------
def maxmin_order_init(F: int, form: str | None = None,
                      device: "str | torch.device" = "cpu"):
    """Initial (invalid) order-cache carry for per-tick solves: ``(valid,
    perm, A1)``. The first step always rebuilds (and counts as one
    rebuild). The sorted form carries no rank matrix (A1 is [0, F]); the
    GEMM form carries the full [F+1, F] operand."""
    form = _resolve_form(F, form)
    rows = F + 1 if form == "gemm" else 0
    return (torch.zeros((), dtype=torch.bool, device=device),
            torch.arange(F, device=device),
            torch.zeros((rows, F), dtype=torch.float32, device=device))


def maxmin_fused_step(R: torch.Tensor, capacity: torch.Tensor,
                      demand: torch.Tensor, carry,
                      rounds: int | None = FILL_ROUNDS,
                      form: str | None = None,
                      block_flows: int | None = None):
    """One order-cached solve with :func:`maxmin_fused` semantics.

    ``carry`` is ``(valid, perm, A1)`` from :func:`maxmin_order_init` or a
    previous step. An O(F) monotonicity check of the current (clamped)
    demands against the carried permutation — ``(d[perm], perm)`` must be
    strictly increasing in lexicographic order, which characterizes perm
    as *the* stable sort of d — decides whether the carried operand still
    encodes the exact order. Both the kept and the rebuilt operand are
    computed and the decision selects between them on the device, so the
    host never synchronises on it. The sorted form rebuilds its
    permutation with ``argsort(d, stable=True)`` — the same permutation as
    the reference's [F, F] order matrix, in O(F log F) time and O(F)
    memory. Returns ``(x, carry', rebuilt)`` with ``rebuilt`` a bool
    scalar tensor.
    """
    F, L = R.shape
    if rounds is None:
        rounds = min(F, L) + 1
    form = _resolve_form(F, form)
    block_flows = _resolve_block_flows(F, form, block_flows)
    R, on_net, d = _prepare(R, demand)

    valid0, perm0, A1_0 = carry
    dp = d[perm0]
    if F > 1:
        mono = torch.all((dp[:-1] < dp[1:])
                         | ((dp[:-1] == dp[1:]) & (perm0[:-1] < perm0[1:])))
    else:
        mono = torch.ones((), dtype=torch.bool, device=R.device)
    ok = valid0 & mono

    if form == "gemm":
        A1_new, perm_new = _order_operand(d)
        A1 = torch.where(ok, A1_0, A1_new)
    else:
        perm_new = torch.argsort(d, stable=True)
        A1 = A1_0
    perm = torch.where(ok, perm0, perm_new)
    levels = _levels_fn(form, d, A1, perm, block_flows)
    x = _fill(R, on_net, d, levels, capacity, rounds)
    x = torch.where(on_net, x, demand)
    return x, (torch.ones((), dtype=torch.bool, device=R.device), perm, A1), ~ok
