"""Plain reference of the port's simulation loop, for the benchmark's check.

It starts from the benchmark's scenario description (``portbench.scenario``)
and works everything out again: instances and flows, the key-skew split,
placement, routes and the route bank of the SDN controller, the expected
join proportions, the latency path weights, the capacity schedule; then
runs the fluid tick, the tcp baseline (the demand-capped max-min fill, two
rounds and a closing sweep) or the paper's Alg. 1 (eq. 3 on uplinks, the
exact water level of eq. 4 on downlinks by a sort, the internal scale-down
and the backfill), and the seven-metric epilogue.

Routes are kept as at most four link ids a flow, so a tick costs O(F), not
the port's O(F·L) dense products; per-link solves sort each link's flows.
It imports nothing of the port, of JAX or of the JAX package. Scenarios of
one batch share their sizes; their draws differ.

``precision="float64"`` is the reference. ``"float32"`` is plain float32,
for telling a number that rounding decides from one that a lower precision
moves. ``"tf32"`` computes it in float32 with every sum that the port takes
as a matrix product fed TF32 operands (10 mantissa bits, as a tensor core
rounds them): the precision step below the configuration's float32, which
the CPU tests use as the control where the card's TF32 is out of reach.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.scenario import INTERNAL, ROUTE_DOWN, Scenario, fabric_of, flows, machines

EPS = 1e-9
INTERNAL_RATE = 1e6      # MB/s moved by a flow that stays on its machine
LAT_CAP = 1e4            # s, cap of one flow's wait
TIE_RTOL = TIE_ATOL = 1e-6   # the max-min fill's tie tolerance
FILL_ROUNDS = 2          # rounds of the tcp fill before its closing sweep
MAX_PATHS = 64           # source-to-sink paths in the latency estimate
BACKFILL_ITERS, BACKFILL_DAMPING = 8, 0.9
QCAP_MB = 8.0
PRECISIONS = ("float64", "float32", "tf32")
# a quantity within this share of its own operands' size, or of a threshold,
# is rounding's to decide: which side of a clamp or a threshold it takes
# depends on the order of the sums that made it
TIE_SHARE = 1e-4
UTILIZATION = 3          # the epilogue's entry of the busy links' utilization


# ------------------------------------------------------------- compiling
def _paths_weight(src, dst, is_sink, gen, n_inst) -> np.ndarray:
    """Mean over the first ``MAX_PATHS`` source-to-sink instance paths, in
    depth-first order (flows in index order), of each flow's membership."""
    out_flows = [[] for _ in range(n_inst)]
    for f, s in enumerate(src):
        out_flows[int(s)].append(f)
    paths = []

    def walk(i, acc):
        if len(paths) >= MAX_PATHS:
            return
        if is_sink[i]:
            paths.append(acc)
            return
        for f in out_flows[i]:
            walk(int(dst[f]), acc + [f])

    for i in range(n_inst):
        if gen[i] > 0:
            walk(i, [])
    w = np.zeros(len(src))
    for p in paths:
        w[p] += 1.0
    return w / max(len(paths), 1)


def build(sc: Scenario, app: dict, n_ticks: int, dt: float) -> dict:
    """Everything one scenario's run needs, as numpy arrays; ``app`` is the
    configuration's description of ``sc.app``."""
    ops, edges = app["operators"], app["edges"]
    fab = fabric_of(sc.fabric)
    op_of_inst, src, dst, frac, eid = flows(app, sc.skew_seed)
    I, F = op_of_inst.size, src.size
    col = lambda key: np.array([float(ops[k][key]) for k in op_of_inst])
    gen = col("gen_rate") / np.array(
        [ops[k]["parallelism"] for k in op_of_inst])
    sel, proc = col("selectivity"), np.minimum(col("proc_rate"), 1e9)
    is_join = np.array([bool(ops[k]["join"]) for k in op_of_inst])
    has_out = {e["src"] for e in edges}
    is_sink = np.array([ops[k]["name"] not in has_out for k in op_of_inst])

    # open-loop steady-state volume per flow, then each join input's share
    inflow = np.zeros(I)
    for _ in range(32):
        out = gen + sel * inflow
        inflow = np.bincount(dst, frac * out[src], minlength=I)
    vol = frac * (gen + sel * inflow)[src] + 1e-12
    share = np.array([np.nan if edges[e]["join_share"] is None
                      else edges[e]["join_share"] for e in eid])
    p_in = np.zeros(F)
    by_dst = np.argsort(dst, kind="stable")
    bounds = np.searchsorted(dst[by_dst], np.arange(I + 1))
    for i in range(I):
        fl = by_dst[bounds[i]:bounds[i + 1]]
        if fl.size == 0:
            continue
        used = 0.0
        over = fl[~np.isnan(share[fl])]
        for e in np.unique(eid[over]):
            fe = over[eid[over] == e]
            p_in[fe] = share[fe[0]] * vol[fe] / vol[fe].sum()
            used += share[fe[0]]
        free = fl[np.isnan(share[fl])]
        if free.size:
            p_in[free] = max(1.0 - used, 0.0) * vol[free] / vol[free].sum()
        if p_in[fl].sum() > 0:
            p_in[fl] /= p_in[fl].sum()

    machine = machines(I, fab.n_machines)
    ms, md = machine[src], machine[dst]
    L = fab.n_links
    # capacity schedule and the route state of every tick; times, and the
    # schedule's parameters, as float32 values, which is how they are given
    ts = np.arange(n_ticks, dtype=np.float32) * np.float32(dt)
    caps = np.broadcast_to(fab.caps, (n_ticks, L)).copy()
    states, state_of_tick = [fab.routes(ms, md)], np.zeros(n_ticks, np.int64)
    if sc.cycle:
        period, amp, phase = sc.cycle
        amp, phase = np.float32(amp), np.float32(phase)
        omega = np.float32(2.0 * np.pi / period)
        caps *= 1.0 + float(amp) * np.sin(float(omega) * ts.astype(np.float64)
                                          + float(phase))[:, None]
    if sc.failed:
        t0, t1 = np.float32(sc.t_fail), np.float32(sc.t_recover)
        on = (ts >= t0) & (ts < t1)
        caps[np.ix_(on, np.array(sc.failed))] *= float(np.float32(sc.scale))
        if sc.reroute and np.float32(sc.scale) < ROUTE_DOWN:
            down = np.zeros(L, bool)
            down[list(sc.failed)] = True
            states.append(fab.routes(ms, md, down))
            state_of_tick = on.astype(np.int64)
    caps = np.maximum(caps, 0.0)
    return dict(
        F=F, L=L, I=I, src=src, dst=dst, w=frac, gen=gen, sel=sel, proc=proc,
        is_sink=is_sink, join_dst=is_join[dst],
        droppable=np.array([bool(edges[e]["droppable"]) for e in eid]),
        p_in=p_in, path_w=_paths_weight(src, dst, is_sink, gen, I),
        routes=np.stack(states), state_of_tick=state_of_tick,
        up=np.where(ms != md, fab.up[ms], L),
        down=np.where(ms != md, fab.down[md], L),
        caps_t=caps, kinds=fab.kinds, enforce=sc.kind != "static")


# ---------------------------------------------------------------- running
def _tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Batch:
    """S scenarios of one size, run side by side on ``device``."""

    def __init__(self, built: list[dict], device, precision="float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.dt_ = torch.float64 if precision == "float64" else torch.float32
        self.control = precision == "tf32"
        self.dev = torch.device(device)
        b0 = built[0]
        self.S, self.F, self.L, self.I = len(built), b0["F"], b0["L"], b0["I"]
        S, L, I = self.S, self.L, self.I
        L1 = L + 1
        t = lambda key, dtype=None: torch.as_tensor(
            np.stack([b[key] for b in built]), device=self.dev,
            dtype=dtype or self.dt_)
        self.offL = (torch.arange(S, device=self.dev) * L1)[:, None]
        self.offI = (torch.arange(S, device=self.dev) * I)[:, None]
        self.src = t("src", torch.int64)
        self.dst = t("dst", torch.int64)
        self.src_flat = self.src + self.offI
        self.dst_flat = self.dst + self.offI
        for key in ("w", "gen", "sel", "proc", "p_in", "path_w"):
            setattr(self, key, t(key))
        for key in ("is_sink", "join_dst", "droppable"):
            setattr(self, key, t(key, torch.bool))
        self.kinds = t("kinds", torch.int64)
        K = max(b["routes"].shape[0] for b in built)
        routes = np.stack([np.concatenate(
            [b["routes"]] + [b["routes"][:1]] * (K - b["routes"].shape[0]))
            for b in built])                                   # [S, K, F, 4]
        self.routes = (torch.as_tensor(routes, device=self.dev)
                       + self.offL[:, :, None, None])
        self.state_of_tick = t("state_of_tick", torch.int64)
        self.caps_t = t("caps_t")                              # [S, T, L]
        self.up = t("up", torch.int64) + self.offL
        self.down = t("down", torch.int64) + self.offL
        self.on_net = t("up", torch.int64) < L
        self.enforce = t("enforce", torch.bool)[:, None]
        self.rows = torch.arange(S, device=self.dev)
        # [S]: a controller update whose rates rounding decides (see allocate)
        self.decided = torch.zeros(S, dtype=torch.bool, device=self.dev)

    # -- sums the port takes as products against 0/1 matrices ------------
    def _in(self, v):
        return _tf32(v) if self.control else v

    def link_sum(self, r, v):
        """[S, L] per-link sum of ``v`` [S, F] over the flows on each link."""
        out = torch.zeros(self.S * (self.L + 1), dtype=self.dt_, device=self.dev)
        out.index_add_(0, r.reshape(-1), self._in(v)[..., None].expand(
            *v.shape, r.shape[-1]).reshape(-1))
        return out.view(self.S, self.L + 1)[:, :self.L]

    def flow_min(self, r, per_link, fill=float("inf")):
        """[S, F] minimum of ``per_link`` [S, L] over each flow's links
        (``fill`` for a flow on no link)."""
        ext = torch.cat([per_link, torch.full_like(per_link[:, :1], fill)], 1)
        return ext.reshape(-1)[r].amin(-1)

    def inst_sum(self, v, idx):
        out = torch.zeros(self.S * self.I, dtype=self.dt_, device=self.dev)
        out.index_add_(0, idx.reshape(-1), self._in(v).reshape(-1))
        return out.view(self.S, self.I)

    def inst_min(self, v, idx, mask, empty):
        out = torch.full((self.S * self.I,), float("inf"), dtype=self.dt_,
                         device=self.dev)
        vals = torch.where(mask, v, float("inf")).reshape(-1)
        out.scatter_reduce_(0, idx.reshape(-1), vals, "amin")
        out = out.view(self.S, self.I)
        return torch.where(torch.isfinite(out), out, empty)

    def segments(self, seg, key, valid):
        """Dense per-segment layout of the entries ``valid`` in ascending
        ``key`` within each segment: (rows, cols, counts, width)."""
        seg, key = seg.reshape(-1), key.reshape(-1)
        n_seg = self.S * (self.L + 1)
        seg = torch.where(valid.reshape(-1), seg, n_seg)
        o = torch.argsort(key, stable=True)
        o = o[torch.argsort(seg[o], stable=True)]
        s = seg[o]
        counts = torch.bincount(s, minlength=n_seg + 1)[:n_seg]
        start = torch.cumsum(counts, 0) - counts
        keep = s < n_seg
        o, s = o[keep], s[keep]
        pos = torch.arange(o.numel(), device=self.dev) - start[s]
        width = int(counts.max()) if counts.numel() else 0
        return o, s, pos, counts, max(width, 1)

    def dense(self, s, pos, width, vals, fill=0.0):
        out = torch.full((self.S * (self.L + 1), width), fill,
                         dtype=self.dt_, device=self.dev)
        out[s, pos] = vals
        return out

    # -- tcp: the demand-capped max-min fill --------------------------------
    def _levels(self, r, d, u, resid):
        """θ_l with Σ_{unfrozen f on l} min(d_f, θ) = resid_l, by the
        classic scan of the link's demands in ascending order; +inf where
        the link cannot saturate (within the tie tolerance)."""
        valid = u[..., None] & (r < (self.offL[:, :, None] + self.L))
        dd = d[..., None].expand_as(r)
        o, s, pos, counts, width = self.segments(r, dd, valid)
        D = self.dense(s, pos, width, dd.reshape(-1)[o])
        excl = torch.cumsum(D, 1) - D
        n = counts.to(self.dt_)[:, None]
        k = torch.arange(width, device=self.dev, dtype=self.dt_)[None, :]
        res = torch.cat([resid, torch.zeros_like(resid[:, :1])], 1).reshape(-1, 1)
        t = (res - excl) / torch.clamp_min(n - k, 1.0)
        ok = (k < n) & (t <= D)
        first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), 0)
        theta = t.gather(1, first[:, None])[:, 0]
        sum_d = D.sum(1)
        sat = (counts > 0) & (sum_d > res[:, 0] * (1 + TIE_RTOL) + TIE_ATOL)
        theta = torch.where(sat, theta, float("inf"))
        return theta.view(self.S, self.L + 1)[:, :self.L]

    def maxmin(self, r, caps, demand):
        on = self.on_net
        d = torch.where(on, torch.clamp_min(demand, 0.0), 0.0)
        x = torch.zeros_like(d)
        frozen = ~on
        resid = caps.clone()
        for _ in range(FILL_ROUNDS):
            u = ~frozen & on
            theta = self._levels(r, d, u, resid)
            th_f = self.flow_min(r, theta)
            nbr = torch.full((self.S * (self.L + 1),), float("inf"),
                             dtype=self.dt_, device=self.dev)
            nbr.scatter_reduce_(0, r.reshape(-1), torch.where(
                u[..., None], th_f[..., None], float("inf")).expand_as(
                r).reshape(-1), "amin")
            nbr = nbr.view(self.S, self.L + 1)[:, :self.L]
            freeze = torch.isfinite(theta) & (
                theta <= nbr * (1 + TIE_RTOL) + TIE_ATOL)
            hit = self.flow_min(r, (~freeze).to(self.dt_), 1.0) == 0
            sated = u & (d <= th_f * (1 + TIE_RTOL) + TIE_ATOL)
            new = (hit & u) | sated
            vals = torch.minimum(d, th_f)
            x = torch.where(new, vals, x)
            resid = torch.clamp_min(
                resid - self.link_sum(r, torch.where(new, vals, 0.0)), 0.0)
            frozen = frozen | new
        theta = self._levels(r, d, ~frozen & on, resid)
        x = torch.where(frozen, x, torch.minimum(d, self.flow_min(r, theta)))
        return torch.where(on, x, demand)

    # -- appaware: Alg. 1 ---------------------------------------------------
    def allocate(self, r, caps, Qs, B, v, ls, lr, dta):
        L1 = self.L + 1
        capx = torch.cat([caps, torch.zeros_like(caps[:, :1])], 1).reshape(-1)
        w = torch.clamp_min(v + 2.0 * Qs - ls, 0.0)
        rho = torch.clamp_min((v - B + lr) / dta, EPS)
        on = self.on_net
        # an eq. (3) weight or a drain estimate that is a difference of equal
        # numbers (a starved join's backlog, a stalled sender): its sign, and
        # so the clamp and every share after it, is rounding's choice
        for diff, size in ((v + 2.0 * Qs - ls, v.abs() + 2.0 * Qs.abs() + ls.abs()),
                           (v - B + lr, v.abs() + B.abs() + lr.abs())):
            self.decided |= (on & (size > 0)
                             & (diff.abs() < TIE_SHARE * size)).any(1)
        # eq. (3) on each uplink: shares of its capacity by demand
        up = self.up.reshape(-1)
        sw = torch.zeros(self.S * L1, dtype=self.dt_, device=self.dev)
        sw.index_add_(0, up, torch.where(on, w, 0.0).reshape(-1))
        n_up = torch.bincount(up, minlength=self.S * L1).to(self.dt_)
        fb = sw[up] <= EPS
        x_up = torch.where(fb, capx[up] / torch.clamp_min(n_up[up], 1.0),
                           capx[up] * w.reshape(-1) / torch.where(fb, 1.0, sw[up]))
        # eq. (4) on each downlink: the level θ that drains every queue at
        # once, Σ max(0, θ·ρ_f − L_f)/dt = C, from the activation order
        act = B / rho
        o, s, pos, counts, width = self.segments(self.down, act, on)
        A = self.dense(s, pos, width, act.reshape(-1)[o])
        cum_rho = torch.cumsum(self.dense(s, pos, width, rho.reshape(-1)[o]), 1)
        cum_L = torch.cumsum(self.dense(s, pos, width, B.reshape(-1)[o]), 1)
        k = torch.arange(width, device=self.dev)[None, :]
        theta_k = (capx[:, None] * dta + cum_L) / torch.clamp_min(cum_rho, EPS)
        ok = (k < counts[:, None]) & (theta_k >= A)
        last = torch.where(ok, k, -1).amax(1).clamp_min(0)
        theta = theta_k.gather(1, last[:, None])[:, 0]
        dn = self.down.reshape(-1)
        x_dn = torch.clamp_min(theta[dn] * rho.reshape(-1) - B.reshape(-1),
                               0.0) / dta
        tot = torch.zeros(self.S * L1, dtype=self.dt_, device=self.dev)
        tot.index_add_(0, dn, torch.where(on.reshape(-1), x_dn, 0.0))
        x_dn = torch.where(tot[dn] > EPS, x_dn * capx[dn] / tot[dn], x_dn)
        x = torch.where(on.reshape(-1), torch.minimum(x_up, x_dn), 0.0)
        x = x.view(self.S, self.F)
        # internal links scale their flows down to fit (Alg. 1 l. 24-29)
        is_int = self.kinds == INTERNAL
        load = self.link_sum(r, x)
        scale = torch.where(is_int & (load > caps),
                            caps / torch.clamp_min(load, EPS), 1.0)
        x = x * self.flow_min(r, scale, 1.0)
        # backfill: hand leftover capacity out in proportion to the shares
        for _ in range(BACKFILL_ITERS):
            load = self.link_sum(r, x)
            ratio = torch.clamp_min(caps - load, 0.0) / torch.clamp_min(load, EPS)
            r_min = self.flow_min(r, ratio)
            x = x + BACKFILL_DAMPING * torch.where(
                on & torch.isfinite(r_min), x * r_min, 0.0)
        return x

    # -- the fluid tick ---------------------------------------------------
    def tick(self, r, caps, Qs, Qr, x, dt):
        desired = torch.minimum(torch.minimum(Qs, x * dt),
                                torch.clamp_min(QCAP_MB - Qr, 0.0))
        # a scenario with a schedule has the network enforce the current
        # capacity on every tick, whatever its stale rates say
        load = self.link_sum(r, desired)
        cdt = caps * dt
        lscale = torch.where(load > cdt, torch.clamp(
            cdt / torch.clamp_min(load, EPS), 0.0, 1.0), 1.0)
        transfer = torch.where(self.enforce,
                               desired * self.flow_min(r, lscale, 1.0), desired)
        Qs, Qr = Qs - transfer, Qr + transfer
        proc_dt = self.proc * dt
        # joins advance in lock step with their slowest proportional input
        ratio = Qr / torch.clamp_min(self.p_in, EPS)
        join_amt = torch.minimum(self.inst_min(
            ratio, self.dst_flat, torch.ones_like(self.join_dst), 0.0), proc_dt)
        consume_join = join_amt.gather(1, self.dst) * self.p_in
        total_in = self.inst_sum(Qr, self.dst_flat)
        amt = torch.minimum(total_in, proc_dt)
        share = (amt / torch.clamp_min(total_in, EPS)).gather(1, self.dst)
        consume = torch.minimum(torch.where(self.join_dst, consume_join,
                                            Qr * share), Qr)
        # bounded send queues stall their sender
        out0 = self.sel * self.inst_sum(consume, self.dst_flat) + self.gen * dt
        prod = out0.gather(1, self.src) * self.w
        room = torch.clamp(torch.clamp_min(QCAP_MB - Qs, 0.0)
                           / torch.clamp_min(prod, EPS), 0.0, 1.0)
        stall = self.inst_min(room, self.src_flat, ~self.droppable, 1.0)
        consume = consume * stall.gather(1, self.dst)
        Qr = Qr - consume
        Qr = torch.where(self.droppable, torch.clamp_max(Qr, 0.5), Qr)
        in_i = self.inst_sum(consume, self.dst_flat)
        out = self.sel * in_i + self.gen * dt * stall
        Qs = Qs + out.gather(1, self.src) * self.w
        Qs = torch.where(self.droppable, torch.clamp_max(Qs, 0.5), Qs)
        sink = torch.where(self.is_sink, in_i, 0.0).sum(1)
        drain = consume / dt
        wait = torch.clamp_max(Qs / torch.clamp_min(x, EPS)
                               + Qr / torch.clamp_min(drain, EPS), LAT_CAP)
        lat = (self._in(wait) * self._in(self.path_w)).sum(1)
        return Qs, Qr, transfer, drain, sink, lat, self.link_sum(r, transfer) / dt

    def run(self, policy: str, n_ticks: int, dt: float, upd_every: int):
        """Every tick's (sink MB [S], latency s [S], link load MB/s [S, L])."""
        z = torch.zeros((self.S, self.F), dtype=self.dt_, device=self.dev)
        Qs = Qr = B = x = v = ls = lr = prod_rate = drain_ewma = z
        sinks, lats, loads = [], [], []
        for k in range(n_ticks):
            r = self.routes[self.rows, self.state_of_tick[:, k]]
            caps = self.caps_t[:, k]
            if k % upd_every == 0:
                if policy == "tcp":
                    demand = torch.minimum(
                        Qs / dt + prod_rate,
                        torch.clamp_min(QCAP_MB - Qr, 0.0) / dt + drain_ewma)
                    x = torch.minimum(self.maxmin(r, caps, demand), demand)
                elif policy == "appaware":
                    x = self.allocate(r, caps, Qs, B, v, ls, lr, dt * upd_every)
                else:
                    raise ValueError(f"unknown policy {policy!r}")
                x = torch.where(self.on_net, x, INTERNAL_RATE)
                v, ls, lr = z, Qs, B
            Qs, Qr, transfer, drain, sink, lat, load = self.tick(
                r, caps, Qs, Qr, x, dt)
            if policy == "tcp":
                t_in = self.inst_sum(transfer, self.dst_flat)
                out = self.sel * t_in + self.gen * dt
                prod_rate = out.gather(1, self.src) * self.w / dt
                drain_ewma = 0.5 * drain_ewma + 0.5 * drain
            else:
                B = torch.clamp(B + transfer - drain * dt, 0.0, 8.0 * QCAP_MB)
                v = v + transfer
            sinks.append(sink)
            lats.append(lat)
            loads.append(load)
        return (torch.stack(sinks, 1), torch.stack(lats, 1),
                torch.stack(loads, 1))


# ---------------------------------------------------------------- epilogue
def _smooth(v: np.ndarray, w: int) -> np.ndarray:
    return np.convolve(v, np.ones(w, v.dtype), mode="same")


def epilogue(sink, lat, load, caps_t, dt: float, t_event: float,
             win_s: float = 5.0, pre_s: float = 20.0, frac: float = 0.95,
             hot: float = 0.5) -> np.ndarray:
    """The seven metrics of one run, from its trajectories: mean sink rate
    after the first quarter, the smoothed rate at the end, mean latency,
    the mean utilization of the links loaded to ``hot`` of their scheduled
    capacity (else of the nearly busiest), the dip after ``t_event`` and the
    time to settle within 5% of the final level, and the total delivered."""
    T = sink.shape[0]
    warm = T // 4
    rate = sink / dt
    util = (load[warm:] / np.maximum(caps_t[warm:], EPS)).mean(0)
    busy = util >= hot
    if not busy.any():
        busy = util >= util.max() * 0.999
    w = max(int(round(win_s / dt)), 1)
    r = _smooth(rate, w) / _smooth(np.ones_like(rate), w)
    i = min(int(round(t_event / dt)), T - 1)
    pre = r[max(0, i - int(round(pre_s / dt))):max(i, 1)].mean()
    post = r[i:]
    dip = max(0.0, (pre - post.min()) / pre) if pre > EPS else 0.0
    recovery = 0.0
    if post.size >= 2:
        steady = post[-max(post.size // 4, 1):].mean()
        inside = (post >= frac * steady) & (post * frac <= steady)
        if not inside.all():
            out = int(np.argmax(~inside))
            back = inside[out:]
            recovery = (float(out + int(np.argmax(back))) * dt if back.any()
                        else float("inf"))
    return np.array([rate[warm:].mean(), r[-1], lat[warm:].mean(),
                     util[busy].mean(), dip, recovery, sink.sum()])


def utilization_tie(load, caps_t, hot: float = 0.5) -> bool:
    """Whether a link's utilization (as ``epilogue`` takes it) lies within
    ``TIE_SHARE`` of a threshold of the busy set: ``hot``, or, where no
    link reaches it, 0.999 of the busiest. Rounding then picks the set."""
    warm = load.shape[0] // 4
    util = (load[warm:] / np.maximum(caps_t[warm:], EPS)).mean(0)
    near = np.abs(util - hot) < TIE_SHARE * hot
    if not (util >= hot).any():
        top = 0.999 * util.max()
        near |= np.abs(util - top) < TIE_SHARE * top
    return bool(near.any())


def simulate(scenarios: list[Scenario], apps: dict, policy: str,
             seconds: float, dt: float, upd_every: int, t_event: float,
             device="cpu", precision: str = "float64") -> dict:
    """The reference's run of ``scenarios`` (``apps`` maps each one's app
    to its description): numpy arrays ``sink`` [S, T], ``latency`` [S, T],
    ``link_load`` [S, T, L] and ``metrics`` [S, 7]; and the scenarios that
    rounding decides: ``decided`` [S] (a controller update, and so the whole
    run) and ``tie`` [S, 7] (an entry of the epilogue at its threshold)."""
    n_ticks = int(round(seconds / dt))
    built = [build(sc, apps[sc.app], n_ticks, dt) for sc in scenarios]
    S, L = len(built), built[0]["L"]
    out = dict(sink=np.zeros((S, n_ticks)), latency=np.zeros((S, n_ticks)),
               link_load=np.zeros((S, n_ticks, L)), metrics=np.zeros((S, 7)),
               decided=np.zeros(S, bool), tie=np.zeros((S, 7), bool))
    groups = {}
    for k, b in enumerate(built):
        groups.setdefault((b["F"], b["I"], b["L"]), []).append(k)
    for rows in groups.values():
        batch = Batch([built[k] for k in rows], device, precision)
        sink, lat, load = (t.cpu().numpy() for t in batch.run(
            policy, n_ticks, dt, upd_every))
        for j, k in enumerate(rows):
            out["sink"][k], out["latency"][k] = sink[j], lat[j]
            out["link_load"][k] = load[j]
            caps = built[k]["caps_t"].astype(sink.dtype)
            out["metrics"][k] = epilogue(sink[j], lat[j], load[j], caps, dt,
                                         t_event)
            out["tie"][k, UTILIZATION] = utilization_tie(load[j], caps)
        out["decided"][rows] = batch.decided.cpu().numpy()
        del batch
    return out
