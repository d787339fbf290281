"""Datacenter network model (paper §II-B, Fig. 2).

Links are unidirectional. Every machine has one *uplink* (machine -> rack
switch) and one *downlink* (rack switch -> machine). Multi-hop fabrics add
*internal* links (rack-to-core, core-to-rack). A flow (src machine, dst
machine) traverses: its uplink, zero or more internal links, and the
destination downlink. Internal flows (src == dst machine) traverse nothing.

Topology construction is static python/numpy; the resulting routing matrix
``R`` ([F, L] binary) and capacity vector feed the PyTorch solvers in
``repro_torch.core``. This module is a numpy copy of ``repro.net.topology``
(the port imports nothing of the JAX package); the two are held to exact
array equality by the tests.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class LinkKind(enum.IntEnum):
    UPLINK = 0
    DOWNLINK = 1
    INTERNAL = 2


@dataclasses.dataclass(frozen=True)
class Link:
    name: str
    kind: LinkKind
    capacity: float  # MB/s


@dataclasses.dataclass
class Topology:
    """A set of unidirectional links plus a routing function."""

    n_machines: int
    links: list[Link]
    # machine -> link index
    uplink_idx: np.ndarray
    downlink_idx: np.ndarray
    # rack topology metadata (empty for big-switch)
    rack_of: np.ndarray            # machine -> rack id
    rack_to_core_idx: np.ndarray   # [n_racks, n_cores] link index or -1
    core_to_rack_idx: np.ndarray   # [n_cores, n_racks] link index or -1
    n_cores: int = 0

    @property
    def n_links(self) -> int:
        return len(self.links)

    @property
    def capacities(self) -> np.ndarray:
        return np.array([l.capacity for l in self.links], dtype=np.float64)

    @property
    def link_kinds(self) -> np.ndarray:
        return np.array([int(l.kind) for l in self.links], dtype=np.int32)

    # ---- routing -----------------------------------------------------
    def core_for(self, src: int, dst: int) -> int:
        """ECMP-like deterministic core pick (paper notes ECMP is
        utilization/volume agnostic — which is what creates the internal
        bottlenecks §II-B discusses)."""
        return (src + dst) % max(self.n_cores, 1)

    def route(self, src: int, dst: int) -> list[int]:
        """Link indices traversed by flow src->dst (machines)."""
        if src == dst:
            return []  # internal flow: no network links
        path = [int(self.uplink_idx[src])]
        r_s, r_d = int(self.rack_of[src]), int(self.rack_of[dst])
        if self.n_cores > 0 and r_s != r_d:
            c = self.core_for(src, dst)
            path.append(int(self.rack_to_core_idx[r_s, c]))
            path.append(int(self.core_to_rack_idx[c, r_d]))
        path.append(int(self.downlink_idx[dst]))
        return path

    def route_avoiding(self, src: int, dst: int,
                       down: np.ndarray) -> "list[int] | None":
        """Shortest path src->dst that avoids ``down`` links ([L] bool).

        Up/down links have no alternates — if either endpoint link is down
        the flow has no surviving path (returns ``None``). Cross-rack flows
        choose among cores: every core path has the same hop count, so
        "shortest surviving" reduces to a core pick, and the existing ECMP
        choice (``core_for``) is the tie-break — surviving cores are tried
        in cyclic order starting from it, keeping rerouting deterministic
        and minimally disruptive (unaffected flows keep their ECMP core).
        """
        if src == dst:
            return []
        up, dn = int(self.uplink_idx[src]), int(self.downlink_idx[dst])
        if down[up] or down[dn]:
            return None
        r_s, r_d = int(self.rack_of[src]), int(self.rack_of[dst])
        if self.n_cores > 0 and r_s != r_d:
            c0 = self.core_for(src, dst)
            for k in range(self.n_cores):
                c = (c0 + k) % self.n_cores
                a = int(self.rack_to_core_idx[r_s, c])
                b = int(self.core_to_rack_idx[c, r_d])
                if a >= 0 and b >= 0 and not down[a] and not down[b]:
                    return [up, a, b, dn]
            return None
        return [up, dn]

    def path_links(self, src: np.ndarray, dst: np.ndarray,
                   down: "np.ndarray | None" = None):
        """Every flow's path at once: ``(links, used, ok)``, the [F, 4] link
        ids of uplink, rack-to-core, core-to-rack and downlink, which of
        them the flow takes ([F, 4] bool), and [F] bool. Without ``down``
        each path is :meth:`route`'s and ``ok`` is all true; with it, each
        is :meth:`route_avoiding`'s, and ``ok`` is false where that gives
        ``None``."""
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        F, C = src.size, self.n_cores
        links = np.zeros((F, 4), np.int64)
        used = np.zeros((F, 4), bool)
        net = src != dst
        rs, rd = self.rack_of[src], self.rack_of[dst]
        cross = net & (rs != rd) & (C > 0)
        links[:, 0], used[:, 0] = self.uplink_idx[src], net
        links[:, 3], used[:, 3] = self.downlink_idx[dst], net
        ok = np.ones(F, bool)
        if down is not None:
            ok = ~net | ~(down[links[:, 0]] | down[links[:, 3]])
        i = np.flatnonzero(cross)
        if i.size:
            c = (src[i] + dst[i]) % C
            if down is not None:
                cand = (c[:, None] + np.arange(C)[None, :]) % C
                a = self.rack_to_core_idx[rs[i, None], cand]
                b = self.core_to_rack_idx[cand, rd[i, None]]
                alive = (a >= 0) & (b >= 0) & ~down[a] & ~down[b]
                c = cand[np.arange(i.size), alive.argmax(1)]
                ok[i] &= alive.any(1)
            links[i, 1] = self.rack_to_core_idx[rs[i], c]
            links[i, 2] = self.core_to_rack_idx[c, rd[i]]
            used[i, 1:3] = True
        return links, used, ok

    def routing_matrix(self, flows: Sequence[tuple[int, int]],
                       dtype=np.float64) -> np.ndarray:
        """Binary R[f, l] = 1 iff flow f traverses link l (eq. 1a)."""
        pairs = np.asarray(flows, np.int64).reshape(-1, 2)
        R = np.zeros((pairs.shape[0], self.n_links), dtype=dtype)
        links, used, _ = self.path_links(pairs[:, 0], pairs[:, 1])
        R[np.nonzero(used)[0], links[used]] = 1.0
        return R

    def set_capacity(self, kind: LinkKind, capacity: float) -> "Topology":
        """Return a copy with every link of ``kind`` re-capacitated (used to
        throttle internal links to shift the bottleneck, §VI-A.1)."""
        links = [
            Link(l.name, l.kind, capacity if l.kind == kind else l.capacity)
            for l in self.links
        ]
        return dataclasses.replace(self, links=links)


# --------------------------------------------------------------------------
# time-varying link capacities
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkSchedule:
    """Compact in-run capacity schedule: ``caps(t)`` per link.

    The simulator evaluates, per tick,

        caps_l(t) = base_l · (1 + Σ_s amp[s,l]·sin(omega[s,l]·t + phase[s,l]))
                           · Π_{e active at t, link_e = l} scale_e

    clipped at zero. Two compact array families cover the paper's in-run
    regimes (Fig. 5/12 transients):

      * **sinusoids** ``[S, L]`` — diurnal-style smooth cycles (S basis
        components; S = 0 means none and the simulator skips the term by
        *shape*, so static runs pay nothing);
      * **events** ``[E]`` — piecewise-constant multiplicative steps
        ``scale_e`` on link ``link_e`` over ``[t0_e, t1_e)``: link
        failures (scale 0), brown-outs (0 < scale < 1), and recoveries
        (the event simply ends). E = 0 likewise skips by shape.

    Both families batch and pad like any other fleet field: padded
    sinusoid rows have zero amplitude, padded events never activate
    (``t0 = inf``) — a padded schedule is bitwise-neutral.
    """

    n_links: int
    sin_amp: np.ndarray     # [S, L]
    sin_omega: np.ndarray   # [S, L] rad/s
    sin_phase: np.ndarray   # [S, L] rad
    ev_t0: np.ndarray       # [E] s (event active while t0 <= t < t1)
    ev_t1: np.ndarray       # [E] s
    ev_link: np.ndarray     # [E] int32 link index
    ev_scale: np.ndarray    # [E] capacity multiplier while active

    @classmethod
    def constant(cls, n_links: int) -> "LinkSchedule":
        """A schedule that never changes anything — but *does* exercise the
        dynamic evaluation path (one zero-amplitude sinusoid and one never-
        active event), so it serves as the static-parity oracle."""
        z = np.zeros((1, n_links), np.float32)
        return cls(
            n_links=n_links, sin_amp=z, sin_omega=z.copy(),
            sin_phase=z.copy(),
            ev_t0=np.full((1,), np.inf, np.float32),
            ev_t1=np.full((1,), np.inf, np.float32),
            ev_link=np.zeros((1,), np.int32),
            ev_scale=np.ones((1,), np.float32),
        )

    @classmethod
    def empty(cls, n_links: int) -> "LinkSchedule":
        """No components at all (S = 0, E = 0): identical to passing no
        schedule — the simulator skips every dynamic term by shape."""
        z = np.zeros((0, n_links), np.float32)
        e = np.zeros((0,), np.float32)
        return cls(n_links=n_links, sin_amp=z, sin_omega=z.copy(),
                   sin_phase=z.copy(), ev_t0=e, ev_t1=e.copy(),
                   ev_link=e.astype(np.int32), ev_scale=e.copy())

    # ---- builders (functional: each returns a new schedule) ----------
    def with_event(self, link_ids, t0: float, t1: float = np.inf,
                   scale: float = 0.0) -> "LinkSchedule":
        """Scale the given links' capacity by ``scale`` over ``[t0, t1)``
        (scale 0 = hard failure; the link recovers at ``t1``)."""
        ids = np.atleast_1d(np.asarray(link_ids, np.int32))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_links):
            raise ValueError(
                f"event link ids {ids} out of range for {self.n_links} links")
        return dataclasses.replace(
            self,
            ev_t0=np.concatenate(
                [self.ev_t0, np.full(ids.shape, t0, np.float32)]),
            ev_t1=np.concatenate(
                [self.ev_t1, np.full(ids.shape, t1, np.float32)]),
            ev_link=np.concatenate([self.ev_link, ids]),
            ev_scale=np.concatenate(
                [self.ev_scale, np.full(ids.shape, scale, np.float32)]),
        )

    def with_diurnal(self, period_s: float, amplitude: float,
                     link_ids=None, phase: float = 0.0) -> "LinkSchedule":
        """Add a sinusoidal capacity cycle on ``link_ids`` (default: every
        link): caps ·= 1 + amplitude·sin(2π t / period + phase)."""
        amp = np.zeros((1, self.n_links), np.float32)
        if link_ids is None:
            amp[0, :] = amplitude
        else:
            amp[0, np.asarray(link_ids, np.int64)] = amplitude
        omega = np.full((1, self.n_links), 2.0 * np.pi / period_s, np.float32)
        ph = np.full((1, self.n_links), phase, np.float32)
        return dataclasses.replace(
            self,
            sin_amp=np.concatenate([self.sin_amp, amp]),
            sin_omega=np.concatenate([self.sin_omega, omega]),
            sin_phase=np.concatenate([self.sin_phase, ph]),
        )

    # ---- host-side evaluation (numpy reference / plotting) -----------
    def caps_at(self, base: np.ndarray, t) -> np.ndarray:
        """Evaluate caps(t) in numpy. ``t`` scalar or [T]; returns [L] or
        [T, L]. The tensor evaluation in the simulator must match this."""
        t = np.asarray(t, np.float64)
        scalar = t.ndim == 0
        ts = np.atleast_1d(t)
        caps = np.broadcast_to(np.asarray(base, np.float64)[None, :],
                               (ts.shape[0], self.n_links)).copy()
        if self.sin_amp.shape[0]:
            wave = np.sum(
                self.sin_amp[None] * np.sin(
                    self.sin_omega[None] * ts[:, None, None]
                    + self.sin_phase[None]), axis=1)
            caps *= 1.0 + wave
        # Event activity is decided in float32, exactly like the compiled
        # `_caps_over` path: event times are stored as float32, so deciding
        # `t >= t0` in float64 flips the half-open [t0, t1) boundary for
        # any t0/t1 that float32 rounds upward (e.g. t0 = 0.1 — the f64
        # query 0.1 lands *below* the stored f32 0.10000000149). Comparing
        # at f32 precision keeps t == t0 active and t == t1 inactive on
        # both sides for every representable query time.
        ts32 = ts.astype(np.float32)
        for e in range(self.ev_t0.shape[0]):
            active = (ts32 >= self.ev_t0[e]) & (ts32 < self.ev_t1[e])
            caps[:, int(self.ev_link[e])] *= np.where(
                active, float(self.ev_scale[e]), 1.0)
        caps = np.maximum(caps, 0.0)
        return caps[0] if scalar else caps


# --------------------------------------------------------------------------
# mid-run rerouting
# --------------------------------------------------------------------------
# A link whose composed event multiplier drops below this is treated as
# *failed for routing*: the SDN controller reroutes around hard failures
# (scale 0) and deep brown-outs, but not mild degradations or the smooth
# sinusoid components (a controller does not flap routes on diurnal load).
ROUTE_DOWN_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class RouteSchedule:
    """Precompiled mid-run rerouting: ``R(t)`` as a bank of route states.

    The event schedule partitions time into intervals on which the set of
    active events — hence the set of routing-failed links — is constant.
    Each distinct failed-link combination is one *route state* with its own
    rerouted routing matrix; the number of states is bounded by the number
    of event boundaries (≤ 2·E + 1, typically 2–4), so the whole bank
    precompiles into one ``[S_r, F, L]`` operand the simulator gathers from
    inside the scan — no recompilation, no ``lax.cond``.

    Flows with no surviving path keep their dead base route (they move no
    bytes through a hard-failed link, exactly like today's capacity-only
    failures); everything else takes the shortest surviving path with the
    ECMP core pick as tie-break (see :meth:`Topology.route_avoiding`).
    """

    t0: np.ndarray      # [K] f32 interval start times, t0[0] == 0.0
    state: np.ndarray   # [K] int32 route-state index per interval
    routes: np.ndarray  # [S, F, L] f32 binary routing matrix per state
    down: np.ndarray    # [S, L] bool, links treated as failed per state

    @property
    def n_states(self) -> int:
        return self.routes.shape[0]

    @property
    def n_intervals(self) -> int:
        return self.t0.shape[0]

    @classmethod
    def from_events(cls, topo: "Topology",
                    flows: Sequence[tuple[int, int]],
                    schedule: "LinkSchedule",
                    threshold: float = ROUTE_DOWN_THRESHOLD,
                    ) -> "RouteSchedule":
        """Enumerate reachable route states from ``schedule``'s events."""
        F, L = len(flows), topo.n_links
        pairs = np.asarray(flows, np.int64).reshape(-1, 2)
        base_R = topo.routing_matrix(flows, np.float32)
        t0e = np.asarray(schedule.ev_t0, np.float32)
        t1e = np.asarray(schedule.ev_t1, np.float32)
        bounds = np.concatenate([[0.0], t0e[np.isfinite(t0e)],
                                 t1e[np.isfinite(t1e)]]).astype(np.float32)
        bounds = np.unique(bounds[bounds >= 0.0])
        key_to_state: dict[bytes, int] = {}
        state_of, routes_list, down_list = [], [], []
        for tb in bounds:
            # same f32 half-open [t0, t1) activity rule as caps_at/_caps_over
            active = (tb >= t0e) & (tb < t1e)
            scale = np.ones(L, np.float64)
            for e in np.flatnonzero(active):
                scale[int(schedule.ev_link[e])] *= float(schedule.ev_scale[e])
            dwn = scale < threshold
            key = dwn.tobytes()
            if key not in key_to_state:
                key_to_state[key] = len(routes_list)
                # every flow with a surviving path takes route_avoiding's
                # path; the others keep their dead base route
                R = base_R.copy()
                links, used, ok = topo.path_links(pairs[:, 0], pairs[:, 1],
                                                  dwn)
                R[ok] = 0.0
                used &= ok[:, None]
                R[np.nonzero(used)[0], links[used]] = 1.0
                routes_list.append(R)
                down_list.append(dwn)
            state_of.append(key_to_state[key])
        return cls(
            t0=bounds.astype(np.float32),
            state=np.asarray(state_of, np.int32),
            routes=np.stack(routes_list),
            down=np.stack(down_list),
        )

    # ---- host-side evaluation (numpy reference) ----------------------
    def state_at(self, t) -> int:
        """Route-state index active at time ``t`` (f32 comparison, matching
        the compiled per-tick state stream)."""
        t32 = np.float32(t)
        j = int(np.sum(t32 >= self.t0)) - 1
        return int(self.state[max(j, 0)])

    def routes_at(self, t) -> np.ndarray:
        """Routing matrix [F, L] active at time ``t`` (numpy reference for
        the compiled in-scan gather)."""
        return self.routes[self.state_at(t)]


def link_failure_schedule(topo: "Topology", link_ids, t_fail: float,
                          t_recover: float = np.inf,
                          degrade: float = 0.0) -> LinkSchedule:
    """Mid-run failure (or brown-out, ``0 < degrade < 1``) of the given
    links at ``t_fail``, recovering at ``t_recover``."""
    return LinkSchedule.empty(topo.n_links).with_event(
        link_ids, t_fail, t_recover, degrade)


def diurnal_schedule(topo: "Topology", period_s: float, amplitude: float,
                     kind: "LinkKind | None" = None,
                     phase: float = 0.0) -> LinkSchedule:
    """Sinusoidal capacity cycle over every link (or every link of one
    ``kind``): the in-run version of the quasi-static diurnal sweep."""
    ids = None
    if kind is not None:
        ids = np.flatnonzero(topo.link_kinds == int(kind))
    return LinkSchedule.empty(topo.n_links).with_diurnal(
        period_s, amplitude, link_ids=ids, phase=phase)


def big_switch(n_machines: int, up: float, down: float | None = None) -> Topology:
    """Paper's earlier model: fabric as one big non-blocking switch; only
    machine uplinks/downlinks can bottleneck (§II-B)."""
    down = up if down is None else down
    links: list[Link] = []
    upl = np.zeros(n_machines, dtype=np.int64)
    dnl = np.zeros(n_machines, dtype=np.int64)
    for m in range(n_machines):
        upl[m] = len(links)
        links.append(Link(f"up[m{m}]", LinkKind.UPLINK, up))
        dnl[m] = len(links)
        links.append(Link(f"down[m{m}]", LinkKind.DOWNLINK, down))
    return Topology(
        n_machines=n_machines,
        links=links,
        uplink_idx=upl,
        downlink_idx=dnl,
        rack_of=np.zeros(n_machines, dtype=np.int64),
        rack_to_core_idx=np.zeros((1, 0), dtype=np.int64),
        core_to_rack_idx=np.zeros((0, 1), dtype=np.int64),
        n_cores=0,
    )


def fat_tree(
    n_racks: int = 4,
    machines_per_rack: int = 2,
    n_cores: int = 2,
    up: float = 125.0,
    down: float | None = None,
    internal: float | None = None,
) -> Topology:
    """Fat-tree-like testbed (Fig. 2): with defaults, 8 machines, 8 uplinks,
    8 downlinks, 16 internal links (8 rack-to-core + 8 core-to-rack)."""
    down = up if down is None else down
    internal = up if internal is None else internal
    n_machines = n_racks * machines_per_rack
    links: list[Link] = []
    upl = np.zeros(n_machines, dtype=np.int64)
    dnl = np.zeros(n_machines, dtype=np.int64)
    rack_of = np.repeat(np.arange(n_racks), machines_per_rack)
    for m in range(n_machines):
        upl[m] = len(links)
        links.append(Link(f"up[m{m}]", LinkKind.UPLINK, up))
        dnl[m] = len(links)
        links.append(Link(f"down[m{m}]", LinkKind.DOWNLINK, down))
    r2c = -np.ones((n_racks, n_cores), dtype=np.int64)
    c2r = -np.ones((n_cores, n_racks), dtype=np.int64)
    for r in range(n_racks):
        for c in range(n_cores):
            r2c[r, c] = len(links)
            links.append(Link(f"r{r}->c{c}", LinkKind.INTERNAL, internal))
    for c in range(n_cores):
        for r in range(n_racks):
            c2r[c, r] = len(links)
            links.append(Link(f"c{c}->r{r}", LinkKind.INTERNAL, internal))
    return Topology(
        n_machines=n_machines,
        links=links,
        uplink_idx=upl,
        downlink_idx=dnl,
        rack_of=rack_of,
        rack_to_core_idx=r2c,
        core_to_rack_idx=c2r,
        n_cores=n_cores,
    )


def tpu_pod_fabric(
    n_pods: int,
    chips_per_pod: int,
    *,
    ici_gbps: float,
    dcn_gbps: float,
) -> Topology:
    """Abstract TPU fabric for the collective-flow scheduler: each chip's ICI
    injection modeled as its up/down link; pods joined by DCN 'cores'. The
    caller gives both rates (the JAX package defaults them to a TPU's; the
    port holds no TPU numbers).

    This reuses the paper's fat-tree abstraction: chip<->pod-fabric links are
    up/down links; pod<->DCN links are internal. Capacities in GB/s treated as
    'MB/s × 1e3' — the solvers are unit-agnostic.
    """
    return fat_tree(
        n_racks=n_pods,
        machines_per_rack=chips_per_pod,
        n_cores=max(1, n_pods // 2) if n_pods > 1 else 1,
        up=ici_gbps * 1e3,
        internal=dcn_gbps * 1e3,
    )
