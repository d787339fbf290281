"""The benchmark's own description of a scenario, drawn from a configuration,
a traffic mix and a seed.

A frozen copy of what a scenario is made of: the stream app's operators and
edges (written out in the configuration file), the fabric and its link
numbering, the round-robin placement, and the seeded draws (each scenario's
key-skew permutation, uplink capacity, failed links and failure window, or
capacity cycle). Both sides are handed the same description:
``program.py`` builds the port's objects from it through the port's own
builders, and ``reference/sim.py`` works out flows, routes, queues and rates
from it again. Later changes to the port's builders do not move it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

UPLINK, DOWNLINK, INTERNAL = 0, 1, 2
ROUTE_DOWN = 0.5          # a link scaled below this is routed around


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One simulation: app, fabric, skew draw and capacity schedule."""

    app: str                  # key of the configuration's ``apps``
    fabric: dict              # kind and sizes, with this scenario's capacities
    skew_seed: int            # seed of the key-grouped edges' permutation
    failed: tuple = ()        # link ids scaled during [t_fail, t_recover)
    t_fail: float = float("inf")
    t_recover: float = float("inf")
    scale: float = 1.0
    reroute: bool = False
    cycle: tuple = ()         # (period s, amplitude, phase rad) on every link

    @property
    def kind(self) -> str:
        return "fail" if self.failed else "diurnal" if self.cycle else "static"


@dataclasses.dataclass(frozen=True)
class Fabric:
    """The fabric's links in the port's numbering: per machine an uplink
    then a downlink, then (fat tree) rack-to-core links rack-major, then
    core-to-rack links core-major."""

    kinds: np.ndarray        # [L]
    caps: np.ndarray         # [L] MB/s
    up: np.ndarray           # [M] link id
    down: np.ndarray         # [M]
    rack_of: np.ndarray      # [M]
    r2c: np.ndarray          # [racks, cores]
    c2r: np.ndarray          # [cores, racks]

    @property
    def n_links(self) -> int:
        return int(self.kinds.shape[0])

    @property
    def n_machines(self) -> int:
        return int(self.up.shape[0])

    @property
    def n_cores(self) -> int:
        return int(self.r2c.shape[1])

    def routes(self, ms: np.ndarray, md: np.ndarray, down=None) -> np.ndarray:
        """[F, 4] link ids of the flows from machines ``ms`` to ``md``
        (``n_links`` pads a slot): uplink, then for a flow between racks the
        ECMP core ``(ms + md) % cores``'s two links, then the downlink; none
        for a flow that stays on its machine. With ``down`` ([L] bool) a
        flow between racks takes the first core, in cyclic order from its
        ECMP core, whose two links both survive; a flow with no surviving
        path, or whose own uplink or downlink is down, keeps its route."""
        L, C = self.n_links, self.n_cores
        r = np.full((ms.size, 4), L, np.int64)
        net = ms != md
        cross = net & (self.rack_of[ms] != self.rack_of[md]) & (C > 0)
        r[net, 0] = self.up[ms[net]]
        r[net & ~cross, 1] = self.down[md[net & ~cross]]
        rs, rd = self.rack_of[ms[cross]], self.rack_of[md[cross]]
        c = c0 = (ms[cross] + md[cross]) % max(C, 1)
        if down is not None and cross.any():
            cand = (c0[:, None] + np.arange(C)[None, :]) % C
            alive = ~(down[self.r2c[rs[:, None], cand]]
                      | down[self.c2r[cand, rd[:, None]]])
            ends_up = ~(down[self.up[ms[cross]]] | down[self.down[md[cross]]])
            ok = alive.any(1) & ends_up
            c = np.where(ok, cand[np.arange(c0.size), np.argmax(alive, 1)], c0)
        r[cross, 1] = self.r2c[rs, c]
        r[cross, 2] = self.c2r[c, rd]
        r[cross, 3] = self.down[md[cross]]
        return r


def fabric_of(spec: dict) -> Fabric:
    """A fat tree (``n_racks`` × ``machines_per_rack`` machines, ``n_cores``
    cores) or one big switch (``n_machines``; no internal links)."""
    if spec["kind"] == "big_switch":
        n_racks, per_rack, C = 1, spec["n_machines"], 0
    elif spec["kind"] == "fat_tree":
        n_racks, per_rack, C = (spec["n_racks"], spec["machines_per_rack"],
                                spec["n_cores"])
    else:
        raise ValueError(f"unknown fabric {spec['kind']!r}")
    M = n_racks * per_rack
    up = np.arange(M) * 2
    kinds = [UPLINK, DOWNLINK] * M + [INTERNAL] * (2 * n_racks * C)
    caps = [spec["up"], spec["down"]] * M + [spec.get("internal", 0.0)] * (
        2 * n_racks * C)
    r2c = 2 * M + np.arange(n_racks * C).reshape(n_racks, C)
    c2r = 2 * M + n_racks * C + np.arange(C * n_racks).reshape(C, n_racks)
    return Fabric(np.array(kinds), np.array(caps, np.float64), up, up + 1,
                  np.repeat(np.arange(n_racks), per_rack), r2c, c2r)


def split_weights(grouping: str, n_dst: int, skew: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Share of an edge's traffic each destination instance receives: even
    (shuffle), all to the first (global), the whole stream to each (all),
    or Zipf weights over the destinations in a seeded order (key)."""
    if grouping == "shuffle" or n_dst == 1:
        return np.full(n_dst, 1.0 / n_dst)
    if grouping == "global":
        w = np.zeros(n_dst)
        w[0] = 1.0
        return w
    if grouping == "all":
        return np.ones(n_dst)
    if grouping != "key":
        raise ValueError(f"unknown grouping {grouping!r}")
    ranks = np.arange(1, n_dst + 1, dtype=np.float64)
    w = ranks ** (-skew) if skew > 0 else np.ones(n_dst)
    rng.shuffle(w)
    return w / w.sum()


def flows(app: dict, skew_seed: int):
    """The app's instances and flows: per instance its operator index; per
    flow its source and destination instance, its share of the source's
    output and its edge. Key-grouped edges draw their Zipf order from the
    skew seed, edge by edge."""
    ops, edges = app["operators"], app["edges"]
    rng = np.random.default_rng(skew_seed)
    first, op_of_inst = {}, []
    for k, o in enumerate(ops):
        first[o["name"]] = len(op_of_inst)
        op_of_inst += [k] * int(o["parallelism"])
    par = {o["name"]: int(o["parallelism"]) for o in ops}
    src, dst, frac, eid = [], [], [], []
    for e_i, e in enumerate(edges):
        wd = split_weights(e["grouping"], par[e["dst"]], e["key_skew"], rng)
        for si in range(par[e["src"]]):
            for dj in range(par[e["dst"]]):
                if wd[dj] > 0.0:
                    src.append(first[e["src"]] + si)
                    dst.append(first[e["dst"]] + dj)
                    frac.append(e["weight"] * wd[dj])
                    eid.append(e_i)
    return (np.array(op_of_inst), np.array(src, np.int64),
            np.array(dst, np.int64), np.array(frac), np.array(eid, np.int64))


def machines(n_inst: int, n_machines: int) -> np.ndarray:
    """Round-robin placement: instance i on machine i mod machines."""
    return np.arange(n_inst) % n_machines


def _uniform(rng, lo_hi) -> float:
    return float(rng.uniform(*lo_hi))


def draw(config: dict, traffic: dict, seed: int) -> list[Scenario]:
    """The cell's ``traffic["scenarios"]`` scenarios. Scenario k takes the
    k-th combination of the traffic's ``apps`` (fastest), the
    configuration's uplink capacities, and the traffic's ``schedules``
    (slowest), each cycled; the seed draws every scenario's skew permutation
    (or one shared by all, ``shared_skew``), failed links, failure window
    and depth, and capacity cycle. The same seed gives the same scenarios,
    and any seed the same sizes and kinds."""
    rng = np.random.default_rng(int(seed))
    apps, scheds = traffic["apps"], traffic["schedules"]
    ups = config["uplink_mb_s"]
    shared = int(rng.integers(0, 2**31 - 1)) if traffic.get("shared_skew") else None
    out = []
    for k in range(int(traffic["scenarios"])):
        app = apps[k % len(apps)]
        up = float(ups[(k // len(apps)) % len(ups)])
        kind = scheds[(k // (len(apps) * len(ups))) % len(scheds)]
        fab = dict(config["fabric"], up=up,
                   down=up * config.get("downlink_per_uplink", 1.0))
        if fab["kind"] == "fat_tree":
            fab["internal"] = up * config["internal_per_uplink"]
        skew = shared if shared is not None else int(rng.integers(0, 2**31 - 1))
        kw = {}
        if kind == "fail":
            f = traffic["fail"]
            kinds = fabric_of(fab).kinds
            ids = (np.flatnonzero(kinds == INTERNAL) if f["links"] == "internal"
                   else np.arange(kinds.size))
            failed = tuple(int(i) for i in np.sort(
                rng.choice(ids, size=int(f["count"]), replace=False)))
            t_fail = _uniform(rng, f["t_fail"])
            kw = dict(failed=failed, t_fail=t_fail,
                      t_recover=t_fail + _uniform(rng, f["duration"]),
                      scale=_uniform(rng, f["scale"]),
                      reroute=bool(f["reroute"]))
        elif kind == "diurnal":
            d = traffic["diurnal"]
            kw = dict(cycle=(_uniform(rng, d["period_s"]),
                             _uniform(rng, d["amplitude"]),
                             _uniform(rng, d["phase"])))
        elif kind != "static":
            raise ValueError(f"unknown schedule {kind!r}")
        out.append(Scenario(app, fab, skew, **kw))
    return out
