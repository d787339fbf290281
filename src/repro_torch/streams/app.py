"""Stream-application model (paper §II-A): logical DAG of operators,
parallelized into instances, with grouping policies (shuffle / key-based /
global / all) determining the inter-instance flow graph.

The compiled form is a set of static matrices consumed by the fluid
simulator (`repro_torch.streams.simulator`) and by the allocator's routing
program. Everything here is plain python/numpy — it runs once per topology. A copy
of ``repro.streams.app``, held to exact equality by the tests.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Grouping(enum.Enum):
    SHUFFLE = "shuffle"     # round-robin: even split across dst instances
    KEY = "key"             # hash-partition: skewed split (Zipf over keys)
    GLOBAL = "global"       # all tuples to dst instance 0
    ALL = "all"             # broadcast: full stream to every dst instance


@dataclasses.dataclass(frozen=True)
class Operator:
    """A logical operator (vertex). Rates in MB/s of *input* consumed.

    selectivity: MB emitted per MB consumed (source ops: ignored).
    gen_rate:    MB/s generated externally (only source ops, else 0).
    join:        m:1 lock-step join — processing advances at the rate of the
                 slowest *proportional* input (the paper's stall mechanism).
    """

    name: str
    parallelism: int = 1
    proc_rate: float = np.inf
    selectivity: float = 1.0
    gen_rate: float = 0.0
    join: bool = False

    @property
    def is_source(self) -> bool:
        return self.gen_rate > 0.0


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    grouping: Grouping = Grouping.SHUFFLE
    weight: float = 1.0      # fraction of src output onto this logical edge
    key_skew: float = 0.0    # Zipf exponent for KEY grouping (0 = uniform)
    # lock-step joins: semantic share of the dst's joined input taken from
    # this edge (e.g. each truck event joins the LATEST congestion record —
    # the congestion stream is oversampled). None => proportional to volume.
    join_share: float | None = None
    # excess tuples beyond the join's working window are discarded at the
    # receiver (stale data); their bandwidth is *wasted* — the paper's TCP
    # inefficiency mechanism for TI.
    droppable: bool = False


@dataclasses.dataclass
class StreamApp:
    """Logical topology (e.g. Fig. 1a / Fig. 7)."""

    name: str
    operators: list[Operator]
    edges: list[Edge]
    tuples_per_mb: float = 2000.0   # avg tuple size ⇒ MB → tuples conversion

    def op(self, name: str) -> Operator:
        return next(o for o in self.operators if o.name == name)

    def validate(self) -> None:
        names = [o.name for o in self.operators]
        assert len(set(names)) == len(names), "duplicate operator names"
        for e in self.edges:
            assert e.src in names and e.dst in names, f"dangling edge {e}"
        out_w: dict[str, float] = {}
        for e in self.edges:
            out_w[e.src] = out_w.get(e.src, 0.0) + e.weight
        for k, w in out_w.items():
            assert w <= 1.0 + 1e-6, f"{k} emits {w} > 1 of its output"


@dataclasses.dataclass
class InstanceGraph:
    """Parallelized topology: one node per operator instance, one flow per
    communicating instance pair (paper §II-C)."""

    app: StreamApp
    op_of_inst: np.ndarray           # [I] operator index
    inst_names: list[str]
    # flows
    src_of_flow: np.ndarray          # [F] instance index
    dst_of_flow: np.ndarray          # [F]
    edge_of_flow: np.ndarray         # [F] logical edge index
    w_out: np.ndarray                # [I, F] fraction of inst output on flow
    # instance attributes (expanded from operators)
    proc_rate: np.ndarray            # [I]
    selectivity: np.ndarray          # [I]
    gen_rate: np.ndarray             # [I]
    is_join: np.ndarray              # [I] bool
    is_sink: np.ndarray              # [I] bool

    @property
    def n_instances(self) -> int:
        return len(self.op_of_inst)

    @property
    def n_flows(self) -> int:
        return len(self.src_of_flow)

    def in_matrix(self) -> np.ndarray:
        """M[i, f] = 1 iff flow f terminates at instance i."""
        M = np.zeros((self.n_instances, self.n_flows))
        M[self.dst_of_flow, np.arange(self.n_flows)] = 1.0
        return M

    def flow_pairs(self, machine_of_inst: np.ndarray) -> list[tuple[int, int]]:
        """(src machine, dst machine) per flow, given a placement."""
        return [
            (int(machine_of_inst[s]), int(machine_of_inst[d]))
            for s, d in zip(self.src_of_flow, self.dst_of_flow)
        ]


def _split_weights(grouping: Grouping, n_dst: int, skew: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Fraction of the edge's traffic received by each dst instance."""
    if grouping is Grouping.SHUFFLE or n_dst == 1:
        w = np.full(n_dst, 1.0 / n_dst)
    elif grouping is Grouping.GLOBAL:
        w = np.zeros(n_dst)
        w[0] = 1.0
    elif grouping is Grouping.ALL:
        w = np.ones(n_dst)  # broadcast: each dst gets the FULL stream
    elif grouping is Grouping.KEY:
        # hash partitioning roughly even-partitions the key space, but skewed
        # key popularity (heavy tails) imbalances bytes (paper §II-A.3b)
        ranks = np.arange(1, n_dst + 1, dtype=np.float64)
        w = ranks ** (-skew) if skew > 0 else np.ones(n_dst)
        rng.shuffle(w)
        w = w / w.sum()
    else:  # pragma: no cover
        raise ValueError(grouping)
    return w


def parallelize(app: StreamApp, seed: int = 0) -> InstanceGraph:
    """Expand the logical DAG into the instance-level flow graph (Fig. 1b)."""
    app.validate()
    rng = np.random.default_rng(seed)
    op_index = {o.name: k for k, o in enumerate(app.operators)}
    inst_of_op: dict[str, list[int]] = {}
    op_of_inst: list[int] = []
    names: list[str] = []
    for o in app.operators:
        ids = []
        for r in range(o.parallelism):
            ids.append(len(op_of_inst))
            op_of_inst.append(op_index[o.name])
            names.append(f"{o.name}_{r + 1}")
        inst_of_op[o.name] = ids

    srcs, dsts, fracs, eids = [], [], [], []
    for ei, e in enumerate(app.edges):
        s_ids = inst_of_op[e.src]
        d_ids = inst_of_op[e.dst]
        w_dst = _split_weights(e.grouping, len(d_ids), e.key_skew, rng)
        for si in s_ids:
            for dj, wd in zip(d_ids, w_dst):
                if wd <= 0.0:
                    continue
                srcs.append(si)
                dsts.append(dj)
                fracs.append(e.weight * wd)
                eids.append(ei)

    I, F = len(op_of_inst), len(srcs)
    w_out = np.zeros((I, F))
    w_out[np.array(srcs), np.arange(F)] = np.array(fracs)

    ops = app.operators
    has_out = {e.src for e in app.edges}
    return InstanceGraph(
        app=app,
        op_of_inst=np.array(op_of_inst),
        inst_names=names,
        src_of_flow=np.array(srcs, dtype=np.int64),
        dst_of_flow=np.array(dsts, dtype=np.int64),
        edge_of_flow=np.array(eids, dtype=np.int64),
        w_out=w_out,
        proc_rate=np.array([ops[k].proc_rate for k in op_of_inst]),
        selectivity=np.array([ops[k].selectivity for k in op_of_inst]),
        gen_rate=np.array(
            [ops[k].gen_rate / ops[k].parallelism for k in op_of_inst]
        ),
        is_join=np.array([ops[k].join for k in op_of_inst]),
        is_sink=np.array(
            [ops[k].name not in has_out for k in op_of_inst]
        ),
    )


def source_sink_paths(graph: InstanceGraph, max_paths: int = 64) -> np.ndarray:
    """Binary masks [P, F]: flows along each source→sink instance path
    (used for the end-to-end latency estimate)."""
    I = graph.n_instances
    out_flows: list[list[int]] = [[] for _ in range(I)]
    for f, s in enumerate(graph.src_of_flow):
        out_flows[int(s)].append(f)
    paths: list[list[int]] = []

    def dfs(i: int, acc: list[int]):
        if len(paths) >= max_paths:
            return
        if graph.is_sink[i]:
            paths.append(list(acc))
            return
        for f in out_flows[i]:
            dfs(int(graph.dst_of_flow[f]), acc + [f])

    for i in range(I):
        if graph.gen_rate[i] > 0:
            dfs(i, [])
    P = np.zeros((max(len(paths), 1), graph.n_flows))
    for p, fl in enumerate(paths):
        P[p, fl] = 1.0
    return P
