"""Cross-layer collective-flow scheduler — the paper's technique applied to
the training fabric, after the JAX package's ``repro.core.scheduler``.

The paper allocates link bandwidth among a stream app's flows using
application-layer flow state. Here the "application" is the training step:
flows are the step's collectives (DP reduce-scatters, TP all-gathers, EP
all-to-alls, inter-node pod syncs), links are mesh-axis fabrics, and flow
state comes from the step's dataflow (gradient buckets *fork* onto the DP
axis as they become ready back-to-front; EP combines *join* on expert
outputs). The allocator's rate vector is enforced by *schedule shaping*:
issue order, chunking, and overlap windows for bucketed collectives.

The flows come from :mod:`repro_torch.launch.comm_stats`' record of the
collectives a step issues (the JAX package reads them from compiled HLO),
and the link rates are the H100's (:mod:`repro_torch.launch.mesh`): NVLink
within a node for "data" and "model", the per-GPU inter-node rate for
"pod".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.allocator import OnlineAllocator
from repro_torch.core.flowstate import FlowState
from repro_torch.launch.mesh import INTER_NODE_BW, NVLINK_BW
from repro_torch.net.topology import LinkKind


@dataclasses.dataclass
class CollectiveFlow:
    name: str
    kind: str            # all-reduce | all-gather | ...
    bytes: float         # per-shard operand bytes
    axis: str            # mesh axis whose links it rides ("data"/"model"/"pod")
    phase: str = "grad"  # grad | weight | activation


# link rate per mesh axis, GB/s one way (H100 SXM5, NVLink 4 / NDR per GPU)
_AXIS_BW_GBPS = {"model": NVLINK_BW / 1e9, "data": NVLINK_BW / 1e9,
                 "pod": INTER_NODE_BW / 1e9}

_REDUCING = ("all-reduce", "reduce-scatter")


def _size_rule(axes: list[str], mesh_axes: dict[str, int], gsize: int) -> str:
    """The JAX package's axis of a group known by its size alone: the axis
    of that size (the minor one if several), else the last axis."""
    cands = [a for a in axes if mesh_axes[a] == gsize]
    return cands[-1] if cands else axes[-1]


def extract_flows(records, mesh_axes: dict[str, int]) -> list[CollectiveFlow]:
    """One flow per recorded collective (``comm_stats.record``), on the mesh
    axis of its group; a group over several mesh dims goes by its size.
    Reducing collectives are gradient flows, the others activations."""
    axes = list(mesh_axes)
    flows: list[CollectiveFlow] = []
    for i, c in enumerate(records):
        axis = c.axis if c.axis in mesh_axes else _size_rule(
            axes, mesh_axes, c.group_size)
        flows.append(CollectiveFlow(
            name=f"{c.name or c.kind}.{i}", kind=c.kind,
            bytes=float(c.bytes), axis=axis,
            phase="grad" if c.kind in _REDUCING else "activation"))
    return flows


@dataclasses.dataclass
class CommSchedule:
    order: list[int]          # flow indices, highest urgency first
    rates: np.ndarray         # allocated share of axis bandwidth [F]
    chunks: list[int]         # chunk count per flow (overlap granularity)
    est_exposed_s: float      # comm time NOT hidden behind compute
    est_total_comm_s: float


def link_problem(flows: list[CollectiveFlow], mesh_axes: dict[str, int],
                 backlog_bytes: np.ndarray | None = None):
    """(R [F, L], capacities [L] B/s, kinds [L], bytes [F], backlog [F]):
    each mesh axis a link, each flow on its axis's link."""
    axes = list(mesh_axes)
    R = np.zeros((len(flows), len(axes)))
    for i, f in enumerate(flows):
        R[i, axes.index(f.axis)] = 1.0
    caps = np.array([_AXIS_BW_GBPS.get(a, NVLINK_BW / 1e9) * 1e9
                     for a in axes])
    kinds = np.array([int(LinkKind.UPLINK)] * len(axes))
    mb = np.array([f.bytes for f in flows])
    backlog = mb if backlog_bytes is None else backlog_bytes
    return R, caps, kinds, mb, backlog


def flow_state(mb: np.ndarray, backlog: np.ndarray, device) -> FlowState:
    """Sender backlog = bytes ready to ship; one interval moved ``mb``."""
    F = len(mb)
    z = torch.zeros(F, dtype=torch.float32, device=device)
    return FlowState(
        ls_t=z, lr_t=z,
        v=torch.as_tensor(mb, dtype=torch.float32, device=device),
        ls_t1=torch.as_tensor(backlog, dtype=torch.float32, device=device),
        lr_t1=z)


def plan_schedule(
    flows: list[CollectiveFlow],
    mesh_axes: dict[str, int],
    step_compute_s: float,
    backlog_bytes: np.ndarray | None = None,
    min_chunk_bytes: float = 4e6,
    device=None,
) -> CommSchedule:
    """Run the paper's allocator over the collective flows, on ``device``
    (the card unless the caller asks for another).

    Each mesh axis is a link pair (fork onto the axis = uplink; join from
    the axis = downlink). Flow state: sender backlog = bytes ready to ship
    (gradient buckets accumulate back-to-front), receiver drain = the
    consumer's compute rate. The eq.(3)/(4) solves yield bandwidth shares;
    chunking spreads each flow across the overlap window ∝ its share.
    """
    F = len(flows)
    if F == 0:
        return CommSchedule([], np.zeros(0), [], 0.0, 0.0)
    axes = list(mesh_axes)
    R, caps, kinds, mb, backlog = link_problem(flows, mesh_axes,
                                               backlog_bytes)
    alloc = OnlineAllocator(R, caps, kinds, dt=max(step_compute_s, 1e-3),
                            device=device)
    rates = alloc(flow_state(mb, backlog, alloc.program.R.device))
    rates = rates.cpu().numpy()
    # urgency order: shortest remaining-transfer-time first (paper's min-max
    # objective ranks flows by w_f/x_f equalization — ties → largest first)
    ttime = backlog / np.maximum(rates, 1e-9)
    order = list(np.argsort(-ttime))
    chunks = [max(1, int(np.ceil(f.bytes / min_chunk_bytes))) for f in flows]

    per_axis_bytes = {a: sum(f.bytes for f in flows if f.axis == a)
                      for a in axes}
    comm_s = sum(b / (_AXIS_BW_GBPS[a] * 1e9)
                 for a, b in per_axis_bytes.items() if a in _AXIS_BW_GBPS)
    # overlap model: chunked flows hide behind compute except the last chunk
    # per axis + any comm beyond the compute window
    hidden = min(step_compute_s, comm_s)
    exposed = comm_s - hidden + sum(
        min_chunk_bytes / (_AXIS_BW_GBPS[f.axis] * 1e9)
        for f in flows if f.axis in _AXIS_BW_GBPS) / max(F, 1)
    return CommSchedule(order=order, rates=rates, chunks=chunks,
                        est_exposed_s=float(exposed),
                        est_total_comm_s=float(comm_s))
