"""The collectives a step issues, and their traffic: the port's
counterpart of the JAX package's ``repro.launch.hlo_stats``.

PyTorch has no compiled HLO to read. A step on a ``DeviceMesh`` issues its
collectives as functional collective ops (``torch.ops._c10d_functional``),
which DTensor calls when it redistributes a tensor, and, for a
shard-to-shard redistribution on a "cuda" mesh, as DTensor's own
``torch.ops._dtensor.shard_dim_alltoall``. :func:`record`
watches them with a ``TorchDispatchMode`` and keeps one
:class:`Collective` per op: its kind (the HLO names: all-gather,
all-reduce, reduce-scatter, all-to-all), its result shapes and dtype as
this rank sees them, the size of its group, and the mesh axis the group
spans (from ``mesh.get_group(dim).group_name``; None for a group over
several mesh dims). It works on meta tensors in a dry world, where the
collectives move nothing. The same mode counts this rank's FLOPs, with
the formulas of ``torch.utils.flop_counter`` applied to the local ops
(DTensor's global ops and the meta ops it runs to propagate shardings
are not counted), so that the count is what one rank computes, as the
JAX package's ``cost_analysis()`` of a partitioned program.

:func:`collective_stats` sums operand bytes per kind with the JAX package's
rules, from each op's result shape and group size g:

    all-reduce / all-to-all / collective-permute: operand == result
    all-gather:     operand = result / g
    reduce-scatter: operand = result × g

On a mesh of device type "cpu" DTensor turns a shard-to-shard
redistribution into an all-gather and a local chunk, since the CPU
backends have no all-to-all; on a "cuda" mesh (a dry world's too) it
issues an all-to-all. Record a step on the mesh type it would run on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# functional collective op -> kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    # DTensor's shard-to-shard redistribution on a non-CPU mesh
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_dtensor")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective op: the counterpart of one HLO collective line."""
    kind: str                                # all-gather | all-reduce | ...
    results: tuple                           # ((dtype, shape), ...) per rank
    group_size: int
    axis: str | None                         # mesh axis of the group
    name: str = ""                           # the op's name

    @property
    def bytes(self) -> int:
        return operand_bytes(self)


def shape_bytes(dtype: torch.dtype, shape) -> int:
    return math.prod(shape) * _DTYPE_BYTES.get(dtype, 4)


def result_bytes(c: Collective) -> int:
    return sum(shape_bytes(d, s) for d, s in c.results)


def operand_bytes(c: Collective) -> int:
    """The op's per-shard operand bytes, from its result and group size."""
    b = result_bytes(c)
    if c.kind == "all-gather":
        return b // max(c.group_size, 1)
    if c.kind == "reduce-scatter":
        return b * c.group_size
    return b


def collective_stats(records) -> dict:
    """Sum operand bytes per collective kind (per-shard operand bytes
    summed over ops), with ``total`` over the kinds and ``count``."""
    out: dict = defaultdict(int)
    count = 0
    for c in records:
        count += 1
        out[c.kind] += operand_bytes(c)
    out["total"] = sum(out[k] for k in COLLECTIVES if k in out)
    out["count"] = count
    return dict(out)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


class Record(list):
    """The collectives of a block (a list of :class:`Collective`), and
    ``flops``, the FLOPs of this rank's ops in it."""
    flops: int = 0


class _Recorder(TorchDispatchMode):
    def __init__(self, groups: dict):
        super().__init__()
        self.groups = groups          # group name -> mesh axis
        self.records = Record()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # let DTensor turn its op into local ops and collectives first
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _NAMESPACES:
            kind = _KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                self._add(kind, func, args, out)
        count = flop_registry.get(func._overloadpacket)
        # DTensor propagates shardings by running ops on fake tensors
        if count is not None and not any(issubclass(t, FakeTensor)
                                         for t in types):
            self.records.flops += count(*args, **kwargs, out_val=out)
        return out

    def _add(self, kind, func, args, out):
        group = args[-1]
        if not isinstance(group, str):
            group = group.group_name
        size = dist.distributed_c10d._resolve_process_group(group).size()
        results = tuple((t.dtype, tuple(t.shape)) for t in _tensors(out))
        self.records.append(Collective(kind, results, size,
                                       self.groups.get(group),
                                       func._overloadpacket.__name__))


@contextlib.contextmanager
def record(mesh=None):
    """Within the block, every functional collective is appended to the
    :class:`Record` this yields, its axis named by ``mesh``'s dims, and the
    block's local FLOPs are added to its ``flops``."""
    groups = {}
    if mesh is not None:
        groups = {mesh.get_group(d).group_name: name
                  for d, name in enumerate(mesh.mesh_dim_names)}
    rec = _Recorder(groups)
    with rec:
        yield rec.records


def by_axis(items, per_kind: bool = False) -> dict:
    """{axis: (ops, bytes)} of collectives or of the flows made of them
    (anything with ``kind``, ``axis`` and ``bytes``; a record's axis is
    None for a group over several mesh dims), keyed by (kind, axis) when
    ``per_kind``."""
    out: dict = {}
    for c in items:
        key = (c.kind, c.axis) if per_kind else c.axis
        n, b = out.get(key, (0, 0))
        out[key] = (n + 1, b + c.bytes)
    return out


def trace_train_step(api, mesh, spec, rules: dict | None = None,
                     optimizer=None):
    """One train step of ``api``'s model on meta tensors on ``mesh`` (a
    dry world's), under ``sharding_policy(mesh, rules)``: parameters
    placed by ``param_shardings``, the batch of ``spec`` by
    ``batch_shardings``. Returns (the collectives it issued, the FLOPs of
    one rank). The kernels' forwards are shape functions on meta and count
    no FLOPs (their backwards, the plain versions' vector-Jacobian
    products, do)."""
    from repro_torch.launch import shardings as S
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    opt = optimizer or AdamW(lr=1e-3)
    with sharding_policy(mesh, rules):
        psh = S.param_shardings(mesh, api, rules)
        model = api.build(S.place_tree(api.abstract_params(), psh),
                          trainable=True)
        specs = api.input_specs(spec)
        bsh = S.batch_shardings(mesh, specs, rules)
        batch = {k: S.place(v, bsh[k]) for k, v in specs.items()}
        step = make_train_step(api, opt)
        state = opt.init(model)
        with record(mesh) as records:
            step(model, state, batch)
    return records, records.flops
