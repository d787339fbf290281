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
JAX package's ``cost_analysis()`` of a partitioned program. On meta
tensors the flash-attention and SSD chunk wrappers launch nothing and run
no product; each calls :func:`count_flops` with its plain version's count
for the same call (the same formulas), so that a record counts the
kernels' forwards and their recomputes as the plain versions would.

The record also keeps ``bytes_accessed``, this rank's memory traffic with
every op unfused (the counterpart of ``cost_analysis()``'s "bytes
accessed"): each local op's input and output bytes, views and
allocations excluded, a kernel's inputs and outputs once; and, per
collective, its call site: the line of the port that asked for it (the
caller of ``shard_as``, or the model or kernel-wrapper line whose op
DTensor redistributed; a redistribution's backward by its forward's site,
marked "backward: ", another backward function's by its autograd node).

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
import sys
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
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
    site: str = ""                           # the port's line that issued it

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
    """The collectives of a block (a list of :class:`Collective`);
    ``flops``, the FLOPs of this rank's ops in it, of which
    ``kernel_flops`` came from :func:`count_flops`; and ``bytes_accessed``,
    their unfused memory traffic."""
    flops: int = 0
    kernel_flops: int = 0
    bytes_accessed: int = 0


# the records open now, innermost last; process-wide, as the sharding
# policy is, since a backward's recomputes may run on autograd's thread
_OPEN: list[Record] = []


def count_flops(n: int, nbytes: int = 0) -> None:
    """Add ``n`` FLOPs, and ``nbytes`` of traffic, to the innermost open
    record (a kernel wrapper's meta call, which runs no product for the
    mode to count); nothing outside a record."""
    if _OPEN:
        _OPEN[-1].flops += n
        _OPEN[-1].kernel_flops += n
        _OPEN[-1].bytes_accessed += nbytes


def tensor_bytes(*tensors) -> int:
    """The bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


# ops that move no bytes of their own: allocations and aliases (views are
# told apart by their schema)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense"}
_PKG = Path(__file__).resolve().parents[1]
# frames that pass a redistribution on rather than ask for it
_RELAYS = {str(_PKG / f) for f in ("launch/comm_stats.py",
                                   "sharding/policy.py", "kernels/local.py")}
# the key of a redistribution's site in its autograd node's metadata
_SITE = "comm_stats.site"


@contextlib.contextmanager
def _sites_of_redistributions():
    """Within the block each ``DTensor.redistribute`` (``shard_as``,
    ``local_map``'s inputs, a replicated loss) writes its site into the
    metadata of its autograd node, which names its backward's collectives."""
    plain = DTensor.redistribute

    def redistribute(self, *args, **kwargs):
        out = plain(self, *args, **kwargs)
        if out.grad_fn is not None:
            out.grad_fn.metadata[_SITE] = _site()
        return out
    DTensor.redistribute = redistribute
    try:
        yield
    finally:
        DTensor.redistribute = plain


def _site() -> str:
    """Where the port asked for the collective: the innermost line of the
    port on the stack outside the policy and this module,
    "models/lm.py:386 (_attn_block)", marked "recompute: " when autograd's
    backward re-runs it (a checkpointed forward); "backward: <node>" for a
    collective of a backward function itself (say a redistribution's
    RedistributeBackward), whose stack holds no line of the model; within
    :func:`record` a redistribution's backward is named by the site of its
    forward."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code.co_name == "_engine_run_backward":
            node = torch._C._current_autograd_node()
            if node is None:
                return "backward: ?"
            return f"backward: {node.metadata.get(_SITE, node.name())}"
        name = code.co_filename
        if name.startswith(str(_PKG)) and name not in _RELAYS:
            site = (f"{Path(name).relative_to(_PKG).as_posix()}:"
                    f"{f.f_lineno} ({code.co_name})")
            if torch._C._current_autograd_node() is not None:
                return f"recompute: {site}"
            return site
        f = f.f_back
    return "?"


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
            return out
        # DTensor propagates shardings by running ops on fake tensors
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.records.flops += count(*args, **kwargs, out_val=out)
        if not (func.is_view
                or func._overloadpacket.__name__ in _NO_TRAFFIC):
            self.records.bytes_accessed += tensor_bytes(
                *(t for t in tree_leaves((args, kwargs, out))
                  if isinstance(t, torch.Tensor)))
        return out

    def _add(self, kind, func, args, out):
        group = args[-1]
        if not isinstance(group, str):
            group = group.group_name
        size = dist.distributed_c10d._resolve_process_group(group).size()
        results = tuple((t.dtype, tuple(t.shape)) for t in _tensors(out))
        self.records.append(Collective(kind, results, size,
                                       self.groups.get(group),
                                       func._overloadpacket.__name__,
                                       _site()))


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
    _OPEN.append(rec.records)
    try:
        with rec, _sites_of_redistributions():
            yield rec.records
    finally:
        _OPEN.remove(rec.records)


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


def by_site(records, top: int | None = None) -> list:
    """The call sites of a record's collectives by operand bytes, most
    first (the first ``top``): [site, ops, bytes, kinds]."""
    tally: dict = {}
    for c in records:
        n, b, kinds = tally.get(c.site, (0, 0, set()))
        tally[c.site] = (n + 1, b + c.bytes, kinds | {c.kind})
    rows = sorted(tally.items(), key=lambda kv: -kv[1][1])[:top]
    return [[site, n, b, sorted(kinds)] for site, (n, b, kinds) in rows]


def trace_train_step(api, mesh, spec, rules: dict | None = None,
                     optimizer=None, constrain_grads: bool = False,
                     watch=None):
    """One train step of ``api``'s model on meta tensors on ``mesh`` (a
    dry world's), under ``sharding_policy(mesh, rules)``: parameters
    placed by ``param_shardings``, the batch of ``spec`` by
    ``batch_shardings``; ``constrain_grads`` as ``make_train_step``'s.
    ``watch({"params": model, "opt": state, "batch": batch})``, if given,
    returns a context entered around the step (a memory tracker).
    Returns (the collectives it issued, the FLOPs of one rank). The
    kernels' forwards are shape functions on meta that count their plain
    versions' FLOPs (:func:`count_flops`); their backwards, the plain
    versions' vector-Jacobian products, run and are counted."""
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
        step = make_train_step(api, opt, constrain_grads=constrain_grads)
        state = opt.init(model)
        args = {"params": model, "opt": state, "batch": batch}
        with record(mesh) as records, (
                watch(args) if watch else contextlib.nullcontext()):
            step(model, state, batch)
    return records, records.flops
