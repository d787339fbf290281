"""Logical-axis sharding policy (MaxText-style rules), after the JAX
package's ``repro.sharding.policy``.

Model code annotates tensors with *logical* axis names; the active policy
maps them to mesh axes. Outside a policy the annotations are no-ops, so the
same model runs unsharded on one device and as DTensors on a
``DeviceMesh``.

A spec is a tuple with one entry per tensor dimension: a mesh-axis name, a
tuple of names, or None (the JAX package's ``PartitionSpec``).
:class:`NamedSharding` pairs it with a mesh and turns it into DTensor
placements: ``Shard(d)`` on each mesh dim that tensor dim ``d`` names,
``Replicate()`` on the others. A tuple entry shards one tensor dim over
several mesh dims, the first named the major one, as DTensor orders them
by mesh dim.

Mesh axes:
  pod    — the axis between nodes (multi-node only)
  data   — DP batch + FSDP weight sharding
  model  — TP / EP / SP

Default rules:
  batch      -> ("pod", "data")       activations' batch dim
  embed      -> "data"  (weights: FSDP)   / None (activations)
  heads      -> "model"               attention heads (TP)
  kv_heads   -> "model" when divisible, else None
  mlp        -> "model"               FFN hidden (TP)
  experts    -> "model"               MoE expert dim (EP)
  vocab      -> "model"               embedding/unembedding (TP)
  seq        -> None (train)  / "model" (long-context KV: SP)
  layers     -> None                  stacked-layer dim
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.local import as_dtensor

# The active (mesh, resolved rules), or None. Process-wide, not per thread:
# autograd runs a CUDA backward (and the recomputes of checkpointed layers)
# on its own worker thread, which must see the policy the forward saw.
_CTX = None


DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "embed": "data",
    "embed_act": None,
    "heads": "model",
    "kv_heads": "model",
    "q_group": None,
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": "data",
    "expert_mlp": None,
    "vocab": "model",
    "seq": None,
    "act_seq": "model",   # sequence-parallel residual stream (train)
    "kv_seq": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "inner": "model",
}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _entry_size(mesh, entry) -> int:
    sizes = mesh_axes(mesh)
    size = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        size *= sizes[a]
    return size


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The DTensor placements of :attr:`spec`, one per mesh dim. A mesh
        dim of size 1 replicates (sharding over one rank is the same
        layout, and DTensor's view ops refuse a size-1 dim sharded)."""
        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} names mesh axes out of "
                                 f"the mesh's order {tuple(names)}")
            for m in dims:
                if self.mesh.shape[m] > 1:
                    out[m] = Shard(d)
        return tuple(out)


@contextlib.contextmanager
def _implicit():
    """DTensor takes plain tensors as replicated in this thread (the flag of
    its ``implicit_replication``, which is per thread, which autograd
    carries to the thread that runs a backward, and which that context
    clears on exit instead of restoring)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def bound(fn):
    """``fn`` run, whatever thread calls it, under the policy active now and
    with plain tensors taken as replicated: for functions that autograd
    runs again in its backward (``torch.utils.checkpoint``). ``fn`` itself
    outside a policy."""
    ctx = _CTX
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _CTX
        prev, _CTX = _CTX, ctx
        try:
            with _implicit():
                return fn(*args, **kwargs)
        finally:
            _CTX = prev
    return run


@contextlib.contextmanager
def sharding_policy(mesh, rules: dict | None = None):
    """Activate a mesh + logical rules for model annotations. Within it a
    plain tensor that meets a DTensor in an op counts as replicated (the
    same on every rank), as an unsharded array does in SPMD code."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    # drop mesh axes that don't exist (e.g. "pod" on a single-node mesh)
    axes = set(mesh.mesh_dim_names)

    def resolve(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in axes else None
        got = tuple(a for a in v if a in axes)
        return got if got else None

    resolved = {k: resolve(v) for k, v in merged.items()}
    global _CTX
    prev, _CTX = _CTX, (mesh, resolved)
    try:
        with _implicit():
            yield
    finally:
        _CTX = prev


def active_rules() -> dict | None:
    """The active policy's resolved rules (None outside a policy)."""
    return None if _CTX is None else dict(_CTX[1])


def spec_for(*logical: str | None) -> tuple:
    """The spec of a tuple of logical axis names (None = replicated)."""
    ctx = _CTX
    if ctx is None:
        return (None,) * len(logical)
    _, rules = ctx
    out, used = [], set()
    for name in logical:
        r = None if name is None else rules.get(name)
        if isinstance(r, tuple):
            r = tuple(a for a in r if a not in used) or None
        if isinstance(r, str) and r in used:
            r = None
        if r is not None:
            used.update(r if isinstance(r, tuple) else (r,))
        out.append(r)
    return tuple(out)


def shard_count(logical: str) -> int:
    """Number of shards the active policy assigns to a logical axis
    (1 outside a policy)."""
    ctx = _CTX
    if ctx is None:
        return 1
    mesh, rules = ctx
    r = rules.get(logical)
    return 1 if r is None else _entry_size(mesh, r)


def _guard(mesh, shape, spec) -> tuple:
    """Replicate the spec entries whose mesh size does not divide the dim."""
    return tuple(None if s is None or dim % _entry_size(mesh, s) else s
                 for dim, s in zip(shape, spec))


def shard_as(x, *logical: str | None):
    """Annotate activation ``x`` with logical axes: ``x`` itself outside a
    policy; inside one, ``x`` as a DTensor redistributed to the guarded
    spec (its values unchanged)."""
    ctx = _CTX
    if ctx is None:
        return x
    mesh, _ = ctx
    x = as_dtensor(x, mesh)
    want = NamedSharding(mesh, _guard(mesh, x.shape,
                                      spec_for(*logical))).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def placements_on(mesh, shape, *logical: str | None) -> tuple:
    """The guarded placements of a tensor of ``shape`` with ``logical``
    axes on ``mesh``, by the active policy's rules (replicated outside a
    policy)."""
    return NamedSharding(mesh, _guard(mesh, shape,
                                      spec_for(*logical))).placements


def named_sharding(mesh, *logical: str | None) -> NamedSharding:
    with sharding_policy(mesh):
        spec = spec_for(*logical)
    return NamedSharding(mesh, spec)


def param_sharding(mesh, path: tuple, shape: tuple[int, ...],
                   rules: dict | None = None) -> NamedSharding:
    """Sharding for a parameter given its logical axes annotation."""
    with sharding_policy(mesh, rules):
        spec = _guard(mesh, shape, spec_for(*path))
    return NamedSharding(mesh, spec)
