"""Checkpointing: atomic, async, integrity-checked, reshard-on-restore;
after the JAX package's ``repro.train.checkpoint``, on the same layout.

Layout (one directory per step):
    <dir>/ckpt_<step>/arrays.npz     flattened param/opt state
    <dir>/ckpt_<step>/manifest.json  step, keys, shapes, dtypes, sha256s

Guarantees:
  * atomicity — written to ``.tmp`` then os.rename (a crash never leaves a
    half-readable checkpoint);
  * async — ``save_async`` snapshots to host memory synchronously and
    writes on a background thread, so the train loop is not blocked;
  * integrity — a per-array sha256 is recorded and verified on restore;
  * elasticity — ``restore(like, shardings=...)`` places each array on a
    mesh with the given placements (``distribute_tensor``; the mesh may
    have another rank count than the writer's), as the JAX package's
    target shardings do; a leaf without a sharding goes to ``device`` (the
    CUDA card unless the caller asks for another);
  * retention — the newest ``keep`` checkpoints are kept.

Arrays are written whole, on one host, by one writer, as the JAX package
writes them. A DTensor leaf (a state on a ``DeviceMesh``) is gathered whole
by ``full_tensor()`` before its host copy: a collective, which every rank
of the mesh takes, in ``save`` and in ``save_async``'s synchronous
snapshot, before any writer thread starts. In a world of more than one
rank only rank 0 writes, renames and prunes old checkpoints, and every
rank waits at a barrier before ``save`` returns (``save_async``: before
``wait`` returns) and before ``restore`` reads, so that no rank reads a
checkpoint before it is whole. Without a world, or in a world of one rank,
nothing waits.

A state is a nest of dicts, lists, tuples, NamedTuples (``AdamState``),
models (``nn.Module``: their parameters by name) and tensors; keys join the
path with "/" (``params/groups/0/3/mamba/in_proj``, ``opt/m/embed``).
bfloat16 tensors are stored as float32 (numpy has no bfloat16) and cast
back to the dtype of ``like`` on restore.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.launch.shardings import flatten
from repro_torch.models.lm import rebuild

SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree) -> list[tuple[str, Any]]:
    """(key, child) pairs of one level of a state."""
    if isinstance(tree, nn.Module):
        return [(n.replace(".", SEP), p)
                for n, p in tree.named_parameters()]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(f"not a state node: {type(tree).__name__}")


def _is_leaf(x) -> bool:
    return not isinstance(x, (nn.Module, dict, list, tuple))


def _host(x) -> np.ndarray:
    if isinstance(x, DTensor):
        x = x.full_tensor()         # a collective: every rank takes it
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if _is_leaf(tree):
        return {prefix: _host(tree)}
    out = {}
    for k, v in _items(tree):
        out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _sharding_items(sh, like) -> dict:
    """{key: sharding} of one level of a sharding tree laid out as ``like``
    (None: no shardings below). A model's shardings are the tree of its
    parameters (``param_shardings``), keyed here by parameter name."""
    if sh is None:
        return {}
    if isinstance(like, nn.Module):
        return {k.replace(".", SEP): v for k, v in flatten(sh).items()}
    return dict(_items(sh))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A DTensor's mesh and placements, as a sharding-tree leaf."""
    mesh: Any
    placements: tuple


def shardings_of(state):
    """The shardings of ``state``'s tensors, laid out as ``restore`` takes
    them: a DTensor leaf's :class:`Placement`, None for any other leaf."""
    if _is_leaf(state):
        if isinstance(state, DTensor):
            return Placement(state.device_mesh, tuple(state.placements))
        return None
    return {k: shardings_of(v) for k, v in _items(state)}


def _place(a: np.ndarray, like, sh, device) -> torch.Tensor:
    t = torch.as_tensor(a)
    dtype = like.dtype if isinstance(like, torch.Tensor) else t.dtype
    if sh is None:
        return t.to(device=device, dtype=dtype)
    # every rank read the same verified file: each takes its own shard of
    # its copy, and nothing is sent
    mesh = sh.mesh
    return distribute_tensor(t.to(device=mesh.device_type, dtype=dtype),
                             mesh, sh.placements, src_data_rank=None)


def _unflatten(like, arrays: dict, device, shardings=None, prefix: str = ""):
    """A state of ``like``'s structure and dtypes from ``arrays``, each
    tensor placed by the same-layout ``shardings`` leaf or, where there is
    none, on ``device`` (models are rebuilt around them)."""
    if _is_leaf(like):
        return _place(arrays[prefix], like, shardings, device)
    shs = _sharding_items(shardings, like)
    children = [(k, _unflatten(v, arrays, device, shs.get(k),
                               f"{prefix}{SEP}{k}" if prefix else k))
                for k, v in _items(like)]
    if isinstance(like, nn.Module):
        return rebuild(like, {k.replace(SEP, "."): v for k, v in children})
    values = [v for _, v in children]
    if _is_namedtuple(like):
        return type(like)(*values)
    if isinstance(like, dict):
        return dict(zip(like, values))
    return type(like)(values)


def _ranks() -> int:
    """The open world's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    """Every rank of the open world waits for the others (on the card's
    NCCL, on this rank's card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        # a save_async whose barrier every rank has yet to take (worlds of
        # more than one rank)
        self._pending = False
        # one record per save this process wrote: step, bytes, snapshot_s
        # (the host copy), write_s (npz, manifest and rename)
        self.saves: list[dict] = []

    @property
    def writer(self) -> bool:
        """Whether this process writes: rank 0 of the open world, or the
        only process."""
        return not dist.is_initialized() or dist.get_rank() == 0

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        t0 = time.perf_counter()
        flat = _flatten(state)  # host copy (synchronous snapshot)
        snap = time.perf_counter() - t0
        if blocking:
            if self.writer:
                self._write(step, flat, snap)
            if _ranks() > 1:
                _barrier()
        else:
            self.wait()
            if self.writer:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat, snap), daemon=True)
                self._thread.start()
            self._pending = _ranks() > 1

    def save_async(self, step: int, state: Any) -> None:
        self.save(step, state, blocking=False)

    def wait(self) -> None:
        """Until the last ``save_async`` is written (on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()

    def _write(self, step: int, flat: dict[str, np.ndarray],
               snapshot_s: float) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"ckpt_{step:08d}"
        tmp = self.dir / f".ckpt_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "sha256": {k: _sha(v) for k, v in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.saves.append({"step": step,
                           "bytes": sum(v.nbytes for v in flat.values()),
                           "snapshot_s": snapshot_s,
                           "write_s": time.perf_counter() - t0})

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None, verify: bool = True,
                device=None) -> tuple[Any, int]:
        """Restore into the structure (and dtypes) of ``like``.
        ``shardings`` (``like``'s layout, or None) places each array onto
        its leaf's mesh with its placements (what ``param_shardings`` and
        ``opt_shardings`` return): elastic restores onto another mesh pass
        that mesh's shardings. A leaf without one goes to ``device``: the
        CUDA card unless the caller asks for another (raises without a
        card)."""
        device = resolve_device(device)
        # a save still on its thread would be missed (the JAX package's
        # restore does not wait, so a failure just after a checkpoint step
        # restores the one before, or finds none)
        self.wait()
        if _ranks() > 1:
            _barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"ckpt_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        if verify:
            for k, a in arrays.items():
                got = _sha(a)
                want = manifest["sha256"][k]
                if got != want:
                    raise IOError(f"checkpoint corruption at {k}: "
                                  f"{got} != {want}")
        return _unflatten(like, arrays, device, shardings), step
