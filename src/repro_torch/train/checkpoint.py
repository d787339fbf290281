"""Checkpointing: atomic, async, integrity-checked, restored onto a device;
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
  * placement — ``restore(like, device=...)`` puts the tensors on a device
    (the CUDA card unless the caller asks for another), the counterpart of
    the JAX package's target shardings;
  * retention — the newest ``keep`` checkpoints are kept.

A state is a nest of dicts, lists, tuples, NamedTuples (``AdamState``),
models (``nn.Module``: their parameters by name) and tensors; keys join the
path with "/" (``params/groups/0/3/mamba/in_proj``, ``opt/m/embed``).
bfloat16 tensors are stored as float32 (numpy has no bfloat16) and cast
back to the dtype of ``like`` on restore.
"""
from __future__ import annotations

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
from torch import nn

from repro_torch.device import resolve_device
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


def _unflatten(like, arrays: dict, device, prefix: str = ""):
    """A state of ``like``'s structure and dtypes from ``arrays``, its
    tensors on ``device`` (models are rebuilt around them)."""
    if _is_leaf(like):
        a = torch.as_tensor(arrays[prefix])
        dtype = like.dtype if isinstance(like, torch.Tensor) else a.dtype
        return a.to(device=device, dtype=dtype)
    children = [(k, _unflatten(v, arrays, device,
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


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        # one record per save: step, bytes, snapshot_s (the host copy),
        # write_s (npz, manifest and rename)
        self.saves: list[dict] = []

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        t0 = time.perf_counter()
        flat = _flatten(state)  # host copy (synchronous snapshot)
        snap = time.perf_counter() - t0
        if blocking:
            self._write(step, flat, snap)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, snap), daemon=True)
            self._thread.start()

    def save_async(self, step: int, state: Any) -> None:
        self.save(step, state, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, like: Any, step: int | None = None, device=None,
                verify: bool = True) -> tuple[Any, int]:
        """Restore into the structure (and dtypes) of ``like``, the tensors
        on ``device``: the CUDA card unless the caller asks for another
        (raises without a card)."""
        device = resolve_device(device)
        # a save still on its thread would be missed (the JAX package's
        # restore does not wait, so a failure just after a checkpoint step
        # restores the one before, or finds none)
        self.wait()
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
        return _unflatten(like, arrays, device), step
