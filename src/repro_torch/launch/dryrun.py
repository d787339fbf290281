"""Dry run over the production meshes, after the JAX package's
``repro.launch.dryrun``.

For every (architecture × ``shapes_for`` shape × production mesh) cell it
traces the cell's step (a train step, a prefill, or one decode step) on
meta tensors, on a mesh of a dry world (:func:`repro_torch.launch.mesh.
dry_world`: 256 or 512 ranks in this one process on the "fake" backend),
and records what one rank does: FLOPs, bytes accessed, the collectives
(per kind, per (kind, mesh axis), and the call sites that issued the most
traffic), the bytes of its arguments and its peak memory. Each cell's
record is cached as JSON under ``results/dryrun_torch/``; a record whose
``ok`` is true is not traced again, so a sweep resumes where it stopped.

Where it departs from the reference:

* **No probes.** XLA's cost analysis counts a rolled layer loop once, so
  the reference compiles 1- and 2-layer unrolled variants and extrapolates.
  An eager trace runs every layer, so FLOPs and collectives are exact at
  full depth: each cell is traced at full depth (``depth_traced``, the
  config's layers) and timed (``trace_s``). ``--cast-once`` and
  ``--skip-probes``, which steer only XLA, have no counterpart.
* **Memory per rank.** PyTorch has no ``memory_analysis()``.
  ``memory.argument_size_in_bytes`` is the bytes of this rank's local
  shards of the parameters, the AdamW state (train), the decode cache and
  the batch (``memory.arguments`` by category);
  ``memory.peak_memory_in_bytes`` is the peak over the trace of
  ``torch.distributed._tools.mem_tracker.MemTracker``, with the arguments
  registered, and ``memory_by_category`` its split at the peak
  (:class:`Memory`). The port's train step is functional: it returns a
  new model and new moments beside the old ones, where the reference
  donates the parameters and the optimizer state (its update reuses their
  buffers). So a train cell's peak holds both states at the update.
* **Mesh type.** Cells are traced on "cuda" meshes, the default: on a
  "cpu" mesh DTensor replaces each all-to-all with an all-gather and a
  chunk, so a "cpu" record is not the card's. ``--device cpu`` traces on
  a "cpu" mesh here; each record names its mesh's device type and
  ``torch.__version__``.
* **No fallback** to a sibling mesh's numbers: there are no probes for
  them to stand in for. A failed cell keeps its error and traceback, and
  the run exits 1 if any cell failed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --mesh both -v
  # a reduced cell on this machine's CPU, on a dry (2, 4) mesh:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen1.5-0.5b --shape train_4k --mesh lite --reduced
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.core.scheduler import extract_flows
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import comm_stats
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import dry_world, make_mesh
from repro_torch.models.registry import (ShapeSpec, get_config, get_model,
                                         list_archs, shapes_for)
from repro_torch.sharding.policy import mesh_axes, sharding_policy

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

# mesh name -> (shape, axes); "lite" is the reference tests' (2, 4) mesh
MESHES = {
    "pod_16x16": ((16, 16), ("data", "model")),
    "multipod_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "lite_2x4": ((2, 4), ("data", "model")),
}
MESH_CHOICES = {"both": ["pod_16x16", "multipod_2x16x16"],
                "single": ["pod_16x16"], "multi": ["multipod_2x16x16"],
                "lite": ["lite_2x4"]}
# the reference tests' reduced widths (tests/test_distribution.py)
LITE = dict(d_model=128, vocab=1024, n_heads=8, n_kv_heads=8, head_dim=None)
TOP_SITES = 10


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a state: a model's parameters, the leaves of dicts,
    lists and tuples (``AdamState``)."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class Memory:
    """This rank's memory over a traced step: the bytes of the arguments'
    local shards by category (``args``: {category: state}), and
    ``MemTracker``'s peak over the step with every argument registered
    (the model's parameters as parameters, the other arguments as
    "Other"), split by its categories."""

    def __init__(self, args: dict):
        from torch.distributed._tools.mem_tracker import MemTracker

        self.arguments = {cat: sum(comm_stats.tensor_bytes(_local(t))
                                   for t in _tensors(state))
                          for cat, state in args.items()}
        self.tracker = MemTracker()
        for state in args.values():
            if isinstance(state, nn.Module):
                self.tracker.track_external(state)
            else:
                self.tracker.track_external(
                    *(_local(t) for t in _tensors(state)))

    def __enter__(self):
        self.tracker.__enter__()
        return self

    def __exit__(self, *exc):
        return self.tracker.__exit__(*exc)

    def record(self) -> tuple[dict, dict]:
        """(the record's ``memory``, its ``memory_by_category``)."""
        # the meta tensors stand in for the card's (a host tensor, such as
        # a decode step's position, is not the card's memory)
        snap = self.tracker.get_tracker_snapshot("peak")[torch.device("meta")]
        by_cat = {getattr(k, "value", k): v for k, v in snap.items()}
        args = sum(self.arguments.values())
        peak = by_cat.pop("Total")
        return ({"argument_size_in_bytes": args,
                 "peak_memory_in_bytes": peak,
                 "temp_size_in_bytes": peak - args,
                 "arguments": self.arguments}, by_cat)


def _trace(api, spec: ShapeSpec, mesh, rules_over: dict | None,
           constrain_grads: bool):
    """The cell's step on meta tensors on ``mesh``: (its collective
    record, its :class:`Memory`)."""
    cfg = api.cfg
    if spec.kind == "train":
        rules = dict(S.TRAIN_RULES, **(rules_over or {}))
        got = {}

        def watch(args):
            got["memory"] = Memory(args)
            return got["memory"]
        records, _ = comm_stats.trace_train_step(
            api, mesh, spec, rules, constrain_grads=constrain_grads,
            watch=watch)
        return records, got["memory"]

    rules = dict(S.SERVE_RULES, **(rules_over or {}))
    with sharding_policy(mesh, rules), torch.no_grad():
        psh = S.param_shardings(mesh, api, rules)
        model = api.build(S.place_tree(api.abstract_params(), psh))
        specs = api.input_specs(spec)
        if spec.kind == "prefill":
            bsh = S.batch_shardings(mesh, specs, rules)
            batch = {k: S.place(v, bsh[k]) for k, v in specs.items()}
            # vlm: the cache must also hold the vision prefix
            vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
            args = {"params": model, "batch": batch}

            def run():
                return api.prefill(model, batch, spec.seq_len + vis)
        else:
            # decode: one new token against a cache of seq_len
            cache = api.init_cache(spec.global_batch, spec.seq_len,
                                   device="meta")
            cache = S.place_tree(cache, S.cache_shardings(mesh, cache, rules))
            tok = specs["tokens"]
            tok = S.place(tok, S.batch_shardings(
                mesh, {"tokens": tok}, rules)["tokens"])
            args = {"params": model, "cache": cache, "batch": tok}

            def run():
                return api.decode(model, cache, tok, spec.seq_len - 1)
        memory = Memory(args)
        with comm_stats.record(mesh) as records, memory:
            run()
    return records, memory


def _by_axis(records, mesh) -> dict:
    """{"kind/axis": [ops, operand bytes]} of a record, each collective on
    the mesh axis whose links it rides (``core.scheduler.extract_flows``:
    a group over several mesh dims goes by its size)."""
    flows = extract_flows(records, mesh_axes(mesh))
    return {f"{kind}/{axis}": [n, b] for (kind, axis), (n, b) in sorted(
        comm_stats.by_axis(flows, per_kind=True).items())}


def cell_path(arch: str, spec_name: str, mesh: str, rules_name: str,
              constrain_grads: bool, tag: str, results) -> pathlib.Path:
    suffix = "" if rules_name == "baseline" else f"__{rules_name}"
    if constrain_grads:
        suffix += "__cg"
    if tag:
        suffix += f"__{tag}"
    return pathlib.Path(results) / f"{arch}__{spec_name}__{mesh}{suffix}.json"


def run_cell(arch: str, spec: ShapeSpec, mesh: str = "pod_16x16", *,
             verbose: bool = False, rules_name: str = "baseline",
             constrain_grads: bool = False,
             device_type: str = DEFAULT_DEVICE, cfg=None, tag: str = "",
             results=RESULTS) -> dict:
    """Trace one cell on a dry world of ``mesh``'s ranks, write its record
    to ``results`` and return it (a cached ``ok`` record is returned as it
    is). ``cfg`` replaces the arch's config for a cut cell (``tag`` names
    the cut in the record and the file)."""
    out_path = cell_path(arch, spec.name, mesh, rules_name, constrain_grads,
                         tag, results)
    if out_path.exists():
        rec = json.loads(out_path.read_text())
        if rec.get("ok"):
            return rec
    cfg = cfg or get_config(arch)
    api = get_model(cfg, device=device_type)
    shape, axes = MESHES[mesh]
    t0 = time.time()
    rec = {"arch": arch, "shape": spec.name, "mesh": mesh,
           "rules": rules_name, "constrain_grads": constrain_grads,
           "kind": spec.kind, "seq_len": spec.seq_len,
           "global_batch": spec.global_batch, "n_chips": math.prod(shape),
           "params": api.count_params(), "active_params": api.active_params(),
           "depth_traced": cfg.n_layers, "reduced": tag or None,
           "device_type": resolve_device(device_type).type,
           "torch": torch.__version__, "ok": False}
    try:
        with dry_world(math.prod(shape)):
            m = make_mesh(shape, axes, device_type)
            records, memory = _trace(api, spec, m, S.PRESETS[rules_name],
                                     constrain_grads)
            by_axis = _by_axis(records, m)
        rec.update(
            trace_s=round(time.time() - t0, 2),
            flops=float(records.flops),
            kernel_flops=float(records.kernel_flops),
            bytes_accessed=float(records.bytes_accessed),
            collectives=comm_stats.collective_stats(records),
            collectives_by_axis=by_axis,
            call_sites=comm_stats.by_site(records, TOP_SITES),
        )
        rec["memory"], rec["memory_by_category"] = memory.record()
        rec["ok"] = True
        if verbose:
            print(json.dumps({k: rec[k] for k in (
                "flops", "bytes_accessed", "collectives", "memory",
                "memory_by_category")}, indent=1))
            for site in rec["call_sites"]:
                print("  ", site)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {arch:22s} {spec.name:12s} {mesh:16s} "
          f"{rec['total_s']:7.1f}s"
          + ("" if rec["ok"] else f"  {rec.get('error', '')[:120]}"),
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=list(MESH_CHOICES))
    ap.add_argument("--rules", default="baseline",
                    help="sharding preset (see launch/shardings.PRESETS)")
    ap.add_argument("--constrain-grads", action="store_true",
                    help="pin grad shardings to param shardings")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the meshes' device type (cuda: the card's)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference tests' reduced widths")
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # raises without a card for cuda

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced(**LITE)
        for spec in shapes_for(cfg):
            if args.shape != "all" and spec.name not in args.shape.split(","):
                continue
            for mesh in MESH_CHOICES[args.mesh]:
                rec = run_cell(arch, spec, mesh, verbose=args.verbose,
                               rules_name=args.rules,
                               constrain_grads=args.constrain_grads,
                               device_type=args.device,
                               cfg=cfg if args.reduced else None,
                               tag="reduced" if args.reduced else "",
                               results=args.results)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
