"""The check's control, and the faults it must catch, put in the place of
the timed path. The benchmark's own runs use none of this: the tests do,
and the readings that a check's limits are set from, of the port, the
control and the faults on the card (``python3 -m portbench.control <cell>
--out DIR --port SEED... --control SEED... --fault NAME SEED...`` from the
checkout's root), are taken through it.

- ``reference_in_place``: the plain reference computed with TF32 products
  (``precision="tf32"``: every sum the port takes as a product against a
  0/1 matrix fed 10-bit mantissas), the step below the configuration's
  float32, answers in the program's place. The port's own TF32 switch is
  no control: none of the port's products on these paths runs on tensor
  cores, so with it on the port gives the same answers.
- the faults: a tick that hands its state on unchanged; half of a
  campaign's scenarios left out, the mean of the others standing in; each
  tick's delivered megabytes altered where they are produced; a twelfth of
  a campaign's rows given their neighbours' answers.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np

from portbench import program


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def reference_in_place(config: dict, traffic: dict, scenarios,
                       precision: str = "tf32"):
    """Each job answers with the plain reference at ``precision`` over the
    scenarios it runs, in the program's format."""
    from portbench import run
    from portbench.reference import sim as reference

    call = program.Job.__call__

    def answer(job):
        out = call(job)
        got = reference.simulate(
            [scenarios[i] for i in out["rows"]], config["apps"],
            traffic["policy"], float(job.kw["seconds"]), float(config["dt_s"]),
            run.alloc_every(config, traffic), float(traffic["t_event"]),
            device=job.device, precision=precision)
        out["metrics"] = got["metrics"]
        for k in ("sink", "latency", "link_load"):
            if k in out:
                out[k] = got[k]
        return out
    return patched(program.Job, "__call__", answer)


def frozen_tick():
    """A tick that returns its state unchanged: nothing moves, nothing is
    delivered."""
    from repro_torch.streams import simulator

    def advance(sim, policy, carry, caps_t, R_t, enforce, *, dt, qcap):
        z = carry[0].new_zeros(())
        ys = (z, z[None].expand(sim.n_apps).clone(), carry[0] * 0.0,
              sim.caps * 0.0)
        return carry, ys
    return patched(simulator, "_advance", advance)


def half_batch():
    """A campaign that runs every other scenario and gives the others the
    mean of the rows it ran."""
    from repro_torch.streams import fleet

    run_campaign = fleet.FleetRunner.run_campaign

    def halved(self, sims, *a, **kw):
        out = run_campaign(self, list(sims)[::2], *a, **kw)
        m = np.repeat(out.metrics, 2, axis=0)[:len(sims)]
        m[1::2] = out.metrics.mean(0)
        out.metrics = m
        return out
    return patched(fleet.FleetRunner, "run_campaign", halved)


def altered_sink(factor: float = 1.01):
    """Each tick's delivered megabytes ``factor`` times what they are, where
    the tick produces them."""
    from repro_torch.streams import simulator

    tick = simulator._tick

    def wrong(*a, **kw):
        Qs, Qr, transfer, drain, (sink, sink_app, wait, load) = tick(*a, **kw)
        return Qs, Qr, transfer, drain, (sink * factor, sink_app * factor,
                                         wait, load)
    return patched(simulator, "_tick", wrong)


def mixed_rows(every: int = 12):
    """A campaign that hands every ``every``-th scenario the answers of the
    one after it (rows mixed up inside a chunk): a twelfth of the rows."""
    from repro_torch.streams import fleet

    run_campaign = fleet.FleetRunner.run_campaign

    def mixed(self, sims, *a, **kw):
        out = run_campaign(self, sims, *a, **kw)
        rows = np.arange(0, len(sims) - 1, every)
        out.metrics[rows] = out.metrics[rows + 1]
        return out
    return patched(fleet.FleetRunner, "run_campaign", mixed)


FAULTS = {"frozen_tick": frozen_tick, "half_batch": half_batch,
          "altered_sink": altered_sink, "mixed_rows": mixed_rows}


def main(argv) -> int:
    """``<cell> --out DIR [--port SEED...] [--control SEED...] [--fault NAME
    SEED...]``: run a cell on the card once for each seed, a window of one
    job, with the port as its timed path (``--port``), the reference in
    TF32 products in its place (``--control``) or the port with a planted
    fault (``--fault``), and keep every scenario's gap of every entry of
    the epilogue, with the reference's marks of rounding, in
    ``DIR/<kind>_<seed>.npz``: the readings that a check's limits are set
    from. Each run's numbers against the check's own limits are printed."""
    import argparse
    import json
    import time
    from pathlib import Path

    import torch

    from portbench import run, scenario
    from portbench.reference import compare

    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("cell")
    ap.add_argument("--out", required=True)
    ap.add_argument("--port", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="*", default=[])
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(bench, args.cell)
    every = dict(files["checks"], limits=dict(
        {n: 1.0 for n in compare.METRICS}, **files["checks"]["limits"]))
    plan = [("port", s, contextlib.nullcontext) for s in args.port]
    plan += [("control", s, lambda s=s: reference_in_place(
        files["config"], files["traffic"],
        scenario.draw(files["config"], files["traffic"], s)))
        for s in args.control]
    if args.fault:
        plan += [(args.fault[0], int(s), FAULTS[args.fault[0]])
                 for s in args.fault[1:]]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for kind, seed, ctx in plan:
        keep = {}
        with ctx():
            r = run.run_cell(dict(files, checks=every), seed, 1.0, False,
                             "cuda:0", time.perf_counter(), bench, keep=keep)
        arrays = {"rows": np.concatenate(keep["rows"]),
                  "decided": keep["decided"], "tie": keep["tie"]}
        for n in every["limits"]:
            arrays[f"gap.{n}"] = np.concatenate([g[n] for g in keep["gaps"]])
            if keep["rounding"] is not None:
                arrays[f"rounding.{n}"] = keep["rounding"][n]
        np.savez(out / f"{kind}_{seed}.npz", **arrays)
        print(json.dumps({"cell": args.cell, "kind": kind, "seed": seed,
                          "correct": r["correct"], "check": r["check"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
