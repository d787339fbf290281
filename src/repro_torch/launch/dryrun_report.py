"""Dry-run summary table, after the JAX package's
``repro.launch.dryrun_report``: per (arch × shape × mesh) of
``results/dryrun_torch/``, the status, the trace's seconds, the argument
and peak GB per rank, and the collectives; the title names the torch
versions and the meshes' device types that made the records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_report
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import RESULTS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    recs = [json.loads(f.read_text())
            for f in sorted(pathlib.Path(args.results).glob("*.json"))]
    base = [r for r in recs if r.get("rules", "baseline") == "baseline"
            and not r.get("constrain_grads")]
    made = sorted({f"torch {r.get('torch', '?')} on \"{r.get('device_type')}\""
                   " meshes" for r in base})
    print(f"### Dry run — {', '.join(made) or 'no records'}")
    print("| arch | shape | mesh | status | trace s | args GB/dev | "
          "peak GB/dev | collectives |")
    print("|---|---|---|---|---|---|---|---|")
    n_ok = n_fail = 0
    for r in base:
        if r.get("ok"):
            n_ok += 1
            m = r.get("memory", {})
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                  f"{r.get('trace_s', 0):.1f} | "
                  f"{m.get('argument_size_in_bytes', 0) / 1e9:.2f} | "
                  f"{m.get('peak_memory_in_bytes', 0) / 1e9:.2f} | "
                  f"{r.get('collectives', {}).get('count', '?')} |")
        else:
            n_fail += 1
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAIL | | | "
                  f"| {r.get('error', '')[:60]} |")
    print(f"\n**{n_ok} cells traced, {n_fail} failed.**")


if __name__ == "__main__":
    main()
