"""Roofline report, after the JAX package's ``repro.launch.roofline``.

Reads ``results/dryrun_torch/*.json`` (:mod:`repro_torch.launch.dryrun`)
and prints the roofline table: three terms in seconds per step and rank —
compute (traced FLOPs over the H100's dense bf16 tensor-core peak), memory
(the analytic floor :func:`memory_floor_s`, and the traced bytes of the
unfused ops, both over HBM3's rate) and collective (each mesh axis's
operand bytes over that axis's link rate, summed over the axes) — the
dominant term, MODEL FLOPs over traced FLOPs, and a one-line note per
(arch × shape × mesh).

The fabric is the one ``core/scheduler.py``'s rates assume: "data" and
"model" both ride NVLink (450 GB/s one way per GPU), so ``pod_16x16`` is
one NVLink Switch domain of 256 GPUs (an HGX H100 node holds 8), and
"pod" rides InfiniBand NDR (50 GB/s one way per GPU) between the two pods
of ``multipod_2x16x16``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod_16x16]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core import scheduler
from repro_torch.launch.comm_stats import COLLECTIVES
from repro_torch.launch.dryrun import RESULTS
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

FABRIC = ("fabric: pod_16x16 one NVLink Switch domain of 256 GPUs "
          "(\"data\", \"model\": NVLink 4, 450 GB/s one way per GPU); "
          "multipod_2x16x16 two such pods joined by InfiniBand NDR "
          "(\"pod\": 50 GB/s one way per GPU); core/scheduler.py's rates")


def memory_floor_s(rec: dict, tp: int = 16) -> float:
    """Analytic HBM-traffic floor per rank (perfectly fused kernels, no
    score materialization): weight reads (gathered copies at compute dtype,
    f32 in the baseline), optimizer state r/w on sharded storage,
    activation/residual traffic, KV-cache r/w. The traced unfused bytes
    are an upper bound — the truth lies between; both are reported."""
    from repro_torch.models.registry import get_config

    chips = rec["n_chips"]
    P = rec["params"]
    cfg = get_config(rec["arch"])
    dtype_w = 4.0            # baseline keeps f32 gathers
    toks_dev = rec["global_batch"] * max(rec["seq_len"], 1) / max(chips / tp, 1)
    if rec["kind"] == "decode":
        toks_dev = rec["global_batch"] / max(chips / tp, 1)
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_enc_layers
    act = toks_dev * d * 2.0 * L * 12.0        # ~12 r/w per layer, bf16
    if rec["kind"] == "train":
        weights = 3.0 * P * dtype_w / tp       # fwd + bwd + remat reads
        opt = 12.0 * P * 4.0 / chips           # m,v r/w + grad r/w + update
        return (weights + opt + act) / HBM_BW
    weights = P * dtype_w / tp
    cache = 0.0
    if rec["kind"] == "decode":
        # read the whole cache slice once per token
        cache = rec["seq_len"] * rec["global_batch"] * d * 2.0 * 2.0 * L / chips
    return (weights + cache + act) / HBM_BW


def collective_s(rec: dict) -> float:
    """Each mesh axis's operand bytes over its link rate, summed."""
    rates = scheduler._AXIS_BW_GBPS
    out = 0.0
    for key, (_, b) in rec["collectives_by_axis"].items():
        kind, axis = key.split("/")
        if kind in COLLECTIVES:
            out += b / (rates[axis] * 1e9)
    return out


def cell_terms(rec: dict) -> dict:
    chips = rec["n_chips"]
    flops_dev = rec["flops"]              # per-rank traced numbers
    bytes_dev = rec["bytes_accessed"]
    t_c = flops_dev / PEAK_FLOPS_BF16
    t_m = bytes_dev / HBM_BW              # unfused upper bound (traced)
    t_mf = memory_floor_s(rec)            # fused analytic floor
    t_n = collective_s(rec)
    # bottleneck classification uses the memory FLOOR: the traced byte
    # count assumes zero fusion and over-ranks memory for every cell
    dom = max((t_c, "compute"), (t_mf, "memory"), (t_n, "collective"))[1]
    if rec["kind"] == "train":
        tokens, mult = rec["global_batch"] * rec["seq_len"], 6
    elif rec["kind"] == "prefill":
        tokens, mult = rec["global_batch"] * rec["seq_len"], 2
    else:
        tokens, mult = rec["global_batch"], 2
    model_flops = mult * rec["active_params"] * tokens
    ratio = model_flops / max(flops_dev * chips, 1.0)
    bound = max(t_c, t_mf, t_n)
    return dict(t_c=t_c, t_m=t_m, t_mf=t_mf, t_n=t_n, dominant=dom,
                ratio=ratio, bound=bound, frac=t_c / max(bound, 1e-12),
                model_flops=model_flops)


NOTES = {
    ("compute",): "compute-bound: good — push tensor-core utilisation "
                  "(fused kernels, bf16)",
    ("memory",): "HBM-bound: increase arithmetic intensity "
                 "(fuse, larger tiles, avoid score materialization)",
    ("collective",): "collective-bound: cut FSDP/SP traffic "
                     "(bf16 gathers, reduce-scatter grads, less model-parallel "
                     "for small archs, overlap via allocator schedule)",
}


def improvement_note(rec: dict, t: dict) -> str:
    if t["dominant"] == "collective":
        c = rec["collectives"]
        top = max((k for k in ("all-gather", "all-reduce", "reduce-scatter",
                               "all-to-all", "collective-permute")),
                  key=lambda k: c.get(k, 0))
        return f"cut {top} ({c.get(top, 0) / 1e9:.0f} GB/dev): " + \
            NOTES[("collective",)]
    return NOTES[(t["dominant"],)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod_16x16",
                    help="pod_16x16 | multipod_2x16x16 | all")
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    rows = []
    for f in sorted(pathlib.Path(args.results).glob("*.json")):
        rec = json.loads(f.read_text())
        if args.mesh != "all" and rec.get("mesh") != args.mesh:
            continue
        if not rec.get("ok"):
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
                        f"| FAILED: {rec.get('error', '?')[:60]} "
                        "| | | | | | | |")
            continue
        t = cell_terms(rec)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{t['t_c']:.4f} | "
            f"{t['t_mf']:.4f} | {t['t_m']:.4f} | {t['t_n']:.4f} | "
            f"**{t['dominant']}** | {t['ratio']:.3f} | {t['frac']:.3f} | "
            f"{improvement_note(rec, t)} |")
    print(f"### Roofline — {args.mesh} (terms in seconds/step per rank; "
          "H100 SXM5 80GB datasheet constants)")
    print(FABRIC)
    print("| arch | shape | mesh | compute | mem(floor) | mem(traced,unfused) "
          "| collective | bottleneck | MODEL/traced | roofline-frac | "
          "what moves the dominant term |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(r)


if __name__ == "__main__":
    main()
