"""Cross-layer collective scheduling demo on the PyTorch port: trace one
train step on a small mesh, record the collectives it issues, and run the
paper's allocator over them to produce the issue order / chunking plan.

    PYTHONPATH=src python examples/port_comm_schedule.py --arch qwen1.5-0.5b \
        [--device cpu]

The step runs on meta tensors in a dry world of 8 ranks (the ``"fake"``
backend: nothing is allocated and no data moves) on a (4, 2) ("data",
"model") mesh of ``--device``'s type, whose collectives it records; the
allocator runs on ``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch.core.scheduler import extract_flows, plan_schedule
from repro_torch.device import resolve_device
from repro_torch.launch.comm_stats import by_axis, trace_train_step
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, dry_world, make_mesh
from repro_torch.models.registry import ShapeSpec, get_config, get_model
from repro_torch.sharding.policy import mesh_axes as axes_of


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(d_model=256, n_layers=2, vocab=1024)
    api = get_model(cfg, device="cpu")
    spec = ShapeSpec("demo", 256, 8, "train")
    with dry_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), dev.type)
        records, flops = trace_train_step(api, mesh, spec)
        mesh_axes = axes_of(mesh)

    flows = extract_flows(records, mesh_axes)
    print(f"extracted {len(flows)} collective flows from the traced step")
    for axis, (n, b) in by_axis(flows).items():
        print(f"  axis {axis:6s}: {n:3d} flows, {b / 1e6:8.1f} MB/step")

    compute_s = flops / PEAK_FLOPS_BF16
    sched = plan_schedule(flows, mesh_axes,
                          step_compute_s=max(compute_s, 1e-3), device=dev)
    print(f"allocator schedule: total comm {sched.est_total_comm_s * 1e3:.2f} ms, "
          f"exposed (not overlapped) {sched.est_exposed_s * 1e3:.2f} ms")
    print("top-5 most urgent flows (paper's min-max transfer-time order):")
    for i in sched.order[:5]:
        f = flows[i]
        print(f"  {f.kind:18s} axis={f.axis:6s} {f.bytes / 1e6:8.2f} MB "
              f"rate={sched.rates[i] / 1e9:6.2f} GB/s chunks={sched.chunks[i]}")
    return flows, sched


if __name__ == "__main__":
    main()
