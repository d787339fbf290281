#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything that
belongs to it is found by name: its configuration (the file the entry of
``configs`` names), its traffic (``traffic/<traffic>.json``), the limits of
its check (``checks/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).

Set-up draws the cell's scenarios from ``--seed``, compiles them through
the port, and runs one warm-up job at the cell's shapes over the traffic's
``warmup_s`` simulated seconds. The window
then runs the cell's job back to back, one client in a closed loop, until
``--seconds`` have passed; the last job finishes past the mark. A job is one
call into the port (``FleetRunner.run_campaign`` over the cell's scenarios,
or ``simulate`` of the next one) and ends when its answers are on the host.
Every rate is the work of the window's whole jobs over their whole wall
time, the card synchronised at both ends. After the window the plain
reference runs the cell's scenarios once, and every answer of every job is
held to it, each scenario to each number's limit unless rounding decides
that number for it (``reference/compare.py``). The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. ``--trace 1`` traces one job of the window with the profiler and
reports the per-layer metrics instead of the end-to-end ones.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# modules that must not be loaded in the measured process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or, where a
    metric ``<base>.<part>`` has no file of its own, ``metrics/<base>.py``
    (one quantity split by the end-to-end metric its cells report)."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.exists() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def cell_files(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's entry and its configuration, traffic and check files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    base = root / "portbench"
    return dict(cell=cell, config=load_json(root / conf["file"]),
                traffic=load_json(base / "traffic" / f"{cell['traffic']}.json"),
                checks=load_json(base / "checks" / f"{name}.json"))


def alloc_every(config: dict, traffic: dict) -> int:
    """Ticks between the policy's solves: the allocator's interval under
    appaware; tcp re-solves every tick."""
    if traffic["policy"] != "appaware":
        return 1
    return int(round(config["alloc_interval_s"] / config["dt_s"]))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def rates(spans, rows, horizon_s: float) -> dict:
    """The window's rates: every returned scenario, and every simulated
    second of them, over the wall time from the first job's start to the
    last one's end. ``spans`` are the jobs' (start, end) seconds and
    ``rows`` the scenarios each returned."""
    wall = spans[-1][1] - spans[0][0]
    n = sum(rows)
    return {"scenarios_per_s": n / wall, "sim_s_per_s": n * horizon_s / wall,
            "wall_s": wall}


# ----------------------------------------------------------------- trace
def device_events(prof, t0_ns: int, t1_ns: int, kind: str = "CUDA") -> list:
    """(name, start ns, duration ns, device) of every device activity
    (kernel, copy, fill) of the profiler's trace that starts in [t0, t1).
    On a run without a card (the tests) the CPU's operations stand in."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith(kind):
            continue
        s = int(e.start_ns())
        if t0_ns <= s < t1_ns:
            out.append((e.name(), s, int(e.duration_ns()), int(e.device_index())))
    return out


def busy_intervals(events) -> list:
    """The union of the events' intervals, merged, in time order."""
    merged = []
    for _, s, d, *_ in sorted(events, key=lambda e: e[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    return merged


def busy_s(events, n_devices: int) -> float:
    """Seconds in which some operation ran, per device, averaged over the
    ``n_devices`` the run uses (a device with no operation counts 0)."""
    per = {}
    for e in events:
        per.setdefault(e[3], []).append(e)
    return sum(sum(b - a for a, b in busy_intervals(ev)) * 1e-9
               for ev in per.values()) / max(n_devices, 1)


def idle_gaps(busy, phases, t0_ns, t1_ns) -> list:
    """The idle time of the traced window, the stretches in which no device
    ran anything, cut at the harness's phases and summed by what the host
    was doing then: inside the job, before its first device operation (host
    staging), between its device operations (the host's launch path), or
    after its last one; or the harness's collect. Each entry is (phase with
    its gap count and longest gap, seconds)."""
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    first, last = (busy[0][0], busy[-1][1]) if busy else (t1_ns, t0_ns)
    merged = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        for name, s, e in phases:
            lo, hi = max(a, s), min(b, e)
            if hi <= lo:
                continue
            where = name
            if name == "job":
                where = ("job: host before its first device op" if hi <= max(first, s)
                         else "job: host after its last device op" if lo >= min(last, e)
                         else "job: host between device ops")
            merged.setdefault(where, []).append((hi - lo) * 1e-9)
    return sorted(((f"{w}: {len(v)} gaps, longest {max(v):.6f} s", sum(v))
                   for w, v in merged.items()), key=lambda g: -g[1])


def host_reading(cuda: bool) -> str:
    """The host's state at one moment: its load averages and runnable
    processes, the mean clock its cores report, and the milliseconds that
    pinning 64 MiB takes (on a card), so that a run that drifts can be set
    beside what the host was doing."""
    parts = []
    try:
        with open("/proc/loadavg") as fh:
            parts.append("loadavg " + " ".join(fh.read().split()[:4]))
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(x.split(":")[1]) for x in fh if x.startswith("cpu MHz")]
        if mhz:
            parts.append(f"cpu MHz mean {sum(mhz) / len(mhz):.1f} "
                         f"min {min(mhz):.1f} of {len(mhz)}")
    except (OSError, ValueError, IndexError):
        pass
    if cuda:
        import torch
        t0 = time.perf_counter()
        buf = torch.empty(64 << 20, dtype=torch.uint8, pin_memory=True)
        parts.append(f"pin 64 MiB {1e3 * (time.perf_counter() - t0):.3f} ms")
        del buf
    return "; ".join(parts)


def cpu_times():
    """The machine's CPU seconds so far by state (``/proc/stat``: user, nice,
    system, idle, iowait, irq, softirq, steal), and this process's own."""
    try:
        with open("/proc/stat") as fh:
            ticks = [int(x) for x in fh.readline().split()[1:9]]
    except (OSError, ValueError):
        ticks = []
    hz = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
    return [t / hz for t in ticks], time.process_time(), time.perf_counter()


def window_shares(a, b) -> str:
    """What the machine's cores did between two ``cpu_times`` readings:
    the shares busy, and stolen by the hypervisor for other machines, of
    all its cores' time, and the cores this process kept busy."""
    (ta, pa, wa), (tb, pb, wb) = a, b
    own = f"this process {(pb - pa) / max(wb - wa, 1e-9):.3f} cores"
    if len(ta) < 8 or len(tb) < 8:
        return own
    d = [y - x for x, y in zip(ta, tb)]
    total = max(sum(d), 1e-9)
    return (f"cores busy {100 * (d[0] + d[1] + d[2] + d[5] + d[6]) / total:.2f}%, "
            f"stolen {100 * d[7] / total:.2f}%, iowait {100 * d[4] / total:.2f}% "
            f"of {total:.1f} core-s; {own}")


def power_limit_w():
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(text.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------------- run
def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: dict, log=sys.stderr, keep=None) -> dict:
    """One run of a cell on ``device``; returns the result object. A
    ``keep`` dict receives each job's gaps (``gaps``, and ``rows``, the
    job's scenarios among those the reference ran) and the reference's
    marks of rounding (``rounding``, ``decided``, ``tie``), for reading
    limits."""
    import numpy as np
    import torch

    from portbench import program, scenario
    from portbench.reference import compare
    from portbench.reference import sim as reference

    cell, config, traffic, checks = (files[k] for k in
                                     ("cell", "config", "traffic", "checks"))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n_dev = int(cell["chips"]) if cuda else 1
    sync = (lambda: [torch.cuda.synchronize(i) for i in range(n_dev)]) if cuda \
        else (lambda: None)
    dt, horizon = float(config["dt_s"]), float(config["horizon_s"])

    # ---- set-up: the scenarios, compiled by the port on the host, and one
    # warm-up job at the cell's shapes ----
    scs = scenario.draw(config, traffic, seed)
    compile_s, sims = [], []
    for sc in scs:
        t0 = time.perf_counter()
        sims.append(program.compile_scenario(config, sc, "cpu"))
        compile_s.append(time.perf_counter() - t0)
    warm = program.Job(sims, config, traffic, dev,
                       seconds=float(traffic["warmup_s"]))
    warm()
    # one runner for the run: its plan and staging slots persist
    job = program.Job(sims, config, traffic, dev, runner=warm.runner)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {len(scs)} scenarios, compile {sum(compile_s):.3f} s, "
          f"set-up {setup_s:.3f} s", file=log)
    print(f"host before the window: {host_reading(cuda)}", file=log)
    cpu0 = cpu_times()

    # ---- the window ------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    traced = 1 if trace else -1     # the job the profiler records
    prof, phases, spans, outs, stats = None, [], [], [], []
    sync()
    w0 = time.perf_counter()
    while len(spans) <= traced or not spans or time.perf_counter() - w0 < seconds:
        k = len(spans)
        if k == traced:
            sync()
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
            tr0_ns = time.time_ns()
        s = time.perf_counter()
        s_ns = time.time_ns()
        out = job()
        e_ns = time.time_ns()
        spans.append((s, time.perf_counter()))
        outs.append(out)
        if out["stats"] is not None:
            stats.append(out["stats"])
        if k == traced:
            sync()
            tr1_ns = time.time_ns()
            phases = [("job", s_ns, e_ns), ("collect", e_ns, tr1_ns)]
            prof.__exit__(None, None, None)
    sync()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n_dev)) if cuda else 0
    r = rates(spans, [int((~o["bad"]).sum()) for o in outs], horizon)

    result = {"correct": None, "attempted": 0, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": n_dev, "memory_peak_bytes": int(peak)}}
    wanted = {m["name"]: m for m in (bench["per_layer"] if trace
                                     else bench["end_to_end"])
              if cell["name"] in m.get("workloads", [cell["name"]])}
    if trace:
        events = device_events(prof, tr0_ns, tr1_ns, "CUDA" if cuda else "CPU")
        busy = busy_intervals(events)
        b_s = busy_s(events, n_dev)
        window_s = (tr1_ns - tr0_ns) * 1e-9
        ctx = dict(events=events, busy_s=b_s, window_s=window_s,
                   compile_s=compile_s, stats=stats, traced_stats=outs[traced]["stats"],
                   scenarios=scs, config=config, traffic=traffic)
        for name in wanted:
            value = load_module(reader_path(name)).read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": wanted[name]["unit"]}
        result["device"].update(busy_s=b_s, window_s=window_s)
        ops = {}
        for name, _, d, _ in events:
            ops[name] = ops.get(name, 0.0) + d * 1e-9
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [list(g) for g in
                          idle_gaps(busy, phases, tr0_ns, tr1_ns)[:10]]}
        watts = power_limit_w() if cuda else None
        if watts is not None:
            result["device"]["power_limit_w"] = watts
        del prof
    else:
        values = dict(r, setup_s=setup_s)
        for name in wanted:
            result["metrics"][name] = {"value": values[name],
                                       "unit": wanted[name]["unit"]}

    # ---- the check: every answer of every job against the reference, once
    # the program's state is freed ----
    print(f"host over the window: {window_shares(cpu0, cpu_times())}", file=log)
    print(f"host after the window: {host_reading(cuda)}", file=log)
    del job, warm, sims
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    used = sorted({i for o in outs for i in o["rows"]})
    at = {i: k for k, i in enumerate(used)}
    args = ([scs[i] for i in used], config["apps"], traffic["policy"], horizon,
            dt, alloc_every(config, traffic), float(traffic["t_event"]))
    ref = reference.simulate(*args, device=dev)
    rounding = excuse = None
    if checks.get("excuse"):
        rounding = compare.gaps(
            reference.simulate(*args, device=dev, precision=checks["excuse"]),
            ref, checks, horizon)
        excuse = compare.excused(ref, rounding, checks)
    worst = {n: 0.0 for n in checks["limits"]}
    excused = {n: 0 for n in checks["limits"]}
    for o in outs:
        k = [at[i] for i in o["rows"]]
        g = compare.gaps(o, compare.rows_of(ref, k), checks, horizon)
        ex = {n: e[k] for n, e in excuse.items()} if excuse else None
        # an answer that is not a number is wrong, whatever rounding decides
        bad = o["bad"] | np.isnan(o["metrics"]).any(1)
        for n, v in g.items():
            held = ~o["bad"] & ~ex[n] if ex else ~o["bad"]
            worst[n] = max(worst[n], float(np.max(np.where(held, v, 0.0))))
            excused[n] += int(ex[n].sum()) if ex else 0
        for n, v in compare.over(g, checks, ex).items():
            bad |= v
        result["attempted"] += len(o["rows"])
        result["failed"] += int(bad.sum())
        if keep is not None:
            keep.setdefault("gaps", []).append(g)
            keep.setdefault("rows", []).append(k)
    if keep is not None:
        keep.update(rounding=rounding, decided=ref["decided"], tie=ref["tie"])
    result["correct"] = result["failed"] == 0
    print(f"window: {len(spans)} jobs in {r['wall_s']:.3f} s (each "
          f"{', '.join(f'{e - s:.3f}' for s, e in spans)} s); reference "
          f"{time.perf_counter() - t_ref:.3f} s; quarantined "
          f"{sum(int(o['bad'].sum()) for o in outs)}", file=log)
    if excuse:
        result["excused"] = excused
        print(f"excused as decided by rounding (the {checks['excuse']} "
              "reference beyond the number's excuse_over, or marked by the "
              f"float64 one), of {result['attempted']} scenario runs: "
              + ", ".join(f"{n} {c}" for n, c in excused.items()), file=log)
    # a gap that is not finite (a NaN or an infinity in the port's answer)
    # prints as the largest float, so the line stays valid JSON
    result["check"] = {n: {"value": (worst[n] if np.isfinite(worst[n])
                                     else sys.float_info.max),
                           "limit": checks["limits"][n]}
                       for n in checks["limits"]}
    for n, v in result["check"].items():
        print(f"check {n} {v['value']:.6e} limit {v['limit']:.6e}", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(bench, args.workload)
    import torch
    need = int(files["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"this cell needs {need} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(files, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START, bench)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded in the measured process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # one host thread for the numeric libraries, set before they load: load
    # from one process with few threads repeats from run to run. Kernel and
    # compiler caches at fixed paths inside the checkout.
    for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_v, "1")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.exit(main())
