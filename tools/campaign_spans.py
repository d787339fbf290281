"""Where the host's time goes in a benchmark cell's campaign job, read from
the port's host spans (``repro_torch.tracing``), on one CUDA card.

    python3 tools/campaign_spans.py [--workload CELL] [--seed N] [--pairs K]

(``--device cpu --scenarios 36`` rehearses it on the CPU at a small size;
there the profiler's CPU operations stand in for the device's, and every
number is the CPU's.)

Set-up as the benchmark's (``portbench/run.py``): the cell's scenarios
drawn from ``--seed`` and compiled through the port, here with the recorder
on, so that ``compile_sim``'s share of the compile time shows; one warm-up
job, recorded too, so that its CUDA graph captures show (``capture`` spans,
and the job's ``n_graph_captures``, ``n_graph_replays``,
``n_graph_fallbacks`` and ``graph_tick_share``). Then, on the card:

1. the clock: one small launch inside a span after a synchronise, 20 times,
   under the profiler (CPU and CUDA activity): how far the launch's host
   operation and its kernel lie from the span;
2. the host's cost of one operation: a loop of one-element adds, eager and
   under ``torch.func.vmap`` over 1,024 rows;
3. ``--pairs`` pairs of jobs with the recorder off and on, in turns, first
   untimed by the profiler, then traced as the benchmark traces its job
   (CUDA activity, the window from the job's start to the card's
   synchronise): each job's wall time, idle share, ``overlap_fraction`` and
   graph counters, and for the recorded traced jobs ``launches_per_tick``,
   ``advance_host_us``, ``update_host_us`` (both absent where every chunk
   replays a graph), ``replay_host_us``, ``capture_host_us``,
   ``idle_in_dispatch``, the share of the job the launching thread's spans
   cover, and the idle time split by the innermost span's path.

Prints one JSON object on standard output (each job's line also on
standard error as it ends). Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def clock_probe(dev, sync, profile, activities) -> dict:
    """ns from each probe span's start to its op's start and the kernel's
    start (the op's on the CPU), and from the op's end to the span's end."""
    import torch

    from repro_torch import tracing

    x = torch.zeros(1, device=dev)
    x.add_(1)
    sync()
    with tracing.recording() as rec, profile(activities=activities) as prof:
        for _ in range(20):
            sync()
            with tracing.span("probe"):
                x.add_(1)
            sync()
    evs = list(prof.profiler.kineto_results.events())
    ops = sorted((int(e.start_ns()), int(e.end_ns())) for e in evs
                 if e.name() == "aten::add_")
    kern = sorted(int(e.start_ns()) for e in evs
                  if str(e.device_type()).endswith("CUDA")) or [o for o, _ in ops]
    spans = sorted((s.start_ns, s.end_ns) for s in rec.spans)
    rows = [(o[0] - s[0], s[1] - o[1], k - s[0])
            for s, o, k in zip(spans, ops, kern)]
    return {name: {"median": statistics.median(c), "min": min(c), "max": max(c)}
            for name, c in zip(("op_start_after_span_start_ns",
                                "span_end_after_op_end_ns",
                                "kernel_start_after_span_start_ns"),
                               zip(*rows))} | {"n": len(rows)}


def host_us_per_op(dev, sync, n: int = 2000) -> dict:
    """Host µs per operation of a loop of one-element adds on the device,
    eager and under ``torch.func.vmap`` over 1,024 rows."""
    import torch
    from torch.func import vmap

    x = torch.zeros(1024, 1, device=dev)
    one = x[0]
    step = vmap(lambda r: r + 1.0)
    out = {}
    for name, fn, arg in (("eager", lambda t: t + 1.0, one),
                          ("vmap", step, x)):
        for _ in range(50):
            fn(arg)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(arg)
        out[name] = 1e6 * (time.perf_counter() - t0) / n
        sync()
    return out


GRAPH_KEYS = ("n_graph_captures", "n_graph_replays", "n_graph_fallbacks",
              "graph_tick_share")


def graph_stats(st: dict) -> dict:
    """A campaign's CUDA graph counters from its ``last_stats`` (none from a
    port that keeps none)."""
    return {k: st[k] for k in GRAPH_KEYS if k in st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="testbed-campaign-appaware")
    ap.add_argument("--seed", type=int, default=2700000001)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="the cell's traffic cut to this many scenarios")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import program, scenario
    from portbench import run as harness
    from repro_torch import tracing

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("campaign_spans: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    files = harness.cell_files(harness.load_json(ROOT / "BENCHMARK.json"),
                               args.workload)
    config, traffic = files["config"], files["traffic"]
    if args.scenarios:
        traffic["scenarios"] = args.scenarios

    # ---- set-up, the compiles recorded --------------------------------
    scs = scenario.draw(config, traffic, args.seed)
    compile_s = 0.0
    with tracing.recording() as rec:
        sims = []
        for sc in scs:
            t0 = time.perf_counter()
            sims.append(program.compile_scenario(config, sc, "cpu"))
            compile_s += time.perf_counter() - t0
    names = [s.name for s in rec.spans]
    compile_sim_s = sum(s.end_ns - s.start_ns for s in rec.spans
                        if s.name == "compile_sim") * 1e-9
    warm = program.Job(sims, config, traffic, dev,
                       seconds=float(traffic["warmup_s"]))
    t0 = time.perf_counter()
    with tracing.recording() as wrec:
        wst = warm()["stats"]
    sync()
    warm_s = time.perf_counter() - t0
    capture_s = [(s.end_ns - s.start_ns) * 1e-9 for s in wrec.spans
                 if s.name == "capture"]
    job = program.Job(sims, config, traffic, dev, runner=warm.runner)
    sync()
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "power_limit_w": harness.power_limit_w() if cuda else None,
           "torch": torch.__version__, "workload": args.workload,
           "seed": args.seed,
           "setup": {"compile_s": compile_s, "compile_sim_s": compile_sim_s,
                     "compile_sim_share": compile_sim_s / compile_s,
                     "n_compile_sim": names.count("compile_sim"),
                     "n_route_bank": names.count("route_bank"),
                     "warmup_job_s": warm_s, "capture_s": capture_s,
                     **graph_stats(wst)},
           "clock": clock_probe(dev, sync, profile,
                                {ProfilerActivity.CPU, activity}),
           "host_us_per_op": host_us_per_op(dev, sync), "untraced": [],
           "traced": []}

    # ---- jobs with the recorder off and on, in turns ------------------
    def one_job(record: bool, traced: bool) -> dict:
        prof = rec = None
        sync()
        if traced:
            prof = profile(activities=[activity])
            prof.__enter__()
        s_ns = time.time_ns()
        if record:
            with tracing.recording() as rec:
                res = job()
        else:
            res = job()
        e_ns = time.time_ns()
        sync()
        t1_ns = time.time_ns()
        st = res["stats"]
        row = {"record": record, "job_s": (e_ns - s_ns) * 1e-9,
               "campaign_overlap": 100.0 * st["overlap_fraction"],
               "n_ticks": st["n_ticks"], "n_updates": st["n_updates"],
               **graph_stats(st)}
        if not traced:
            return row
        prof.__exit__(None, None, None)
        events = harness.device_events(prof, s_ns, t1_ns,
                                       "CUDA" if cuda else "CPU")
        busy = harness.busy_intervals(events)
        row["idle_share"] = 100.0 * (1 - harness.busy_s(events, 1)
                                     / ((t1_ns - s_ns) * 1e-9))
        row["launches_per_tick"] = len(events) / st["n_ticks"]
        if rec is None:
            return row
        spans = rec.spans
        (camp,) = [s for s in spans if s.name == "campaign"]
        pieces = tracing.timeline(spans, camp.thread)
        job_s = (e_ns - s_ns) * 1e-9

        def mean_us(name):
            d = [s.end_ns - s.start_ns for s in spans if s.name == name]
            return 1e-3 * sum(d) / len(d) if d else None

        split = tracing.idle_by_span(busy, pieces, s_ns, e_ns)
        row.update(
            advance_host_us=mean_us("advance"), update_host_us=mean_us("update"),
            solve_host_us=mean_us("solve"), replay_host_us=mean_us("replay"),
            capture_host_us=mean_us("capture"),
            idle_in_dispatch=100.0 * sum(v[0] for p, v in split.items()
                                         if "dispatch" in p.split(" > ")) / job_s,
            span_cover=sum(min(b, e_ns) - max(a, s_ns) for a, b, _ in pieces
                           if b > s_ns and a < e_ns) * 1e-9 / job_s,
            idle_by_span=sorted(([p, v[0], v[1]] for p, v in split.items()),
                                key=lambda r: -r[1]),
            span_seconds={n: sum(s.end_ns - s.start_ns for s in spans
                                 if s.name == n) * 1e-9
                          for n in sorted({s.name for s in spans})},
            n_spans=len(spans))
        return row

    for traced in (False, True):
        key = "traced" if traced else "untraced"
        for _ in range(args.pairs):
            for record in (False, True):
                out[key].append(one_job(record, traced))
                print(json.dumps(out[key][-1])[:2000], file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
