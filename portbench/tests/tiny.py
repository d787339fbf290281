"""Cells cut to a size the CPU tests run in a second or two, from the
benchmark's own files: the testbed cell at its fabric with one scenario of
each of its 18 kinds in 6-row chunks, its check's limits and ``excuse_over``
a tenth of the cell's, and two fabrics the generator and
the reference also serve, though no cell of the manifest uses them yet: a
fat tree of 4 racks of 2 machines with 4 cores (so that two failed internal
links never cut a rack off), its failed links routed around, under the
campaign with the paper's allocator and under single ``simulate`` runs with
tcp. Every run has 30 simulated seconds with its failure inside. Under the
allocator, scenarios that rounding decides are excused by the check's rule,
as in the benchmark's own runs; tcp's fill has no such scenario here, and
its check holds every one. Any seed serves."""
import copy

from portbench import run

CELL = "testbed-campaign-appaware"
CELLS = (CELL, "fattree-campaign", "fattree-tcp")
SEED = 2**31 + 7

FATTREE_LIMITS = {
    "fattree-campaign": {"final_tput_mb_s": 1e-3, "avg_latency_s": 1e-3,
                         "dip_depth": 3e-4, "recovery_time_s": 1e-3,
                         "total_sink_mb": 1e-4},
    "fattree-tcp": {"sink": 1e-5, "latency": 1e-5, "link_mb": 1e-5,
                    "avg_latency_s": 1e-5, "total_sink_mb": 5e-6}}


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def shorten(traffic: dict, config: dict, seconds: float = 30.0) -> None:
    """``seconds`` simulated seconds, the failure inside them."""
    config["horizon_s"], traffic["warmup_s"] = seconds, 5.0
    traffic["t_event"] = seconds / 3
    traffic["fail"] = dict(traffic["fail"], t_fail=[seconds / 4, seconds / 3],
                           duration=[seconds / 6, seconds / 3])


def tiny_files(cell: str) -> dict:
    f = copy.deepcopy(run.cell_files(bench(), CELL))
    cfg, tr = f["config"], f["traffic"]
    shorten(tr, cfg)
    # one of each of the testbed's 18 kinds; a quarter of the horizon moves
    # the numbers about a tenth as far, and the limits follow
    tr["scenarios"], tr["chunk_rows"] = 18, 6
    if cell == CELL:
        ch = f["checks"]
        f["checks"] = dict(ch, **{k: {n: v / 10 for n, v in ch[k].items()}
                                  for k in ("limits", "excuse_over")})
        return f
    cfg["fabric"] = dict(kind="fat_tree", n_racks=4, machines_per_rack=2, n_cores=4)
    cfg["internal_per_uplink"] = 4.0
    tr.update(apps=["tt"], schedules=["fail"], scenarios=4, chunk_rows=2,
              fail=dict(tr["fail"], links="internal", scale=[0.0, 0.0],
                        reroute=True))
    if cell == "fattree-tcp":
        tr.update(entry="simulate", policy="tcp", solver="sort")
    limits = FATTREE_LIMITS[cell]
    f["checks"] = {"limits": limits}
    if cell == "fattree-campaign":
        f["checks"].update(excuse="float32",
                           excuse_over={n: 0.01 * v for n, v in limits.items()})
    f["cell"] = dict(f["cell"], name=cell)
    return f


def run_tiny(files: dict, trace: bool = False, seed: int = SEED,
             seconds: float = 0.1) -> dict:
    return run.run_cell(files, seed, seconds, trace, "cpu", 0.0, bench())
