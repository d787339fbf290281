"""The share of the window's bucket ticks that ran by replay of a CUDA
graph (``FleetRunner.last_stats["graph_tick_share"]``), the mean over the
window's campaigns. A program that keeps no such counter reads nothing."""


def read(ctx):
    v = [s["graph_tick_share"] for s in ctx["stats"] if "graph_tick_share" in s]
    return 100.0 * sum(v) / len(v) if v else None
