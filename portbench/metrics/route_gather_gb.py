"""Gigabytes of routing matrix a campaign's tick loops gather from the
route bank, rows × flows × links × 4 bytes a tick of a rerouting chunk,
replayed or eager (``FleetRunner.last_stats["route_gather_bytes"]`` / 1e9),
the mean over the window's campaigns. A program that keeps no such counter
reads nothing."""


def read(ctx):
    v = [s["route_gather_bytes"] for s in ctx["stats"] if "route_gather_bytes" in s]
    return sum(v) / len(v) / 1e9 if v else None
