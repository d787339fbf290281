"""Megabytes of route bank a campaign stages for the card, padding
included (``FleetRunner.last_stats["route_bank_bytes"]`` / 1e6), the mean
over the window's campaigns. A program that keeps no such counter reads
nothing."""


def read(ctx):
    v = [s["route_bank_bytes"] for s in ctx["stats"] if "route_bank_bytes" in s]
    return sum(v) / len(v) / 1e6 if v else None
