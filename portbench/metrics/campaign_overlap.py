"""The campaign pipeline's overlap: the share of the host's staging seconds
that ran while a chunk computed, among those that could have
(``FleetRunner.last_stats["overlap_fraction"]``), the mean over the window's
campaigns."""


def read(ctx):
    v = [s["overlap_fraction"] for s in ctx["stats"] if "overlap_fraction" in s]
    return 100.0 * sum(v) / len(v) if v else None
