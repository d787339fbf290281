"""Device operations per bucket tick in the traced job: every device
activity of the traced window (kernels, copies, fills) over the ticks its
tick loops ran (``FleetRunner.last_stats["n_ticks"]``). A program that does
not count its ticks reads nothing."""


def read(ctx):
    n = (ctx["traced_stats"] or {}).get("n_ticks")
    if not n or not ctx["events"]:
        return None
    return len(ctx["events"]) / n
