"""Share of the traced job's wall time in which no operation ran on the
device: 1 − (union of the device's activity intervals) / traced window,
averaged over the devices the run uses."""


def read(ctx):
    if not ctx["events"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
