"""The numbers that decide ``correct``: gaps between what the port's timed
path returned for a job and what the reference gives for the same
scenarios. Each cell's ``checks/<cell>.json`` names the numbers it compares
and the limit of each.

A number is a gap per scenario: of a trajectory, of a link's total over the
run, or of an entry of the epilogue. Every scenario is held to each
number's limit, except where rounding decides it. A check file that names a
second precision of the reference (``"excuse": "float32"``) excuses a
scenario from every number where the reference at that precision itself
lies further from the float64 reference than ``excuse_over`` on any number
that has one (plain float32 moving a scenario that far shows it
ill-conditioned, and the port's own rounding, another draw, may move it many
times further, on any of its numbers), or where the float64 reference marks
the run as decided (``decided``: a drain estimate or an eq. (3) weight that
is a difference of equal numbers at some controller update); and from one
entry of the epilogue where that entry sits at one of its thresholds
(``tie``)."""
from __future__ import annotations

import numpy as np

# the port's seven-metric epilogue, in its order
METRICS = ("avg_tput_mb_s", "final_tput_mb_s", "avg_latency_s", "utilization",
           "dip_depth", "recovery_time_s", "total_sink_mb")
# fractions, compared by their absolute gap; times by their gap over the
# run's horizon; the others relative to the reference's value
ABSOLUTE = ("utilization", "dip_depth")
OF_HORIZON = ("recovery_time_s",)
TRAJECTORIES = ("sink", "latency")
# per link, the megabytes it moved over the whole run
TOTALS = {"link_mb": "link_load"}


def _trajectory_gap(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per scenario: the largest gap over all its ticks, over the largest
    value the reference reaches in the run."""
    S, T = r.shape[:2]
    p, r = p.reshape(S, T, -1).astype(np.float64), r.reshape(S, T, -1)
    scale = np.maximum(np.abs(r).max((1, 2)), 1e-30)
    d = np.abs(p - r)
    d = np.where(np.isnan(d), np.inf, d)
    return d.max((1, 2)) / scale


def _total_gap(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per scenario: the largest gap between a link's total over the run
    on the two sides, over the reference's largest total."""
    p, r = p.astype(np.float64).sum(1), r.sum(1)
    d = np.abs(p - r)
    d = np.where(np.isnan(d), np.inf, d)
    return d.max(1) / np.maximum(np.abs(r).max(1), 1e-30)


def rows_of(out: dict, rows) -> dict:
    """The given scenarios' entries of a stacked output."""
    return {k: v[rows] for k, v in out.items()}


def _metric_gap(name: str, p: np.ndarray, r: np.ndarray,
                horizon_s: float) -> np.ndarray:
    p = p.astype(np.float64)
    both_inf = np.isinf(p) & np.isinf(r) & (np.sign(p) == np.sign(r))
    d = np.abs(np.where(both_inf, 0.0, p - np.where(both_inf, 0.0, r)))
    if name in ABSOLUTE:
        gap = d
    elif name in OF_HORIZON:
        gap = d / horizon_s
    else:
        gap = d / np.maximum(np.abs(r), 1e-30)
    return np.where(np.isnan(p), np.inf, gap)


def gaps(prog: dict, ref: dict, checks: dict, horizon_s: float) -> dict:
    """``{number: [S] gaps}`` for each number ``checks["limits"]`` names: a
    trajectory (``sink``, ``latency``), each link's total over the run
    (``link_mb``) or an entry of the epilogue (``METRICS``)."""
    out = {}
    for name in checks["limits"]:
        if name in TRAJECTORIES:
            out[name] = _trajectory_gap(prog[name], ref[name])
        elif name in TOTALS:
            out[name] = _total_gap(prog[TOTALS[name]], ref[TOTALS[name]])
        elif name in METRICS:
            i = METRICS.index(name)
            out[name] = _metric_gap(name, prog["metrics"][:, i],
                                    ref["metrics"][:, i], horizon_s)
        else:
            raise ValueError(f"unknown number {name!r}")
    return out


def excused(ref: dict, rounding: dict, checks: dict) -> dict:
    """``{number: [S] bool}``: the scenarios that rounding decides for each
    number: those whose gap in ``rounding`` (the reference at the check's
    ``excuse`` precision against the float64 reference ``ref``) exceeds its
    ``excuse_over`` on any number that has one, those ``ref`` marks as
    decided, and for an entry of the epilogue those at its threshold."""
    row = ref["decided"].copy()
    for n, over_gap in checks["excuse_over"].items():
        row |= ~(rounding[n] <= over_gap)
    return {n: row | ref["tie"][:, METRICS.index(n)] if n in METRICS else row
            for n in checks["limits"]}


def over(gap: dict, checks: dict, excuse: dict | None = None) -> dict:
    """``{number: [S] bool}``: the scenarios whose gap exceeds the number's
    limit (a gap that is not a number exceeds it), less those excused."""
    out = {}
    for n, lim in checks["limits"].items():
        o = ~(gap[n] <= lim)
        out[n] = o & ~excuse[n] if excuse else o
    return out
