"""``launches_per_tick``: the traced job's device operations over the ticks
the program counted; nothing where the program keeps no tick counter (a
port before the counter, or a ``simulate`` job, which reports no stats)."""
import pytest

from portbench import run
from portbench.tests import tiny

READ = run.load_module(run.reader_path("launches_per_tick")).read


def ctx(n_events, stats):
    return dict(events=[("op", 0, 1, 0)] * n_events, traced_stats=stats)


@pytest.mark.parametrize("n_events, stats, value", [
    (600, {"n_ticks": 200, "n_updates": 20}, 3.0),
    (600, {"overlap_fraction": 0.5}, None),
    (600, None, None),
    (0, {"n_ticks": 200}, None),
    (600, {"n_ticks": 0}, None)])
def test_reads_operations_over_ticks(n_events, stats, value):
    assert READ(ctx(n_events, stats)) == value


def test_tiny_traced_run_counts_operations_per_tick():
    f = tiny.tiny_files(tiny.CELL)
    f["traffic"]["scenarios"], f["traffic"]["chunk_rows"] = 6, 3
    tiny.shorten(f["traffic"], f["config"], 10.0)
    r = tiny.run_tiny(f, trace=True)
    assert r["correct"] is True
    # the CPU's profiled operations stand in for the card's: every aten op
    # of a tick, tens of them
    assert r["metrics"]["launches_per_tick"]["value"] > 10
    assert r["metrics"]["launches_per_tick"]["unit"] == "ops/tick"
