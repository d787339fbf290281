"""``graph_tick_share``: the share of the window's ticks replayed from CUDA
graphs, the mean over its campaigns; nothing where the program keeps no
such counter (a port before the counter, or a ``simulate`` job, which
reports no stats)."""
import pytest

from portbench import run
from portbench.tests import tiny

READ = run.load_module(run.reader_path("graph_tick_share")).read


@pytest.mark.parametrize("stats, value", [
    ([{"graph_tick_share": 1.0}, {"graph_tick_share": 0.5}], 75.0),
    ([{"graph_tick_share": 0.0, "n_ticks": 200}], 0.0),
    ([{"overlap_fraction": 0.5}], None),
    ([], None)])
def test_reads_the_mean_share_in_percent(stats, value):
    assert READ(dict(stats=stats)) == value


def test_tiny_traced_run_on_the_cpu_replays_nothing():
    f = tiny.tiny_files(tiny.CELL)
    f["traffic"]["scenarios"], f["traffic"]["chunk_rows"] = 6, 3
    tiny.shorten(f["traffic"], f["config"], 10.0)
    r = tiny.run_tiny(f, trace=True)
    assert r["correct"] is True
    # on the CPU every bucket runs eager
    assert r["metrics"]["graph_tick_share"] == {"value": 0.0, "unit": "%"}
