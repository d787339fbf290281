"""A traced run of each cell cut to a tiny size on the CPU: the per-layer
metrics its readers find, the device's busy and window seconds, and the
breakdown. The profiler records every operation on the CPU, so the cells
are cut further: two scenarios of each app and schedule, 10 simulated
seconds."""
import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tiny_traced_run_reads_its_layers(cell):
    f = tiny.tiny_files(cell)
    tr = f["traffic"]
    tr["scenarios"] = 2 * len(tr["apps"]) * len(tr["schedules"])
    tr["chunk_rows"] = tr["scenarios"] // 2
    tiny.shorten(tr, f["config"], 10.0)
    r = tiny.run_tiny(f, trace=True)
    assert r["correct"] is True
    wanted = {m["name"] for m in tiny.bench()["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == wanted
    d = r["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
