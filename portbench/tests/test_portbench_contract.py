"""The manifest: every entry resolves to its files, names and units keep to
their characters, every per-layer metric moves an end-to-end metric that
each of its cells reports, and the bounds and the run length keep to the
benchmark's rules."""
import json
import re

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def cells_of(metric):
    return metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    f = run.cell_files(BENCH, cell)
    assert f["cell"]["chips"] in (1, 4)
    assert f["traffic"]["policy"] in ("tcp", "appaware")
    assert f["checks"]["limits"]
    assert all(v >= 0 for v in f["checks"]["limits"].values())
    assert set(f["checks"].get("excuse_over", {})) <= set(f["checks"]["limits"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert conf["file"].startswith("portbench/configs/")
    data = run.load_json(run.ROOT / conf["file"])
    assert data["name"] == conf["name"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(cells_of(metric)) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert run.reader_path(metric["name"]).exists()
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(cells_of(metric)) <= set(cells_of(moved))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in cells_of(m) for m in BENCH["per_layer"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


def test_a_split_metric_without_a_file_of_its_own_is_read_by_its_base():
    assert run.reader_path("idle_share.campaign") == run.HERE / "metrics" / "idle_share.py"
    assert run.reader_path("compile_s") == run.HERE / "metrics" / "compile_s.py"
