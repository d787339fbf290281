"""The port's examples (``examples/port_*.py``) against the JAX package's,
run the same way on the CPU: ``REPRO_SMOKE=1`` and the same smaller module
constants on both sides. The numbers each prints (rounded as printed) agree
at 1e-4 relative, and the text around them is the same.

``port_serve_decode.py``, ``port_train_lm.py`` and the LM half of
``port_quickstart.py`` draw their weights from a ``torch.Generator``, not
from ``jax.random``, so their tokens and losses differ from the JAX
examples': the tests hold the counts instead (requests, tokens, steps, the
driver's events, the uniform-loss baseline), and the LM and its training
are held to JAX in tests/test_torch_lm.py and tests/test_torch_train*.py.
The stream half of the quickstart prints numbers held at 1e-4 as above."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

# module constants set smaller on both sides, and which printed lines hold
# results (the rest are wall times and runner statistics)
SMALL = {
    "multiapp_fairness": {},
    "stream_allocator_demo": {"CAPS": {"10Mbps": 1.25}},
    "dynamic_failure": {},
    "fleet_sweep": {"SECONDS": 30.0},
    "campaign_sweep": {"N": 24, "SECONDS": 30.0},
}


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _result_lines(name: str, out: str) -> list[str]:
    lines = out.splitlines()
    if name == "fleet_sweep":      # the scenario table
        start = next(i for i, ln in enumerate(lines)
                     if ln.startswith("scenario"))
        end = lines.index("", start)
        return lines[start:end]
    if name == "campaign_sweep":   # the per-axis tables
        start = next(i for i, ln in enumerate(lines) if ln.startswith("by app"))
        end = next(i for i, ln in enumerate(lines) if ln.startswith("wall:"))
        return lines[start:end]
    return lines


def _run(name, prefix, capsys, monkeypatch, argv):
    mod = _load(EXAMPLES / f"{prefix}{name}.py")
    for k, v in SMALL.get(name, {}).items():
        monkeypatch.setattr(mod, k, v)
    capsys.readouterr()
    if prefix:
        ret = mod.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", [f"{name}.py"])
        ret = mod.main()
    return capsys.readouterr().out, ret


@pytest.mark.parametrize("name", list(SMALL))
def test_port_example_prints_the_jax_numbers(name, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    want, _ = _run(name, "", capsys, monkeypatch, None)
    got, _ = _run(name, "port_", capsys, monkeypatch, ["--device", "cpu"])
    want_l, got_l = _result_lines(name, want), _result_lines(name, got)
    assert len(got_l) == len(want_l) and got_l, (got, want)
    for g, w in zip(got_l, want_l):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        gn = [float(x) for x in NUM.findall(g)]
        wn = [float(x) for x in NUM.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=1e-4, atol=0.0,
                                   err_msg=f"{g!r} vs {w!r}")


def test_port_multiapp_fairness_returns_its_numbers(capsys):
    out = _load(EXAMPLES / "port_multiapp_fairness.py").main(
        ["--device", "cpu"])
    assert abs(out["tcp_jain"] - 0.818) < 1e-3
    np.testing.assert_allclose(out["tcp"], 100 * np.arange(1, 6) / 15,
                               rtol=1e-6)
    for alpha, (avg, jain) in out["appfair"].items():
        assert jain >= 0.98, alpha
        np.testing.assert_allclose(avg, 20.0, rtol=1e-5)


def test_port_serve_decode_counts_match_jax(capsys, monkeypatch):
    args = ["--requests", "4", "--new-tokens", "6", "--slots", "2"]
    jax_mod = _load(EXAMPLES / "serve_decode.py")
    monkeypatch.setattr(sys, "argv", ["serve_decode.py", *args])
    capsys.readouterr()
    jax_mod.main()
    want = capsys.readouterr().out.splitlines()
    reqs = _load(EXAMPLES / "port_serve_decode.py").main(
        [*args, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    counts = re.compile(r"— (\d+) requests, (\d+) tokens")
    assert counts.search(got[0]).groups() == counts.search(want[0]).groups()
    assert got[0].startswith("arch=yi-6b (reduced)")
    assert len(got) == len(want) == 1 + 4
    assert all(r.done and len(r.out) == 6 for r in reqs)
    for g, w in zip(got[1:], want[1:]):
        assert len(NUM.findall(g)) == len(NUM.findall(w))


@pytest.fixture
def one_torch_thread():
    """A training example's tiny model is many small ops a step, which
    torch's thread pool only slows, and badly when other test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numbers(line: str) -> list[float]:
    return [float(x) for x in NUM.findall(line)]


@pytest.mark.usefixtures("one_torch_thread")
def test_port_train_lm_counts_match_jax(capsys, monkeypatch, tmp_path):
    """The same run on both sides (6 steps, checkpoints every 3, a failure
    injected at step 4): the same printed lines, parameter count, steps,
    uniform baseline and driver events (restart from the step-3
    checkpoint). The JAX driver's restore does not wait for a save still
    on its thread, so its saves are made blocking here (the port's restore
    waits for it)."""
    from repro.train.checkpoint import Checkpointer as JaxCheckpointer

    monkeypatch.setattr(JaxCheckpointer, "save_async",
                        lambda self, step, state: self.save(step, state))
    args = ["--steps", "6", "--ckpt-every", "3", "--inject-failure", "4",
            "--batch", "4", "--seq", "32"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir",
                                      str(tmp_path / "jax")])
    capsys.readouterr()
    _load(EXAMPLES / "train_lm.py").main()
    want = capsys.readouterr().out.splitlines()
    drv = _load(EXAMPLES / "port_train_lm.py").main(
        [*args, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
    assert got[0] == want[0]                      # arch, preset, params
    assert _numbers(got[1])[0] == _numbers(want[1])[0] == 6
    assert _numbers(got[2])[-1] == _numbers(want[2])[-1]   # ln(V)
    assert got[3:] == want[3:]                    # failure, restart
    assert drv.events[-1] == (3, "restart-from-ckpt")
    assert all(np.isfinite(m["loss"]) for m in drv.metrics)


@pytest.mark.usefixtures("one_torch_thread")
def test_port_quickstart_matches_jax(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    jax_mod = _load(EXAMPLES / "quickstart.py")
    capsys.readouterr()
    jax_mod.stream_demo()
    jax_mod.lm_demo()
    want = capsys.readouterr().out.splitlines()
    req = _load(EXAMPLES / "port_quickstart.py").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
    for g, w in zip(got[:3], want[:3]):          # the stream demo
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-4,
                                   atol=0.0, err_msg=f"{g!r} vs {w!r}")
    steps = [_numbers(g)[0] for g in got[4:9]]
    assert steps == [_numbers(w)[0] for w in want[4:9]] == [0, 10, 20, 30,
                                                               40]
    assert len(req.out) == 8 and req.done


@pytest.mark.usefixtures("one_torch_thread")
def test_port_comm_schedule_plans_the_traced_step(capsys):
    """The JAX example compiles a step on 8 host devices, which a test
    process that has started JAX cannot fake; the port's example traces
    its step on meta tensors in a dry world. Held here: its lines in the
    JAX example's format, flows on both mesh axes, and a feasible
    schedule at the H100's link rate."""
    from repro_torch.launch.mesh import NVLINK_BW
    flows, sched = _load(EXAMPLES / "port_comm_schedule.py").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(flows) > 0
    assert out[0] == (f"extracted {len(flows)} collective flows from the "
                      "traced step")
    axes = {}
    for ln in out[1:3]:
        m = re.fullmatch(r"  axis (\w+) *: +(\d+) flows, +([\d.]+) MB/step",
                         ln)
        assert m, ln
        axes[m.group(1)] = int(m.group(2))
    assert axes == {a: sum(f.axis == a for f in flows)
                    for a in ("data", "model")}
    assert re.fullmatch(r"allocator schedule: total comm [\d.]+ ms, exposed "
                        r"\(not overlapped\) [\d.]+ ms", out[3]), out[3]
    assert out[4].startswith("top-5 most urgent flows")
    assert len(out) == 10
    for ln, i in zip(out[5:], sched.order[:5]):
        assert ln.split()[0] == flows[i].kind
        assert f"axis={flows[i].axis}" in ln
    for a in ("data", "model"):
        tot = sum(r for r, f in zip(sched.rates, flows) if f.axis == a)
        assert 0 < tot <= NVLINK_BW * 1.001


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("port_*.py")),
                         ids=lambda p: p.stem)
def test_port_example_defaults_to_the_card(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(path).main([])
