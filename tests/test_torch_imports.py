"""The port must run on a machine that has no JAX: no module of
``src/repro_torch/``, not ``chip_smoke.py``, ``tools/port_profile.py`` or any
``examples/port_*.py`` may import ``jax`` or anything of the JAX package
``repro``. Checked statically
(every import statement, with ``ast``) and by importing the entry points and
the examples in a subprocess where ``jax`` and ``repro`` cannot be
imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py"))
         + [ROOT / "chip_smoke.py", ROOT / "tools" / "port_profile.py"]
         + sorted((ROOT / "examples").glob("port_*.py")))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            found.append(node.args[0].value)
    return found


def test_guard_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    for must in ("serve/engine.py", "models/lm.py", "models/convert.py",
                 "kernels/flash_attention/ops.py", "kernels/ssd_scan/ops.py",
                 "kernels/waterfill/ops.py", "streams/simulator.py",
                 "core/tcp.py", "core/multiapp.py", "configs/paper_stream.py",
                 "configs/yi_6b.py", "models/whisper.py",
                 "configs/qwen3_moe_235b.py", "configs/whisper_tiny.py",
                 "data/pipeline.py", "train/optim.py", "train/step.py",
                 "train/compression.py", "train/checkpoint.py",
                 "train/driver.py", "sharding/policy.py", "launch/mesh.py",
                 "launch/shardings.py", "launch/comm_stats.py",
                 "core/scheduler.py", "kernels/local.py"):
        assert must in names
    examples = {p.name for p in FILES if p.parent.name == "examples"}
    for must in ("port_multiapp_fairness.py", "port_stream_allocator_demo.py",
                 "port_dynamic_failure.py", "port_fleet_sweep.py",
                 "port_campaign_sweep.py", "port_serve_decode.py",
                 "port_train_lm.py", "port_quickstart.py",
                 "port_comm_schedule.py"):
        assert must in examples


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax\nfrom repro.models import lm\n"
                     "import repro_torch\nfrom jax import numpy\n"
                     "importlib.import_module('repro.core')\n")
    bad = [m for m in _imports(probe) if _forbidden(m)]
    assert bad == ["jax", "repro.models", "jax", "repro.core"]


_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
import repro_torch.serve.engine
import repro_torch.models.convert
import repro_torch.models.whisper
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.ssd_scan.ops
import repro_torch.kernels.waterfill.ops
import repro_torch.kernels.local
import repro_torch.streams
import repro_torch.core
import repro_torch.configs.paper_stream
import repro_torch.data
import repro_torch.train
import repro_torch.train.compression
import repro_torch.train.driver
import repro_torch.sharding.policy
import repro_torch.launch.mesh
import repro_torch.launch.shardings
import repro_torch.launch.comm_stats
import repro_torch.core.scheduler
import runpy
for ex in sorted(__import__("pathlib").Path("examples").glob("port_*.py")):
    runpy.run_path(str(ex), run_name="example")
from repro_torch.models.registry import list_archs
assert list_archs() == ["dbrx-132b", "internvl2-1b", "mamba2-370m",
                        "qwen1.5-0.5b", "qwen3-moe-235b-a22b", "stablelm-1.6b",
                        "starcoder2-15b", "whisper-tiny", "yi-6b",
                        "zamba2-1.2b"]
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print("ok")
"""


def test_entry_points_import_without_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_core_exports_every_name_of_the_reference():
    """``repro_torch.core`` exports every public name of ``repro.core``
    (the scheduler is a module of its own in both, as in the JAX
    package)."""
    import repro.core as jcore
    import repro_torch.core as tcore
    want = {n for n in vars(jcore) if not n.startswith("_")}
    got = {n for n in vars(tcore) if not n.startswith("_")}
    assert want - {"scheduler"} <= got
    import repro.core.scheduler as jsched
    import repro_torch.core.scheduler as tsched
    for name in ("CollectiveFlow", "CommSchedule", "extract_flows",
                 "plan_schedule"):
        assert hasattr(jsched, name) and hasattr(tsched, name)
