"""The port must run on a machine that has no JAX: no module of
``src/repro_torch/`` and not ``chip_smoke.py`` may import ``jax`` or anything
of the JAX package ``repro``. Checked statically (every import statement,
with ``ast``) and by importing the entry points in a subprocess where
``jax`` and ``repro`` cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                 "kernels/waterfill/ops.py", "streams/simulator.py"):
        assert must in names


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
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.ssd_scan.ops
import repro_torch.kernels.waterfill.ops
import repro_torch.streams
from repro_torch.models.registry import list_archs
assert list_archs() == ["mamba2-370m", "qwen1.5-0.5b", "zamba2-1.2b"]
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print("ok")
"""


def test_entry_points_import_without_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
