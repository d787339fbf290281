"""What the benchmark runs loads no JAX and nothing of the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the port."""
import subprocess
import sys

import pytest

from portbench import run

PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {names!r}))
"""


def loaded(imports: str, names) -> list:
    code = PROBE.format(root=str(run.ROOT), src=str(run.ROOT / "src"),
                        imports=imports, names=set(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_harness_and_port_load_no_jax():
    imports = "\n".join([
        "from portbench import run, program, scenario, control",
        "from portbench.reference import sim, compare",
        "import repro_torch.streams, repro_torch.kernels.waterfill.ops",
    ] + [f"run.load_module(run.reader_path({p.stem!r}))"
         for p in sorted((run.HERE / "metrics").glob("*.py"))])
    assert loaded(imports, run.FORBIDDEN) == []


@pytest.mark.parametrize("module", ["portbench.reference.sim",
                                    "portbench.reference.compare",
                                    "portbench.scenario"])
def test_reference_loads_nothing_of_the_program(module):
    assert loaded(f"import {module}", run.FORBIDDEN + ("repro_torch",)) == []
