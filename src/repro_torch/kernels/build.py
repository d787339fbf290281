"""Build the port's CUDA kernels and bind them with ctypes.

Each kernel source under ``repro_torch/kernels/<name>/csrc/`` has a plain
``extern "C"`` launcher, so it compiles in seconds with ``nvcc`` alone (no
PyTorch headers) into ``build/kernels/lib<name>.so`` at the repository
root, a directory git ignores. The build runs at first use in a process
and again whenever the source, or a shared header ``kernels/*.cuh`` it may
include, is newer than the library; the loaded library is cached for the
life of the process; :func:`build_all` starts one
``nvcc`` per stale source at once. ``-Xptxas -v`` reports each
kernel's registers and shared memory; the report is kept beside the
library (``<name>.ptxas.txt``) and in :data:`BUILD_INFO`.

Nothing here runs at import: this module is imported on machines that have
no CUDA toolkit, where only the plain versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when the library was current),
#          "ptxas": the -Xptxas -v report}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (nvcc on PATH or under "
                           "/usr/local/cuda)")
    return path


def build_all(sources: dict[str, Path]) -> dict[str, Path]:
    """Compile each ``name -> source`` into ``BUILD_DIR/lib<name>.so`` unless
    the library is newer than the source and the shared headers: one nvcc
    process per stale source, all started together. Raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = tuple(Path(__file__).resolve().parent.glob("*.cuh"))
    libs, running = {}, {}
    for name, source in sources.items():
        lib = libs[name] = BUILD_DIR / f"lib{name}.so"
        report = BUILD_DIR / f"{name}.ptxas.txt"
        newest = max(p.stat().st_mtime for p in (source, *headers))
        if lib.exists() and lib.stat().st_mtime >= newest:
            BUILD_INFO.setdefault(name, {
                "seconds": 0.0,
                "ptxas": report.read_text() if report.exists() else ""})
            continue
        # build under a private name and rename: concurrent processes never
        # load a half-written library
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        # nvcc's output goes to a file: pipes read one after another could
        # stall a later build on a full pipe
        log = BUILD_DIR / f"{name}.{os.getpid()}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, log, time.perf_counter())
    failures = []
    for name, (proc, tmp, log, t0) in running.items():
        proc.wait()
        seconds = time.perf_counter() - t0
        text = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building "
                            f"{sources[name]}:\n{text}")
            continue
        os.replace(tmp, libs[name])
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(text)
        BUILD_INFO[name] = {"seconds": seconds, "ptxas": text}
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def build(name: str, source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR/lib<name>.so`` unless the library
    is newer than the source. Raises with nvcc's output on failure."""
    return build_all({name: source})[name]


def load(name: str, source: Path) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name, source)))
    return _LIBS[name]
