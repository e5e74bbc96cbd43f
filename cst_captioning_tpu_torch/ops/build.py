"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into a shared library with
a plain C interface under ``ops/_build/`` (git-ignored), named by a hash of
every source under ``csrc/`` (a ``.cu`` may include another) and the flags
so an edited source or header rebuilds. No PyTorch headers
are involved, so a build takes seconds. A failed build raises with the
compiler's output. Each build feeds ``jit.compiles`` and
``jit.compile_seconds`` (``obs.metrics.record_compile``; with builds
started together, each one's seconds run from its start to its end).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from cst_captioning_tpu_torch.obs.metrics import record_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # name -> nvcc/ptxas output of its build


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cu*")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists -> (out, proc)."""
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, time.perf_counter())


def _finish(name: str, out: Path, started) -> None:
    if started is None:
        return
    proc, tmp, t0 = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial library
    # the obs report's "jit" compile line counts these builds in the port
    record_compile(time.perf_counter() - t0)


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``), one nvcc
    process each, all started together."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    for n, (out, st) in started.items():
        _finish(n, out, st)
    return {n: out for n, (out, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
