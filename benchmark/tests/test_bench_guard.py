"""No JAX in the benchmark: by whole top-level module name."""

import subprocess
import sys
from pathlib import Path

from benchmark import guard

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    assert guard.banned_modules(["cst_captioning_tpu_torch.ops",
                                 "jaxtyping", "numpy"]) == []
    assert guard.banned_modules(["jax.numpy", "flax.linen",
                                 "cst_captioning_tpu.ops", "jaxlib"]) == \
        ["cst_captioning_tpu", "flax", "jax", "jaxlib"]


def test_no_benchmark_module_loads_jax():
    code = (
        "import sys\n"
        "import benchmark.run, benchmark.control, benchmark.drivers\n"
        "import benchmark.checks, benchmark.faults, benchmark.readers\n"
        "from benchmark import cells, guard, kinds, run\n"
        "for m in cells.manifest()['per_layer']:\n"
        "    run.reader(m['name'])\n"
        "for w in cells.manifest()['workloads']:\n"
        "    kinds.load(cells.Cell(w['name']).kind)\n"
        "import cst_captioning_tpu_torch.rl.scst\n"
        "import cst_captioning_tpu_torch.train.steps\n"
        "print(','.join(guard.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_run_refuses_without_card_and_prints_nothing(tmp_path):
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'cst_msrvtt', '--seed', "
            "'4294967311', '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_data", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "cst_msrvtt",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""
