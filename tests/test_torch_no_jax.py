"""The PyTorch port stands alone: importing every module of
cst_captioning_tpu_torch pulls in neither jax, flax, msgpack, h5py nor
any module of the JAX package (h5py only inside the h5 converter's
body). Checked in a fresh interpreter, since this test process has
imported jax already. Also: chip_smoke.py refuses to run without a GPU and
prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch  # graftlint: disable=GL006

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import cst_captioning_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "h5py",
                                    "cst_captioning_tpu"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr

    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["bad"] == []
    for mod in ("config", "presets", "convert", "models.encoders",
                "models.attention", "models.decoder", "models.captioner",
                "decoding.common", "ops.decode_stride", "ops.build",
                "serving.pages", "serving.engine", "serving.traffic",
                "data.vocab", "ops.attention", "ops.decode_step",
                "decoding.sample", "losses", "metrics", "train.schedule",
                "train.state", "train.steps", "rl.native", "rl.rewards",
                "rl.scst", "data.batcher", "ops.beam_step", "decoding.greedy",
                "decoding.fused", "decoding.beam", "metrics.ngram",
                "metrics.cider", "metrics.bleu", "metrics.rouge",
                "metrics.meteor", "metrics.tokenizer", "metrics.scorer",
                "metrics.native_cider", "eval.evaluator", "utils.logging",
                "resilience.durable", "resilience.retry",
                "resilience.sentinel", "resilience.preempt",
                "data.synthetic", "data.dataset", "data.preprocess",
                "data.prefetch", "ckpt.checkpoint", "ckpt.msgpack",
                "train.trainer", "cli.common", "cli.train", "cli.eval",
                "data.importers", "cli.preprocess", "cli.import_msrvtt",
                "cli.import_msvd", "resilience.chaos",
                "resilience.adaptive", "rl.async_scst", "rl.online",
                "resilience.health", "obs.fleet", "cli.obs_report",
                "train.mesh", "train.multihost", "parallel",
                "parallel.comms", "parallel.submesh",
                "parallel.seq_parallel", "tools", "tools.graftlint",
                "tools.graftlint.core", "tools.graftlint.project",
                "tools.graftlint.rules", "tools.graftlint.fixes",
                "tools.graftlint.cli", "tools.graftlint.__main__",
                "tools.graftlint.contract"):
        assert f"cst_captioning_tpu_torch.{mod}" in rep["modules"]


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package, it fails as well
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
