"""The port's graftlint (``cst_captioning_tpu_torch.tools.graftlint``): a
positive and a negative fixture for every ported rule, the engine (baseline,
suppressions, ``--json``, ``--fix``, ``--check-stale``), the rules whose
meaning did not change held against the JAX lint on one source, hazards
planted in copies of real port files, the repo gate, and a fresh-interpreter
probe that the lint imports neither torch, numpy, JAX nor the JAX package.

Pure AST analysis: nothing here builds a model or touches a device except
the contract regeneration, which builds the presets' models at a few units
of width on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from cst_captioning_tpu.tools.graftlint import lint_paths as jax_lint_paths
from cst_captioning_tpu_torch.tools.graftlint import (
    Baseline,
    all_rules,
    lint_paths,
)
from cst_captioning_tpu_torch.tools.graftlint import contract as contract_mod
from cst_captioning_tpu_torch.tools.graftlint.cli import main as cli_main
from cst_captioning_tpu_torch.tools.graftlint.rules import CONTRACT_RELPATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "graftlint_torch")
PKG = "cst_captioning_tpu_torch"


def _write(root, files: dict) -> None:
    for rel, src in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(src)


def _lint(root, rules=None, **kw):
    return lint_paths([str(root)], str(root), rule_ids=rules, cache_path="",
                      **kw)


# ---- a positive and a negative fixture for every ported rule ---------------

CONTRACT = {"params": ["params/cell/out_proj/kernel",
                       "params/cell/out_proj/bias",
                       "params/cell/lstm0/hi/kernel"]}

CASES = {
    # rule: (positive files, expected findings, negative files)
    "GL001": ({
        f"{PKG}/train/loop.py": (
            "import torch\n\n\n"
            "def fit(model, batches):\n"
            "    for x in batches:\n"
            "        loss = model(x).sum()\n"
            "        seen = loss.item()\n"),
        f"{PKG}/train/steps.py": (
            "import torch\n\n\n"
            "def _apply(loss):\n"
            "    return {'loss': float(loss)}\n\n\n"
            "def make_step(model):\n"
            "    def step(x):\n"
            "        return _apply(model(x))\n"
            "    return step\n"),
    }, 2, {
        f"{PKG}/train/loop.py": (
            "import torch\n\n\n"
            "def fit(model, batches, every):\n"
            "    for i, x in enumerate(batches):\n"
            "        loss = model(x).sum()\n"
            "        if i % every == 0:\n"
            "            print(loss.item())\n"),
        f"{PKG}/models/head.py": (
            "import torch\n\n\n"
            "def fit(model, batches):\n"
            "    for x in batches:\n"
            "        model(x).sum().item()\n"),
    }),
    "GL002": ({
        f"{PKG}/rl/draw.py": (
            "import torch\n\n\n"
            "def draw(n, seed):\n"
            "    torch.manual_seed(0)\n"
            "    a = torch.rand(n)\n"
            "    g1, g2 = torch.Generator(), torch.Generator()\n"
            "    g1.manual_seed(seed)\n"
            "    g2.manual_seed(seed)\n"
            "    return a, g1, g2\n"),
    }, 3, {
        f"{PKG}/rl/draw.py": (
            "import torch\n"
            "import torch.nn.functional as F\n\n\n"
            "def draw(x, n, seed):\n"
            "    g1, g2 = torch.Generator(), torch.Generator()\n"
            "    g1.manual_seed(seed)\n"
            "    g2.manual_seed(seed + 1)\n"
            "    y = F.dropout(x, 0.5, training=False)\n"
            "    return torch.rand(n, generator=g1), y, g2\n"),
    }),
    "GL003": ({
        f"{PKG}/decoding/loop.py": (
            "import torch\n\n\n"
            "def run(x, steps):\n"
            "    for _ in range(steps):\n"
            "        x = torch.tanh(x)\n"
            "        if (x > 0.5).any():\n"
            "            break\n"
            "    return x\n"),
    }, 1, {
        f"{PKG}/decoding/loop.py": (
            "import torch\n\n\n"
            "def run(x, steps, buf=None):\n"
            "    for i in range(steps):\n"
            "        x = torch.tanh(x)\n"
            "        if buf is not None and i > 2:\n"
            "            buf.append(x)\n"
            "    return x\n"),
    }),
    "GL005": ({
        f"{PKG}/models/head.py": (
            "import torch\n\n\n"
            "def head(x, dtype):\n"
            "    bias = torch.zeros(4, dtype=torch.float32)\n"
            "    return x.float() + bias\n"),
    }, 2, {
        f"{PKG}/models/head.py": (
            "import torch\n\n\n"
            "def head(x, dtype):\n"
            "    return x.to(dtype) + torch.zeros(4, dtype=dtype)\n"),
        f"{PKG}/train/loss.py": (
            "import torch\n\n\n"
            "def loss(x):\n"
            "    return x.float().sum()\n"),
    }),
    "GL006": ({
        f"{PKG}/models/bad.py": (
            "import jax\n"
            "import torch\n\n"
            "HAS_CARD = torch.cuda.is_available()\n"
            "ZERO = torch.zeros(1, device='cuda')\n"),
    }, 3, {
        f"{PKG}/models/good.py": (
            "import torch\n\n\n"
            "def has_card():\n"
            "    return torch.cuda.is_available()\n\n\n"
            "if __name__ == '__main__':\n"
            "    print(torch.zeros(1, device='cuda'))\n"),
    }),
    "GL007": ({
        f"{PKG}/train/mesh.py": (
            "PARAM_PARTITION_RULES = (\n"
            "    ('output_head', r'params/cell/out_proj/.*', ()),\n"
            "    ('word_embed', r'params/cell/word_embed/.*', ()),\n"
            ")\n"),
        CONTRACT_RELPATH: json.dumps(CONTRACT),
    }, 2, {
        f"{PKG}/train/mesh.py": (
            "PARAM_PARTITION_RULES = (\n"
            "    ('output_head', r'params/cell/out_proj/.*', ()),\n"
            "    ('decoder_lstm', r'params/cell/lstm\\d+/.*', ()),\n"
            ")\n"),
        CONTRACT_RELPATH: json.dumps(CONTRACT),
    }),
    "GL008": ({
        "tests/test_torch_toy.py": (
            "import torch\n\n\n"
            "def test_on_card():\n"
            "    assert torch.zeros(2, device='cuda').sum() == 0\n"),
    }, 1, {
        "tests/test_torch_toy.py": (
            "import pytest\n"
            "import torch\n\n\n"
            "@pytest.mark.gpu\n"
            "def test_on_card():\n"
            "    assert torch.zeros(2, device='cuda').sum() == 0\n\n\n"
            "def test_device_value_needs_no_card():\n"
            "    assert torch.device('cuda').type == 'cuda'\n"),
    }),
    "GL009": ({
        f"{PKG}/ckpt/io.py": (
            "def load(path):\n"
            "    try:\n"
            "        return open(path).read()\n"
            "    except Exception:\n"
            "        pass\n"),
    }, 1, {
        f"{PKG}/ckpt/io.py": (
            "def load(path, log):\n"
            "    try:\n"
            "        return open(path).read()\n"
            "    except OSError as e:\n"
            "        log('load_failed', error=str(e))\n"),
    }),
    "GL010": ({
        f"{PKG}/train/clock.py": (
            "import time\n\n\n"
            "def step():\n"
            "    t = time.time()\n"
            "    print(t)\n"),
    }, 2, {
        f"{PKG}/cli/report.py": (
            "import time\n\n\n"
            "def main():\n"
            "    print(time.time())\n"),
    }),
    "GL011": ({
        f"{PKG}/decoding/carry.py": (
            "import torch\n\n\n"
            "def decode(steps):\n"
            "    c = torch.zeros(4, dtype=torch.float32)\n"
            "    for _ in range(steps):\n"
            "        c = (c + 1).to(torch.bfloat16)\n"
            "    return c\n"),
    }, 1, {
        f"{PKG}/decoding/carry.py": (
            "import torch\n\n\n"
            "def decode(steps):\n"
            "    c = torch.zeros(4, dtype=torch.bfloat16)\n"
            "    for _ in range(steps):\n"
            "        c = (c + 1).to(torch.bfloat16)\n"
            "    return c\n"),
    }),
    "GL012": ({
        f"{PKG}/train/grid.py": (
            "from cst_captioning_tpu_torch.train.mesh import make_mesh\n\n\n"
            "def grid(mesh):\n"
            "    m = make_mesh(axis='dat')\n"
            "    return m, mesh.row.axis == 'sq'\n"),
    }, 2, {
        f"{PKG}/train/grid.py": (
            "from cst_captioning_tpu_torch.train.mesh import make_mesh\n\n\n"
            "def grid(mesh):\n"
            "    m = make_mesh(axis='data', seq_axis='seq')\n"
            "    return m, mesh.row.axis == 'mp'\n"),
    }),
    "GL015": ({
        f"{PKG}/train/mesh.py": (
            "def make_mesh(axis='data', seq_axis='seq'):\n"
            "    for n, row_axis in ((2, seq_axis), (2, 'mp')):\n"
            "        pass\n\n\n"
            "MP_PARAM_PARTITION_RULES = (\n"
            "    ('output_head', r'params/cell/out_proj/.*', (None, 'mpp')),\n"
            ")\n"),
    }, 1, {
        f"{PKG}/train/mesh.py": (
            "def make_mesh(axis='data', seq_axis='seq'):\n"
            "    for n, row_axis in ((2, seq_axis), (2, 'mp')):\n"
            "        pass\n\n\n"
            "MP_PARAM_PARTITION_RULES = (\n"
            "    ('output_head', r'params/cell/out_proj/.*', (None, 'mp')),\n"
            ")\n"),
    }),
    "GL016": ({
        f"{PKG}/parallel/reduce.py": (
            "import torch.distributed as dist\n\n\n"
            "def reduce(t):\n"
            "    dist.all_reduce(t)\n"
            "    dist.broadcast(t, src=0, group=None)\n"),
    }, 2, {
        f"{PKG}/parallel/reduce.py": (
            "import torch.distributed as dist\n\n\n"
            "def reduce(t, mesh):\n"
            "    dist.all_reduce(t, group=mesh.group)\n"),
        f"{PKG}/train/multihost.py": (
            "import torch.distributed as dist\n\n\n"
            "def barrier():\n"
            "    dist.barrier()\n"),
    }),
    "GL018": ({
        f"{PKG}/train/mesh.py": (
            "MP_PARAM_PARTITION_RULES = (\n"
            "    ('head', r'params/cell/out_proj/.*', ()),\n"
            "    ('head_kernel', r'params/cell/out_proj/kernel', ()),\n"
            "    ('lstm', r'params/cell/lstm\\d+/.*', ()),\n"
            ")\n"),
        CONTRACT_RELPATH: json.dumps(CONTRACT),
    }, 1, {
        f"{PKG}/train/mesh.py": (
            "MP_PARAM_PARTITION_RULES = (\n"
            "    ('head_kernel', r'params/cell/out_proj/kernel', ()),\n"
            "    ('head', r'params/cell/out_proj/.*', ()),\n"
            "    ('lstm', r'params/cell/lstm\\d+/.*', ()),\n"
            ")\n"),
        CONTRACT_RELPATH: json.dumps(CONTRACT),
    }),
    "GL019": ({
        f"{PKG}/parallel/comms.py": (
            "import torch\n"
            "import torch.distributed as dist\n\n\n"
            "def reduce(mesh):\n"
            "    n = 4 if dist.get_rank() == 0 else 3\n"
            "    buf = torch.zeros(n)\n"
            "    dist.all_reduce(buf, group=mesh.group)\n"
            "    tail = torch.zeros(8)[:mesh.rank]\n"
            "    dist.all_reduce(tail, group=mesh.group)\n"),
    }, 2, {
        f"{PKG}/parallel/comms.py": (
            "import torch\n"
            "import torch.distributed as dist\n\n\n"
            "def reduce(mesh):\n"
            "    buf = torch.zeros(4)\n"
            "    if mesh.rank == 0:\n"
            "        buf += 1\n"
            "    dist.all_reduce(buf, group=mesh.group)\n"),
    }),
}
FIXTURE_CASES = {"GL013": ("gl013_pos", 3, "gl013_neg"),
                 "GL020": ("gl020_pos", 5, "gl020_neg")}
PORTED = sorted(set(CASES) | set(FIXTURE_CASES))


def _case_root(tmp_path, rule: str, positive: bool) -> str:
    if rule in FIXTURE_CASES:
        pos, _, neg = FIXTURE_CASES[rule]
        return os.path.join(FIXTURES, pos if positive else neg)
    files = CASES[rule][0 if positive else 2]
    _write(tmp_path, files)
    return str(tmp_path)


@pytest.mark.parametrize("rule", PORTED)
def test_rule_fires_on_its_positive_fixture(tmp_path, rule):
    want = (FIXTURE_CASES[rule][1] if rule in FIXTURE_CASES
            else CASES[rule][1])
    found = _lint(_case_root(tmp_path, rule, True), rules=[rule]).findings
    assert [f.rule for f in found] == [rule] * want, [
        (f.rule, f.path, f.line, f.message) for f in found]


@pytest.mark.parametrize("rule", PORTED)
def test_rule_is_quiet_on_its_negative_fixture(tmp_path, rule):
    found = _lint(_case_root(tmp_path, rule, False), rules=[rule]).findings
    assert found == [], [(f.rule, f.path, f.line, f.message) for f in found]


def test_registry_is_the_ported_rules_and_no_more():
    """Every JAX rule with a counterpart is registered under its JAX id;
    GL004, GL014 and GL017 have none (README table) and are absent."""
    assert sorted(all_rules()) == PORTED
    for rid in ("GL004", "GL014", "GL017"):
        assert rid not in all_rules()
    readme = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    section = readme[readme.index("## Static analysis of the port"):]
    for rid in PORTED + ["GL004", "GL014", "GL017"]:
        assert f"| {rid} |" in section, rid


def test_gl020_holds_the_four_mirrors_against_their_structs():
    """GL020 reads every ctypes mirror of the port against its C struct and
    every argtypes/restype against its extern "C" declaration: the real
    ops/ modules lint clean, and the parse sees all four pairs."""
    from cst_captioning_tpu_torch.tools.graftlint.rules import (
        parse_c,
        read_c,
    )

    ops = os.path.join(REPO, PKG, "ops")
    sizes = {}
    for src, struct in (("decode_step.cu", "StepArgs"),
                        ("beam_step.cu", "BeamArgs"),
                        ("additive_attention.cu", "AttentionArgs"),
                        ("decode_stride.cu", "StrideArgs")):
        structs, funcs = parse_c(read_c(os.path.join(ops, "csrc", src)))
        sizes[struct] = len(structs[struct])
        assert funcs, src
    assert sizes == {"StepArgs": 28, "BeamArgs": 9, "AttentionArgs": 13,
                     "StrideArgs": 42}
    res = lint_paths([ops], REPO, rule_ids=["GL020"], cache_path="")
    assert res.findings == []


# ---- the engine: baseline, suppressions, --json, --fix, --check-stale ------

SYNC_LOOP = (
    "import torch\n\n\n"
    "def fit(model, batches):\n"
    "    for x in batches:\n"
    "        seen = model(x).sum().item()\n")


WRAPPER = (
    "import torch\n\n\n"
    "def launch(x, lens, temperature: float):\n"
    "    dev = x.device\n"
    "    n = lens.to(device=dev, dtype=torch.int32)\n"
    "    scale = float(temperature)\n"
    "    return x * scale + x.sum().item() + n\n")
LOOP_CALLS_WRAPPER = (
    "import torch\n\n"
    f"from {PKG}.ops.k import launch\n\n\n"
    "def run(x, lens, steps):\n"
    "    for _ in range(steps):\n"
    "        x = launch(x, lens, 1.0)\n"
    "    return x\n")


@pytest.mark.parametrize("caller,expected", [
    # a decode loop calls the wrapper each step: its readback and its
    # copy of a parameter to the card (float() of a float is no sync)
    ("decoding/loop.py", [(6, ".to(device) of the parameter 'lens'"),
                          (8, ".item()")]),
    # a serving loop is not a per-step root
    ("serving/loop.py", []),
])
def test_per_step_code_reaches_the_ops_wrappers(tmp_path, caller, expected):
    _write(tmp_path, {f"{PKG}/ops/k.py": WRAPPER,
                      f"{PKG}/{caller}": LOOP_CALLS_WRAPPER})
    found = [f for f in _lint(tmp_path, rules=["GL001"]).findings]
    assert all(f.path == f"{PKG}/ops/k.py" for f in found)
    assert [f.line for f in found] == [line for line, _ in expected]
    for f, (_, prim) in zip(found, expected):
        assert prim in f.message and "reached from the loop in run" in \
            f.message, f.message


def test_baseline_round_trip(tmp_path):
    """Write a baseline, lint clean against it, keep reasons on rewrite,
    and report an entry whose site was fixed as stale."""
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP})
    res = _lint(tmp_path)
    assert [f.rule for f in res.gating] == ["GL001"]
    bl = Baseline.from_findings(res.findings)
    bl.entries[0]["reason"] = "the loop's one readback, on purpose"
    path = str(tmp_path / "graftlint_torch.baseline")
    bl.save(path)
    again = _lint(tmp_path, baseline=Baseline.load(path))
    assert again.gating == [] and all(f.baselined for f in again.findings)
    kept = Baseline.from_findings(again.findings, old=Baseline.load(path))
    assert kept.entries[0]["reason"] == "the loop's one readback, on purpose"
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP.replace(
        ".item()", "")})
    stale = _lint(tmp_path, baseline=Baseline.load(path)).stale_baseline
    assert [e["rule"] for e in stale] == ["GL001"]


@pytest.mark.parametrize("comment,hidden", [
    ("  # graftlint-torch: disable=GL001", True),
    ("  # graftlint-torch: disable=all", True),
    ("  # graftlint-torch: disable=GL013", False),
    # the JAX lint's tag: its ids mean other rules, so it hides nothing here
    ("  # graftlint: disable=GL001", False),
])
def test_inline_suppression(tmp_path, comment, hidden):
    src = SYNC_LOOP.replace(".item()\n", ".item()" + comment + "\n")
    _write(tmp_path, {f"{PKG}/train/loop.py": src})
    rules = [f.rule for f in _lint(tmp_path).findings]
    assert rules == ([] if hidden else ["GL001"])


def test_disable_next_line_and_unused_suppression(tmp_path):
    src = SYNC_LOOP.replace(
        "        seen =",
        "        # graftlint-torch: disable-next-line=GL001\n        seen =")
    src += "\n\nX = 1  # graftlint-torch: disable=GL009\n"
    _write(tmp_path, {f"{PKG}/train/loop.py": src})
    res = _lint(tmp_path)
    assert res.findings == []
    assert [(s["rule"], s["line"]) for s in res.unused_suppressions] == [
        ("GL009", src.count("\n"))]


def test_cli_json_schema(tmp_path, capsys):
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP})
    rc = cli_main([str(tmp_path), "--root", str(tmp_path), "--json",
                   "--no-cache"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["tool"] == "graftlint_torch" and out["version"] == 1
    assert out["counts"] == {"total": 1, "new": 1, "baselined": 0,
                             "by_rule": {"GL001": 1}}
    (f,) = out["findings"]
    assert set(f) >= {"rule", "severity", "path", "line", "col", "message",
                      "context", "baselined", "fix"}
    assert set(out["fixes"]) == {"autofixable", "by_rule",
                                 "stale_suppressions", "stale_baseline"}
    assert {"index_seconds", "rules_seconds", "files"} <= set(out["timings"])


def test_fix_then_fix_check_is_idempotent(tmp_path, capsys):
    """--fix rewrites GL011's carry init and GL005's literal, drops a stale
    suppression, re-lints to a fix-clean tree; a second --fix changes
    nothing and --fix-check passes."""
    carry = CASES["GL011"][0]
    head = {f"{PKG}/models/head.py": (
        "import torch\n\n\n"
        "def head(x, dtype):\n"
        "    return x + torch.zeros(4, dtype=torch.float32)"
        "  # graftlint-torch: disable=GL009\n")}
    _write(tmp_path, {**carry, **head})
    args = [str(tmp_path), "--root", str(tmp_path), "--no-cache"]
    assert cli_main(args + ["--fix-check"]) == 1
    assert cli_main(args + ["--fix"]) == 0
    fixed = {rel: open(tmp_path / rel).read() for rel in {**carry, **head}}
    assert "torch.zeros(4, dtype=torch.bfloat16)" in fixed[
        f"{PKG}/decoding/carry.py"]
    assert fixed[f"{PKG}/models/head.py"].endswith(
        "torch.zeros(4, dtype=dtype)\n")
    assert cli_main(args + ["--fix"]) == 0
    assert {rel: open(tmp_path / rel).read() for rel in fixed} == fixed
    assert cli_main(args + ["--fix-check", "--no-baseline"]) == 0
    capsys.readouterr()


def test_check_stale_gates_the_cli(tmp_path, capsys):
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP})
    args = [str(tmp_path), "--root", str(tmp_path), "--no-cache"]
    assert cli_main(args + ["--write-baseline"]) == 0
    assert cli_main(args + ["--check-stale"]) == 0
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP.replace(
        ".item()", "")})
    assert cli_main(args + ["--check-stale"]) == 1
    assert "stale baseline entry: GL001" in capsys.readouterr().err
    assert cli_main(args + ["--rules", "GL001", "--check-stale"]) == 2


def test_fix_dry_run_prints_the_diff_and_writes_nothing(tmp_path, capsys):
    carry = CASES["GL011"][0]
    _write(tmp_path, carry)
    args = [str(tmp_path), "--root", str(tmp_path), "--no-cache"]
    assert cli_main(args + ["--dry-run"]) == 2  # only with --fix
    capsys.readouterr()
    assert cli_main(args + ["--fix", "--dry-run"]) == 0
    out = capsys.readouterr()
    rel = f"{PKG}/decoding/carry.py"
    assert f"+++ b/{rel}" in out.out and "dtype=torch.bfloat16" in out.out
    assert "would fix" in out.err
    assert {r: open(tmp_path / r).read() for r in carry} == carry


def test_budget_and_baseline_path(tmp_path, capsys):
    """--budget fails a run that takes longer; --baseline names the
    baseline file, and --no-baseline ignores it."""
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP})
    other = str(tmp_path / "other.baseline")
    args = [str(tmp_path), "--root", str(tmp_path), "--no-cache"]
    assert cli_main(args + ["--baseline", other, "--write-baseline"]) == 0
    assert not os.path.exists(tmp_path / "graftlint_torch.baseline")
    assert cli_main(args + ["--baseline", other]) == 0
    assert cli_main(args) == 1
    assert cli_main(args + ["--baseline", other, "--no-baseline"]) == 1
    assert cli_main(args + ["--baseline", other, "--budget", "600"]) == 0
    capsys.readouterr()
    assert cli_main(args + ["--baseline", other, "--budget", "1e-9"]) == 1
    assert "over the" in capsys.readouterr().err


def _git(root, *cmd):
    subprocess.run(["git", "-C", str(root), "-c", "user.name=t",
                    "-c", "user.email=t@example.com",
                    "-c", "commit.gpgsign=false", *cmd],
                   check=True, capture_output=True, timeout=60)


def test_changed_only_lints_the_changed_files(tmp_path, capsys):
    """--changed-only runs the rules on the files git reports changed or
    untracked, refuses a root that is no checkout and the full-tree gates,
    and lints nothing on a clean tree."""
    args = ["--root", str(tmp_path), "--no-cache", "--no-baseline",
            "--changed-only", "--json"]
    assert cli_main(args) == 2  # not a git checkout
    files = {f"{PKG}/train/{n}.py": SYNC_LOOP for n in ("a", "b", "c")}
    _write(tmp_path, files)
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "init")
    capsys.readouterr()
    assert cli_main(args) == 0
    assert "nothing to lint" in capsys.readouterr().err
    _write(tmp_path, {f"{PKG}/train/b.py": SYNC_LOOP + "\n",
                      f"{PKG}/train/d.py": SYNC_LOOP})
    assert cli_main(args) == 1
    out = json.loads(capsys.readouterr().out)
    assert sorted(f["path"] for f in out["findings"]) == [
        f"{PKG}/train/b.py", f"{PKG}/train/d.py"]
    assert cli_main(args + ["--fix-check"]) == 2


def test_summary_cache_follows_the_files(tmp_path):
    """The pass-1 cache: a warm run reuses every summary, an edited file is
    summarized again and its new finding shows."""
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP.replace(
        ".item()", "")})
    cache = str(tmp_path / "cache.json")
    first = lint_paths([str(tmp_path)], str(tmp_path), cache_path=cache)
    warm = lint_paths([str(tmp_path)], str(tmp_path), cache_path=cache)
    assert first.findings == [] and warm.index_stats["cached"] == 1
    _write(tmp_path, {f"{PKG}/train/loop.py": SYNC_LOOP + "\n"})
    edited = lint_paths([str(tmp_path)], str(tmp_path), cache_path=cache)
    assert edited.index_stats["summarized"] == 1
    assert [f.rule for f in edited.findings] == ["GL001"]


# ---- the rules whose meaning did not change: the JAX lint agrees -----------

SAME = {
    "GL009": (
        "def load(path):\n"
        "    try:\n"
        "        return open(path).read()\n"
        "    except Exception:\n"
        "        pass\n"
        "    try:\n"
        "        return 1\n"
        "    except (ValueError, BaseException):\n"
        "        'documented'\n"
        "    try:\n"
        "        return 2\n"
        "    except ValueError:\n"
        "        pass\n"),
    "GL010": (
        "import time\n\n\n"
        "def step():\n"
        "    t0 = time.perf_counter()\n"
        "    t = time.time()\n"
        "    print(t - t0)\n"),
    "GL018": (
        "MP_PARAM_PARTITION_RULES = (\n"
        "    ('head', r'params/cell/out_proj/.*', ()),\n"
        "    ('head_kernel', r'params/cell/out_proj/kernel', ()),\n"
        "    ('embed', r'params/cell/word_embed/.*', ()),\n"
        ")\n"),
}


@pytest.mark.parametrize("rule", sorted(SAME))
def test_unchanged_rule_agrees_with_the_jax_lint(tmp_path, rule):
    """The same source under each package's prefix: the same ids at the
    same lines from both linters."""
    contract = json.dumps(CONTRACT)
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    _write(jroot, {"cst_captioning_tpu/train/mod.py": SAME[rule],
                   "scripts/shardings_contract.json": contract})
    _write(troot, {f"{PKG}/train/mod.py": SAME[rule],
                   CONTRACT_RELPATH: contract})
    jax = jax_lint_paths([str(jroot / "cst_captioning_tpu")], str(jroot),
                         rule_ids=[rule], cache_path="").findings
    port = lint_paths([str(troot / PKG)], str(troot), rule_ids=[rule],
                      cache_path="").findings
    assert jax, rule
    assert [(f.rule, f.line, f.col) for f in port] == [
        (f.rule, f.line, f.col) for f in jax]


# ---- hazards planted in copies of real port files ---------------------------

PLANTS = {
    "scst_update_item": (
        "rl/scst.py", "    for c in range(chunks):\n",
        "    for c in range(chunks):\n"
        "        probe = params[0].sum().item()\n", "GL001"),
    "step_args_swapped": (
        "ops/decode_step.py", '"mem", "proj", "mask",',
        '"proj", "mem", "mask",', "GL020"),
    "seq_all_reduce_no_group": (
        "parallel/seq_parallel.py",
        "dist.all_reduce(y, op=op, group=group)",
        "dist.all_reduce(y, op=op)", "GL016"),
    "stride_wrapper_readback": (
        "ops/decode_stride.py", "    lib = _lib()\n",
        "    lib = _lib()\n    probe = tokens.sum().item()\n", "GL001"),
    "decoder_imports_jax": (
        "models/decoder.py", "import math\n", "import math\n\nimport jax\n",
        "GL006"),
}


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """A copy of the port's package and its clean findings (the cache warm
    for the planted runs)."""
    root = tmp_path_factory.mktemp("port_copy")
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    cache = str(root / "cache.json")
    clean = lint_paths([str(root / PKG)], str(root), cache_path=cache)
    return root, cache, {(f.rule, f.path, f.context) for f in clean.findings}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_planted_hazard_gives_exactly_its_finding(port_copy, name):
    root, cache, clean = port_copy
    rel, old, new, rule = PLANTS[name]
    path = root / PKG / rel
    source = path.read_text()
    assert source.count(old) == 1, (name, old)
    path.write_text(source.replace(old, new))
    try:
        res = lint_paths([str(root / PKG)], str(root), cache_path=cache,
                         only_files=[str(path)])
    finally:
        path.write_text(source)
    fresh = [f for f in res.findings
             if (f.rule, f.path, f.context) not in clean]
    assert [(f.rule, f.path) for f in fresh] == [(rule, f"{PKG}/{rel}")], [
        (f.rule, f.line, f.message) for f in fresh]


# ---- the gate, the contract, and the import probe ---------------------------

def test_port_is_graftlint_clean(capsys):
    """The acceptance gate over the default paths (the port, its tests,
    chip_smoke.py): no new finding, no stale baseline entry or suppression,
    no unapplied autofix."""
    rc = cli_main(["--root", REPO, "--check-stale", "--fix-check",
                   "--no-cache"])
    out = capsys.readouterr()
    assert rc == 0, f"{out.out}\n{out.err}"
    entries = json.load(open(os.path.join(REPO, "graftlint_torch.baseline"),
                             encoding="utf-8"))["entries"]
    for e in entries:
        assert len(e["reason"]) > 40 and not e["reason"].startswith(
            "TODO"), e


def test_contract_matches_the_presets_models():
    """The contract beside the lint equals the names train.mesh gives the
    presets' models (``contract --write`` regenerates it)."""
    with open(contract_mod.CONTRACT, encoding="utf-8") as f:
        recorded = json.load(f)["params"]
    assert recorded == contract_mod.contract_param_names()
    assert contract_mod.main([]) == 0


def test_lint_imports_no_torch_numpy_or_jax():
    """A fresh interpreter imports and runs the lint over the port with
    none of torch, numpy, jax or the JAX package in sys.modules."""
    code = (
        "import sys\n"
        "from cst_captioning_tpu_torch.tools.graftlint.cli import main\n"
        "import cst_captioning_tpu_torch.tools.graftlint.__main__\n"
        f"rc = main(['--root', {REPO!r}, '--no-cache'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'jaxlib', 'cst_captioning_tpu'))\n"
        "print(rc, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-S", "-c", code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "0 []", proc.stdout
