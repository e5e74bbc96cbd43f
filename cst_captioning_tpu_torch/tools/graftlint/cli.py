"""The port's graftlint CLI.

    python -m cst_captioning_tpu_torch.tools.graftlint [paths...] [--json]
        [--baseline PATH | --no-baseline] [--write-baseline]
        [--rules GL001,GL002] [--root DIR] [--list-rules]
        [--check-stale] [--timings] [--budget SECONDS] [--no-cache]
        [--fix [--dry-run]] [--fix-check] [--changed-only]

Exit codes: 0 = no new error/warning findings (info and baselined findings
never gate), 1 = new findings / stale baseline or suppressions with
--check-stale / budget exceeded with --budget / unfixed autofixable
findings with --fix-check / fixes skipped or surviving with --fix,
2 = usage error.

``--check-stale`` additionally fails the run when a
``graftlint_torch.baseline`` entry no longer fires or an inline
``# graftlint-torch: disable=GLxxx`` suppresses nothing — dead
grandfathers silently re-open the door for a finding to come back.

``--fix`` applies the mechanical repairs rules attach to findings (see
:mod:`fixes`) plus stale-suppression/baseline removal, re-parses every
rewritten file, then RE-LINTS and fails unless the tree is fix-clean —
so applying ``--fix`` twice is always a no-op. ``--fix --dry-run`` prints
the unified diff without writing. ``--fix-check`` is the CI spelling: it
fails while any autofixable finding is unfixed, touching nothing.

``--changed-only`` is the pre-commit fast path: pass 1 still indexes the
whole tree (so cross-module rules keep their whole-program knowledge and
the warm cache makes it cheap), but pass 2 runs only on files git reports
as changed vs HEAD (plus untracked). It is exclusive with the
authoritative gates (``--fix``/``--fix-check``/``--write-baseline``/
``--check-stale``), which need full-tree findings.

The runtime counterpart of the static GL001/GL003/GL013 sync claims is
``python3 chip_smoke.py --phases syncs`` on a GPU: a serve burst, an XE
step and an SCST step under ``torch.cuda.set_sync_debug_mode("warn")``,
every synchronising call recorded by file and line and held against this
lint's findings and baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from cst_captioning_tpu_torch.tools.graftlint.core import (
    BASELINE_NAME,
    Baseline,
    all_rules,
    find_repo_root,
    lint_paths,
)

# the port, its tests and the chip smoke script; the tests are the
# ``tests/test_torch_*.py`` files (the rest of tests/ is the JAX lint's)
_DEFAULT_PATHS = ("cst_captioning_tpu_torch", "chip_smoke.py")


def default_paths(root: str) -> list[str]:
    """The default lint paths under ``root``, those that exist."""
    paths = [os.path.join(root, p) for p in _DEFAULT_PATHS
             if os.path.exists(os.path.join(root, p))]
    tdir = os.path.join(root, "tests")
    if os.path.isdir(tdir):
        paths += [os.path.join(tdir, n) for n in sorted(os.listdir(tdir))
                  if n.startswith("test_torch_") and n.endswith(".py")]
    return paths


def _git_changed_files(root: str) -> list[str] | None:
    """Absolute paths of .py files changed vs HEAD (tracked diffs plus
    untracked files, .gitignore respected). ``None`` when ``root`` is not
    a git checkout — the caller turns that into a usage error rather than
    silently linting nothing."""
    rels: list[str] = []
    for cmd in (
        ["git", "-C", root, "diff", "--name-only", "HEAD", "--"],
        ["git", "-C", root, "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            out = subprocess.run(
                cmd, capture_output=True, text=True, timeout=10,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if out.returncode != 0:
            return None
        rels += out.stdout.splitlines()
    seen: set[str] = set()
    files: list[str] = []
    for rel in rels:
        rel = rel.strip()
        if not rel.endswith(".py") or rel in seen:
            continue
        seen.add(rel)
        path = os.path.join(root, rel)
        if os.path.isfile(path):  # deletions show in the diff too
            files.append(path)
    return files


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: "
                         f"{' '.join(_DEFAULT_PATHS)} and "
                         "tests/test_torch_*.py under --root)")
    ap.add_argument("--root", default="",
                    help="repo root (default: auto-detected from cwd)")
    ap.add_argument("--baseline", default="",
                    help=f"baseline file (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding as new")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into the "
                         "baseline file (reasons preserved by fingerprint) "
                         "and exit 0")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--check-stale", action="store_true",
                    help="also fail on baseline entries that no longer fire "
                         "and on unused inline disable= suppressions "
                         "(requires the full rule set and a baseline)")
    ap.add_argument("--timings", action="store_true",
                    help="print the per-pass timing line (index build vs "
                         "rule run) on stderr")
    ap.add_argument("--budget", type=float, default=0.0, metavar="SECONDS",
                    help="fail (exit 1) when index build + rule run exceed "
                         "this wall-clock budget")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the on-disk project-summary cache "
                         "(<root>/.graftlint_torch_cache.json)")
    ap.add_argument("--fix", action="store_true",
                    help="apply the mechanical fixes rules attach to NEW "
                         "findings (plus stale suppression/baseline "
                         "removal), re-parse, re-lint, and fail unless "
                         "the tree ends fix-clean")
    ap.add_argument("--dry-run", action="store_true",
                    help="with --fix: print the unified diff instead of "
                         "writing files")
    ap.add_argument("--fix-check", action="store_true",
                    help="CI mode: fail (exit 1) while any autofixable "
                         "finding is unfixed; never writes")
    ap.add_argument("--changed-only", action="store_true",
                    help="fast pre-commit path: build the full whole-program "
                         "index as usual, but run pass 2 only on files git "
                         "reports as changed (diff vs HEAD + untracked); "
                         "exclusive with --fix/--fix-check/--write-baseline/"
                         "--check-stale, which need full-tree findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{rule.id} {rule.name} [{rule.severity}]")
            print(f"    {rule.rationale}")
        return 0

    root = os.path.abspath(args.root) if args.root else find_repo_root(
        os.getcwd()
    )
    paths = list(args.paths)
    if not paths:
        paths = default_paths(root)
    if not paths:
        print("graftlint_torch: nothing to lint", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    baseline = None if args.no_baseline else Baseline.load(baseline_path)

    rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()] or None
    if args.check_stale and (rule_ids is not None or baseline is None):
        print("graftlint_torch: --check-stale needs the full rule set and a "
              "baseline (drop --rules / --no-baseline)", file=sys.stderr)
        return 2
    if args.fix and args.fix_check:
        print("graftlint_torch: --fix and --fix-check are exclusive (apply or "
              "gate, not both)", file=sys.stderr)
        return 2
    if args.dry_run and not args.fix:
        print("graftlint_torch: --dry-run only means something with --fix",
              file=sys.stderr)
        return 2
    only_files = None
    if args.changed_only:
        for flag, on in (("--fix", args.fix), ("--fix-check", args.fix_check),
                         ("--write-baseline", args.write_baseline),
                         ("--check-stale", args.check_stale)):
            if on:
                print(f"graftlint_torch: --changed-only and {flag} are "
                      "exclusive "
                      "— the authoritative gates need full-tree findings",
                      file=sys.stderr)
                return 2
        only_files = _git_changed_files(root)
        if only_files is None:
            print("graftlint_torch: --changed-only needs a git checkout at "
                  f"{root}", file=sys.stderr)
            return 2
        if not only_files:
            print("graftlint_torch: --changed-only: no changed .py files, "
                  "nothing to lint", file=sys.stderr)
            return 0
    try:
        result = lint_paths(
            paths, root, baseline=baseline, rule_ids=rule_ids,
            cache_path="" if args.no_cache else None,
            only_files=only_files,
        )
    except ValueError as e:
        print(f"graftlint_torch: {e}", file=sys.stderr)
        return 2

    fix_failed = False
    if args.fix:
        result, rc = _run_fix(
            args, paths, root, rule_ids, baseline_path, result
        )
        if args.dry_run:
            return rc
        fix_failed = rc != 0

    total_seconds = result.index_seconds + result.rules_seconds
    if args.timings:
        stats = result.index_stats
        print(
            f"graftlint_torch: index {result.index_seconds:.3f}s "
            f"({stats.get('files', 0)} files, "
            f"{stats.get('summarized', 0)} summarized, "
            f"{stats.get('cached', 0)} cached) + rules "
            f"{result.rules_seconds:.3f}s = {total_seconds:.3f}s",
            file=sys.stderr,
        )

    if args.write_baseline:
        old = Baseline.load(baseline_path)
        new = Baseline.from_findings(result.findings, old=old)
        new.save(baseline_path)
        print(
            f"graftlint_torch: baselined {len(result.findings)} "
            "finding(s) into "
            f"{os.path.relpath(baseline_path, root)} — fill in each "
            "`reason` before committing",
            file=sys.stderr,
        )
        return 0

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        n_new, n_base = len(result.new), len(result.findings) - len(result.new)
        print(
            f"graftlint_torch: {result.files_checked} file(s), "
            f"{len(result.findings)} finding(s) "
            f"({n_new} new, {n_base} baselined)",
            file=sys.stderr,
        )

    failed = bool(result.gating) or fix_failed
    if args.fix_check:
        for f in result.fixable:
            print(
                f"graftlint_torch: autofixable: {f.path}:{f.line} "
                f"{f.rule} — "
                f"{f.fix.description}; run `--fix` to apply",
                file=sys.stderr,
            )
            failed = True
    if args.check_stale:
        for e in result.stale_baseline:
            print(
                f"graftlint_torch: stale baseline entry: {e['rule']} at "
                f"{e['path']} ({e['context']!r}) no longer fires "
                f"({e['unfired']} unfired) — remove it from "
                f"{BASELINE_NAME}",
                file=sys.stderr,
            )
            failed = True
        for s in result.unused_suppressions:
            print(
                "graftlint_torch: unused suppression: "
                f"{s['path']}:{s['line']} "
                f"disables {s['rule']} but nothing fires there — remove "
                "the comment",
                file=sys.stderr,
            )
            failed = True
    if args.budget and total_seconds > args.budget:
        print(
            f"graftlint_torch: pass took {total_seconds:.3f}s, over the "
            f"{args.budget:.1f}s budget — the index cache or a rule "
            "regressed",
            file=sys.stderr,
        )
        failed = True
    return 1 if failed else 0


_FIX_MAX_ROUNDS = 5


def _run_fix(args, paths, root, rule_ids, baseline_path, result):
    """Apply fixes until the tree is fix-clean (or no progress), re-linting
    after every write — the idempotence proof. Returns the post-fix lint
    result and an exit code (0 = converged clean)."""
    from cst_captioning_tpu_torch.tools.graftlint.fixes import (
        plan_fixes,
        write_plan,
    )

    baseline = None if args.no_baseline else Baseline.load(baseline_path)
    if args.dry_run:
        plan = plan_fixes(result, root, baseline=baseline)
        for file_fix in plan.files:
            print(file_fix.diff(), end="")
        _print_fix_summary(plan, dry=True)
        return result, 0

    rounds = 0
    while result.fixable or result.unused_suppressions or \
            result.stale_baseline:
        if rounds >= _FIX_MAX_ROUNDS:
            print(
                "graftlint_torch: --fix did not converge after "
                f"{_FIX_MAX_ROUNDS} rounds — a fixer is not idempotent",
                file=sys.stderr,
            )
            return result, 1
        plan = plan_fixes(result, root, baseline=baseline)
        if plan.applied_count == 0 and plan.stale_baseline_removed == 0:
            unfixed = len(result.fixable)
            if unfixed:
                print(
                    f"graftlint_torch: {unfixed} autofixable finding(s) could "
                    "not be applied (see skips above)",
                    file=sys.stderr,
                )
                _print_fix_summary(plan, dry=False)
                return result, 1
            break  # only unused suppressions with no comment found: done
        write_plan(plan)
        _print_fix_summary(plan, dry=False)
        rounds += 1
        # the idempotence proof: re-lint the same paths from disk
        baseline = None if args.no_baseline else Baseline.load(
            baseline_path
        )
        result = lint_paths(
            paths, root, baseline=baseline, rule_ids=rule_ids,
            cache_path="" if args.no_cache else None,
        )
    rc = 0
    if result.fixable:
        print(
            f"graftlint_torch: {len(result.fixable)} autofixable finding(s) "
            "survived --fix — a fixer regressed",
            file=sys.stderr,
        )
        rc = 1
    return result, rc


def _print_fix_summary(plan, dry: bool) -> None:
    verb = "would fix" if dry else "fixed"
    for file_fix in plan.files:
        for line in file_fix.applied:
            print(f"graftlint_torch: {verb}: {line}", file=sys.stderr)
    for _, reason in plan.skipped:
        if reason:
            print(f"graftlint_torch: skipped: {reason}", file=sys.stderr)
    if plan.stale_baseline_removed:
        print(
            f"graftlint_torch: {verb}: removed {plan.stale_baseline_removed} "
            "stale baseline entr(y/ies)",
            file=sys.stderr,
        )


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
