"""graftlint for the port: findings, rule registry, suppressions, baseline.

A stdlib-``ast`` static-analysis pass specialised for the torch/CUDA hazards
of ``cst_captioning_tpu_torch`` (host syncs in per-step loops, unseeded
sampling, implicit ``__bool__`` syncs, dtype drift, JAX imports and CUDA
initialised at import, partition-rule coverage, collectives without a
group, the kernels' C interface). It is the JAX package's graftlint with
its rules retargeted; rule ids are the same, so a reader finds the JAX
rule, its fixtures and its README line by id. No third-party dependencies
(not even torch or numpy): the lint runs wherever the tests run.

Layers:

- :class:`Finding`        — one diagnostic, with a line-content fingerprint
  that survives unrelated line-number drift; may carry a :class:`Fix`.
- :class:`Fix`            — span-precise source edits repairing a finding
  mechanically (applied by :mod:`fixes` under ``--fix``).
- :class:`Rule`           — registry-registered check over a
  :class:`FileContext`; per-rule id / severity / docs.
- suppressions            — ``# graftlint-torch: disable=GL001[,GL002|all]``
  on the offending line, or ``# graftlint-torch: disable-next-line=...`` on
  the line above.
- baseline                — a repo-root ``graftlint_torch.baseline`` JSON of
  grandfathered fingerprints (with a human ``reason`` each); matched findings
  are reported but do not fail the run.

The suppression tag is this lint's own: the JAX package's lint, which also
reads ``tests/test_torch_*.py``, gives the same rule ids other meanings and
keeps ``# graftlint:``. Each lint hides and reports as stale only its own
comments.

The CLI lives in :mod:`cst_captioning_tpu_torch.tools.graftlint.cli`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import time
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Iterable, Iterator

SEVERITIES = ("error", "warning", "info")

# rule id the framework itself emits for unparseable files
PARSE_ERROR_RULE = "GL000"

BASELINE_NAME = "graftlint_torch.baseline"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint-torch:\s*(disable(?:-next-line)?)\s*=\s*"
    r"([A-Za-z0-9_,\s]+)"
)

# directory names never descended into. "fixtures" keeps the deliberately
# lint-dirty fixtures under tests/fixtures/ out of the repo gate — tests
# lint them by passing the fixture directory explicitly (os.walk only
# filters SUBdirectories of the given path); "_build" holds what the
# kernels and the reward library build at first use.
_SKIP_DIRS = {
    ".git", "__pycache__", ".pytest_cache", "node_modules", ".claude",
    "fixtures", "_build",
}


@dataclass(frozen=True)
class Edit:
    """One span-precise replacement: ``[start, end)`` in (1-based line,
    0-based col) coordinates, the same frame ``ast`` nodes report."""

    line: int
    col: int
    end_line: int
    end_col: int
    replacement: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_node(cls, node: ast.AST, replacement: str) -> "Edit":
        return cls(
            line=node.lineno, col=node.col_offset,
            end_line=int(node.end_lineno or node.lineno),
            end_col=int(node.end_col_offset or node.col_offset),
            replacement=replacement,
        )


@dataclass
class Fix:
    """A mechanical repair for one finding: non-overlapping edits plus a
    one-line human description (printed by ``--fix`` / the JSON report).
    Rules only emit a Fix when the rewrite is provably behavior-identical
    (or restores the invariant the finding names) — never a guess."""

    edits: tuple[Edit, ...]
    description: str

    def to_dict(self) -> dict:
        return {
            "description": self.description,
            "edits": [e.to_dict() for e in self.edits],
        }


@dataclass
class Finding:
    """One diagnostic. ``context`` (the stripped source line) + rule + path
    form the baseline fingerprint, so renumbering lines doesn't unbaseline."""

    rule: str
    severity: str
    path: str            # repo-root-relative, posix separators
    line: int
    col: int
    message: str
    context: str
    baselined: bool = False
    fix: Fix | None = None

    def fingerprint(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fix"] = self.fix.to_dict() if self.fix is not None else None
        return d

    def render(self) -> str:
        tag = " (baselined)" if self.baselined else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.severity}: {self.message}{tag}"
        )


@dataclass
class FileContext:
    """Parsed view of one file, shared by every rule."""

    path: str            # absolute
    relpath: str         # repo-root-relative, posix
    root: str            # repo root (absolute)
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    # line -> set of rule ids (or "all") suppressed on that line
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    # populated lazily by rules that need it (see rules._traced_functions)
    _cache: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, root: str,
              source: str | None = None,
              tree: ast.Module | None = None) -> "FileContext":
        """Parse ``path`` — or adopt an already-parsed (source, tree) pair
        (pass 1 of the two-pass driver parses every file anyway; re-parsing
        in pass 2 would double the lint's dominant cost)."""
        if source is None:
            with open(path, encoding="utf-8", errors="replace") as f:
                source = f.read()
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        if tree is None:
            tree = ast.parse(source, filename=relpath)  # may raise SyntaxError
        ctx = cls(path=path, relpath=relpath, root=root, source=source,
                  tree=tree, lines=source.splitlines())
        ctx.suppressions = _collect_suppressions(source)
        return ctx

    def walk_nodes(self) -> list:
        """Flat list of every AST node, cached: rules iterate the whole
        tree a dozen times per file — one traversal, not fifteen."""
        cached = self._cache.get("all_nodes")
        if cached is None:
            cached = list(ast.walk(self.tree))
            self._cache["all_nodes"] = cached
        return cached

    def nodes_of(self, *types: type) -> list:
        """All nodes of the given AST types, from a one-time type-bucketed
        index over :meth:`walk_nodes` — most rules only look at ``Call``
        or def nodes, and fifteen full-tree isinstance scans per file were
        the dominant pass-2 cost. Within one type, walk order is kept;
        multiple types concatenate (callers that need interleaved source
        order still use :meth:`walk_nodes`)."""
        by_type = self._cache.get("nodes_by_type")
        if by_type is None:
            by_type = {}
            for node in self.walk_nodes():
                by_type.setdefault(type(node), []).append(node)
            self._cache["nodes_by_type"] = by_type
        if len(types) == 1:
            return by_type.get(types[0], [])
        out: list = []
        for t in types:
            out.extend(by_type.get(t, ()))
        return out

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: "Rule", node: ast.AST, message: str,
                severity: str | None = None,
                fix: Fix | None = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule.id,
            severity=severity or rule.severity,
            path=self.relpath,
            line=line,
            col=col,
            message=message,
            context=self.line_text(line),
            fix=fix,
        )

    def suppressed(self, f: Finding) -> bool:
        ids = self.suppressions.get(f.line, set())
        return "all" in ids or f.rule in ids


def _collect_suppressions(source: str) -> dict[int, set[str]]:
    """Map line -> suppressed rule ids from ``# graftlint-torch:``
    comments."""
    out: dict[int, set[str]] = {}
    if "graftlint-torch:" not in source:
        return out  # skip the tokenizer: most files carry no suppressions
    try:
        tokens = tokenize.generate_tokens(StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            kind, ids = m.group(1), {
                s.strip() for s in m.group(2).split(",") if s.strip()
            }
            line = tok.start[0] + (1 if kind.endswith("next-line") else 0)
            out.setdefault(line, set()).update(ids)
    except tokenize.TokenError:
        pass
    return out


# ---- rule registry ----------------------------------------------------------

class Rule:
    """Base rule. Subclasses set ``id``/``name``/``severity``/``rationale``
    and implement :meth:`check`; registration is via :func:`register`."""

    id: str = ""
    name: str = ""
    severity: str = "warning"
    rationale: str = ""

    def applies(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


class ProjectRule(Rule):
    """A rule that sees past the file: :meth:`check_project` receives the
    pass-1 :class:`~.project.ProjectIndex` alongside the per-file context.
    Findings still anchor to lines of ``ctx`` (and per-line suppressions /
    the baseline apply unchanged) — the index only widens what the rule can
    *know*, not where it reports."""

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError("ProjectRule runs via check_project")

    def check_project(self, ctx: FileContext,
                      index) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    rule = cls()
    if not rule.id or rule.severity not in SEVERITIES:
        raise ValueError(f"bad rule registration: {cls.__name__}")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> dict[str, Rule]:
    # import the rule module on first use so registration is one-time
    from cst_captioning_tpu_torch.tools.graftlint import rules  # noqa: F401

    return dict(_REGISTRY)


# ---- baseline ---------------------------------------------------------------

@dataclass
class Baseline:
    """Grandfathered findings: fingerprint -> allowed count (+ a reason)."""

    entries: list[dict] = field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict) or "entries" not in data:
            raise ValueError(f"{path}: not a graftlint baseline file")
        return cls(entries=list(data["entries"]), path=path)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        data = {
            "version": 1,
            "comment": (
                "Grandfathered findings of the port's graftlint. Each "
                "entry carries a `reason` saying why the finding is "
                "intentional; remove the entry when the code site is "
                "fixed. Regenerate with `python -m "
                "cst_captioning_tpu_torch.tools.graftlint "
                "--write-baseline` (which preserves reasons by fingerprint)."
            ),
            "entries": sorted(
                self.entries,
                key=lambda e: (e["path"], e["rule"], e["context"]),
            ),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2)
            f.write("\n")

    def _counts(self) -> dict[tuple[str, str, str], int]:
        out: dict[tuple[str, str, str], int] = {}
        for e in self.entries:
            key = (e["rule"], e["path"], e["context"])
            out[key] = out.get(key, 0) + int(e.get("count", 1))
        return out

    def apply(self, findings: list[Finding]) -> None:
        """Mark findings covered by the baseline, first-come first-served
        per fingerprint (extra occurrences stay new)."""
        budget = self._counts()
        for f in findings:
            key = f.fingerprint()
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                f.baselined = True

    def stale_entries(self, findings: list[Finding]) -> list[dict]:
        """Entries whose fingerprint no longer fires (or fires fewer times
        than its grandfathered count): the code site was fixed, so the
        grandfather must go too — a stale entry silently re-opens the door
        for the finding to come back."""
        budget = self._counts()
        for f in findings:
            key = f.fingerprint()
            if budget.get(key, 0) > 0:
                budget[key] -= 1
        stale, seen = [], set()
        for e in self.entries:
            key = (e["rule"], e["path"], e["context"])
            if budget.get(key, 0) > 0 and key not in seen:
                seen.add(key)
                stale.append(dict(e, unfired=budget[key]))
        return stale

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      old: "Baseline | None" = None) -> "Baseline":
        """Baseline every (non-suppressed) finding; reasons carried over from
        ``old`` by fingerprint, placeholder otherwise."""
        reasons: dict[tuple[str, str, str], str] = {}
        if old is not None:
            for e in old.entries:
                reasons[(e["rule"], e["path"], e["context"])] = e.get(
                    "reason", ""
                )
        grouped: dict[tuple[str, str, str], dict] = {}
        for f in findings:
            key = f.fingerprint()
            if key in grouped:
                grouped[key]["count"] += 1
            else:
                grouped[key] = {
                    "rule": f.rule,
                    "path": f.path,
                    "context": f.context,
                    "count": 1,
                    "reason": reasons.get(
                        key, "TODO: justify or fix this finding"
                    ),
                }
        return cls(entries=list(grouped.values()),
                   path=old.path if old is not None else "")


# ---- driver -----------------------------------------------------------------

def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into a sorted, deduped .py file list."""
    seen: set[str] = set()
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py") and p not in seen:
                seen.add(p)
                yield p
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs if d not in _SKIP_DIRS and not d.startswith(".")
            )
            for n in sorted(names):
                if n.endswith(".py"):
                    fp = os.path.join(root, n)
                    if fp not in seen:
                        seen.add(fp)
                        yield fp


@dataclass
class LintResult:
    findings: list[Finding]
    files_checked: int
    # --check-stale surfaces: baseline entries that no longer fire, and
    # inline `# graftlint-torch: disable=` ids that suppressed nothing
    stale_baseline: list[dict] = field(default_factory=list)
    unused_suppressions: list[dict] = field(default_factory=list)
    # per-pass wall-clock (index build vs rule run) for the lint.sh budget
    index_seconds: float = 0.0
    rules_seconds: float = 0.0
    index_stats: dict = field(default_factory=dict)

    @property
    def new(self) -> list[Finding]:
        return [f for f in self.findings if not f.baselined]

    @property
    def gating(self) -> list[Finding]:
        """New findings that fail the run (info never gates)."""
        return [f for f in self.new if f.severity in ("error", "warning")]

    @property
    def fixable(self) -> list[Finding]:
        """NEW findings carrying a mechanical fix (``--fix`` applies them;
        ``--fix-check`` fails while any exist). Baselined findings are
        intentional — their fixes are never applied."""
        return [f for f in self.new if f.fix is not None]

    def to_json(self) -> dict:
        counts = {"total": len(self.findings),
                  "new": len(self.new),
                  "baselined": len(self.findings) - len(self.new),
                  "by_rule": {}}
        for f in self.findings:
            counts["by_rule"][f.rule] = counts["by_rule"].get(f.rule, 0) + 1
        fixes = {"autofixable": len(self.fixable), "by_rule": {}}
        for f in self.fixable:
            fixes["by_rule"][f.rule] = fixes["by_rule"].get(f.rule, 0) + 1
        # stale suppressions/baseline entries are repaired by --fix too
        fixes["stale_suppressions"] = len(self.unused_suppressions)
        fixes["stale_baseline"] = len(self.stale_baseline)
        return {
            "version": 1,
            "tool": "graftlint_torch",
            "files_checked": self.files_checked,
            "counts": counts,
            "findings": [f.to_dict() for f in self.findings],
            "fixes": fixes,
            "stale_baseline": self.stale_baseline,
            "unused_suppressions": self.unused_suppressions,
            "timings": {
                "index_seconds": round(self.index_seconds, 4),
                "rules_seconds": round(self.rules_seconds, 4),
                **self.index_stats,
            },
        }


def find_repo_root(start: str) -> str:
    """Nearest ancestor containing a baseline file, .git, or the package."""
    d = os.path.abspath(start)
    while True:
        if (
            os.path.exists(os.path.join(d, BASELINE_NAME))
            or os.path.isdir(os.path.join(d, ".git"))
            or os.path.isdir(os.path.join(d, "cst_captioning_tpu_torch"))
        ):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def lint_paths(
    paths: Iterable[str],
    root: str,
    baseline: Baseline | None = None,
    rule_ids: Iterable[str] | None = None,
    cache_path: str | None = None,
    only_files: Iterable[str] | None = None,
) -> LintResult:
    """Two-pass driver. Pass 1 builds the whole-program
    :class:`~.project.ProjectIndex` over every file (reusing the mtime-keyed
    on-disk summary cache — ``cache_path=''`` disables it); pass 2 runs the
    per-file rules unchanged plus the :class:`ProjectRule`s against the
    index. Suppression usage and baseline hit-counts are tracked so
    ``--check-stale`` can report dead grandfathers and dead disables.

    ``only_files`` (absolute paths) limits PASS 2 to a subset of the
    files — the index still covers everything, so cross-module rules keep
    their whole-program knowledge. This is ``--changed-only``'s fast
    path: warm index + a handful of changed files."""
    from cst_captioning_tpu_torch.tools.graftlint.project import ProjectIndex

    rules = all_rules()
    if rule_ids is not None:
        unknown = set(rule_ids) - set(rules)
        if unknown:
            raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
        rules = {k: v for k, v in rules.items() if k in set(rule_ids)}

    files = list(iter_py_files(paths))
    t0 = time.perf_counter()
    index = ProjectIndex.build(files, root, cache_path=cache_path)
    index_seconds = time.perf_counter() - t0

    pass2_files = files
    if only_files is not None:
        wanted = {os.path.abspath(p) for p in only_files}
        pass2_files = [p for p in files if os.path.abspath(p) in wanted]

    findings: list[Finding] = []
    # (relpath, line) -> rule ids whose suppression actually fired there
    used_supp: dict[tuple[str, int], set[str]] = {}
    all_supp: list[tuple[str, int, set[str]]] = []
    t0 = time.perf_counter()
    for path in pass2_files:
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        pre = index.parsed.get(relpath)
        try:
            ctx = FileContext.parse(
                path, root,
                source=pre[0] if pre else None,
                tree=pre[1] if pre else None,
            )
        except SyntaxError as e:
            findings.append(Finding(
                rule=PARSE_ERROR_RULE,
                severity="error",
                path=os.path.relpath(path, root).replace(os.sep, "/"),
                line=int(e.lineno or 1),
                col=int(e.offset or 0),
                message=f"syntax error: {e.msg}",
                context="",
            ))
            continue
        for line, ids in ctx.suppressions.items():
            all_supp.append((ctx.relpath, line, ids))
        for rule in rules.values():
            if not rule.applies(ctx):
                continue
            if isinstance(rule, ProjectRule):
                checked = rule.check_project(ctx, index)
            else:
                checked = rule.check(ctx)
            for f in checked:
                if ctx.suppressed(f):
                    used_supp.setdefault(
                        (ctx.relpath, f.line), set()
                    ).add(f.rule)
                else:
                    findings.append(f)
    rules_seconds = time.perf_counter() - t0

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    result = LintResult(
        findings=findings,
        files_checked=len(pass2_files),
        index_seconds=index_seconds,
        rules_seconds=rules_seconds,
        index_stats=dataclasses.asdict(index.stats),
    )
    if baseline is not None:
        baseline.apply(findings)
        result.stale_baseline = baseline.stale_entries(findings)
    # an "unused" suppression id is only meaningful when its rule ran
    ran = set(rules)
    for relpath, line, ids in sorted(all_supp):
        hit = used_supp.get((relpath, line), set())
        for rid in sorted(ids):
            if rid == "all":
                if not hit:
                    result.unused_suppressions.append(
                        {"path": relpath, "line": line, "rule": "all"}
                    )
            elif rid in ran:
                if rid not in hit:
                    result.unused_suppressions.append(
                        {"path": relpath, "line": line, "rule": rid}
                    )
            elif rule_ids is None:
                # not a registered rule id at all: a typo'd disable that
                # can never suppress anything
                result.unused_suppressions.append(
                    {"path": relpath, "line": line, "rule": rid}
                )
    return result
