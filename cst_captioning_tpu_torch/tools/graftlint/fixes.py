"""The port's graftlint autofix engine: apply the mechanical repairs rules
emit.

Rules attach a :class:`~.core.Fix` (span-precise :class:`~.core.Edit`\\ s +
a one-line description) to findings whose repair is provably mechanical —
GL011's loop-carry init dtype literal, GL005's ``torch.float32`` literal
when a ``dtype`` parameter is in scope, GL018's fully shadowed rule row.
This module turns those into file rewrites, plus the two repair classes no
rule owns: stale inline ``# graftlint-torch: disable=`` suppressions and
stale ``graftlint_torch.baseline`` entries (``--check-stale`` reports them;
``--fix`` removes them).

Safety ladder, in order:

1. **Plan, don't stream** — all edits for a file are collected first;
   overlapping fixes are REFUSED (first-come by source position wins, the
   rest are reported as skipped), never merged or guessed about.
2. **Re-parse** — the rewritten source must still parse; a syntax error
   reverts the whole file and reports every one of its fixes as skipped.
3. **Re-lint** — the CLI re-runs the lint after writing and fails if any
   autofixable finding survives: applying ``--fix`` twice is a no-op, and
   that idempotence is part of the contract (pinned in
   tests/test_torch_graftlint.py).

``--fix --dry-run`` prints the unified diff instead of writing;
``--fix-check`` is the CI mode — it fails while any autofixable finding
is unfixed, without touching the tree.
"""

from __future__ import annotations

import ast
import difflib
import os
import tokenize
from dataclasses import dataclass, field
from io import StringIO

from cst_captioning_tpu_torch.tools.graftlint.core import (
    _SUPPRESS_RE,
    Baseline,
    Edit,
    Finding,
    LintResult,
)


class OverlappingEditsError(ValueError):
    """Two edits claim overlapping spans — the engine refuses to guess
    which rewrite wins (the caller skips the later fix instead)."""


# ---- span-precise edit application ------------------------------------------

def _line_starts(source: str) -> list[int]:
    starts = [0]
    for i, ch in enumerate(source):
        if ch == "\n":
            starts.append(i + 1)
    return starts


def _span(source: str, starts: list[int], edit: Edit) -> tuple[int, int]:
    def offset(line: int, col: int) -> int:
        if line < 1 or line > len(starts):
            raise ValueError(f"edit line {line} out of range")
        return starts[line - 1] + col

    a = offset(edit.line, edit.col)
    b = offset(edit.end_line, edit.end_col)
    if b < a or b > len(source):
        raise ValueError(f"bad edit span {edit}")
    return a, b


def apply_edits(source: str, edits: list[Edit]) -> str:
    """Apply non-overlapping edits to ``source`` in one pass.

    Edits are sorted by start offset; any pair whose spans overlap (a
    zero-width insertion exactly at another edit's boundary is fine)
    raises :class:`OverlappingEditsError` — refusal, not resolution.
    """
    starts = _line_starts(source)
    spans = sorted(
        (( *_span(source, starts, e), e) for e in edits),
        key=lambda t: (t[0], t[1]),
    )
    prev_end = -1
    for a, b, e in spans:
        if a < prev_end:
            raise OverlappingEditsError(
                f"edit at {e.line}:{e.col} overlaps a previous edit"
            )
        prev_end = b
    out = source
    for a, b, e in reversed(spans):
        out = out[:a] + e.replacement + out[b:]
    return out


def edits_overlap(source: str, accepted: list[Edit],
                  candidate: list[Edit]) -> bool:
    """Would ``candidate`` overlap any already-accepted edit?"""
    starts = _line_starts(source)
    acc = [_span(source, starts, e) for e in accepted]
    for e in candidate:
        a, b = _span(source, starts, e)
        for (x, y) in acc:
            if a < y and x < b:
                return True
            if a == x and b == y:
                return True  # identical span: still two writers
    return False


# ---- stale-suppression removal ----------------------------------------------

def suppression_edits(source: str,
                      stale: list[dict]) -> list[tuple[Edit, str]]:
    """Edits removing (or trimming) the inline ``# graftlint-torch: disable=``
    comments that ``--check-stale`` reported as dead.

    ``stale`` entries carry the TARGET line (the line the suppression
    applies to) and the dead rule id. A comment whose every id is dead is
    removed whole (its entire line when nothing else is on it); a comment
    with live ids left is rewritten without the dead ones.
    """
    by_line: dict[int, set[str]] = {}
    for s in stale:
        by_line.setdefault(int(s["line"]), set()).add(s["rule"])
    out: list[tuple[Edit, str]] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(StringIO(source).readline))
    except tokenize.TokenError:
        return []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        kind = m.group(1)
        target = tok.start[0] + (1 if kind.endswith("next-line") else 0)
        dead = by_line.get(target)
        if not dead:
            continue
        ids = [s.strip() for s in m.group(2).split(",") if s.strip()]
        live = [i for i in ids if i not in dead]
        row = tok.start[0]
        line_text = lines[row - 1] if row <= len(lines) else ""
        if live:
            # trim just the dead ids, keep the comment
            a = tok.start[1] + m.start(2)
            b = tok.start[1] + m.end(2)
            out.append((
                Edit(line=row, col=a, end_line=row, end_col=b,
                     replacement=",".join(live)),
                f"drop stale id(s) {sorted(dead & set(ids))} from the "
                f"suppression on line {row}",
            ))
            continue
        before = line_text[: tok.start[1]]
        if before.strip():
            # code shares the line: remove the comment and the padding
            # separating it from the code
            a = len(before.rstrip())
            out.append((
                Edit(line=row, col=a, end_line=row, end_col=len(line_text),
                     replacement=""),
                f"remove the stale suppression comment on line {row}",
            ))
        else:
            # the comment owns the line: remove the line entirely
            out.append((
                Edit(line=row, col=0, end_line=row + 1, end_col=0,
                     replacement="")
                if row < len(lines) or source.endswith("\n")
                else Edit(line=row, col=0, end_line=row,
                          end_col=len(line_text), replacement=""),
                f"remove the stale suppression line {row}",
            ))
    return out


# ---- the per-run fix plan ----------------------------------------------------

@dataclass
class FileFix:
    path: str                         # absolute
    relpath: str
    old_source: str
    new_source: str
    applied: list[str] = field(default_factory=list)   # descriptions
    skipped: list[str] = field(default_factory=list)   # reason strings

    def diff(self) -> str:
        return "".join(difflib.unified_diff(
            self.old_source.splitlines(keepends=True),
            self.new_source.splitlines(keepends=True),
            fromfile=f"a/{self.relpath}", tofile=f"b/{self.relpath}",
        ))


@dataclass
class FixPlan:
    files: list[FileFix] = field(default_factory=list)
    # (finding-or-label, reason) pairs the plan refused
    skipped: list[tuple[str, str]] = field(default_factory=list)
    stale_baseline_removed: int = 0
    baseline: Baseline | None = None   # rewritten baseline, when changed

    @property
    def applied_count(self) -> int:
        return sum(len(f.applied) for f in self.files)


def plan_fixes(result: LintResult, root: str,
               baseline: Baseline | None = None) -> FixPlan:
    """Turn a lint result into a concrete, conflict-free rewrite plan.

    Per file: fixable findings' edits are accepted in source order, each
    refused (with a reason) if it would overlap an accepted one; stale
    suppression comments are removed alongside. The rewritten source must
    re-parse or the whole file is reverted. Stale baseline entries are
    dropped from the (returned, not yet saved) baseline."""
    plan = FixPlan()

    by_path: dict[str, list[Finding]] = {}
    for f in result.fixable:
        by_path.setdefault(f.path, []).append(f)
    supp_by_path: dict[str, list[dict]] = {}
    for s in result.unused_suppressions:
        supp_by_path.setdefault(s["path"], []).append(s)

    for relpath in sorted(set(by_path) | set(supp_by_path)):
        path = os.path.join(root, relpath)
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            plan.skipped.append((relpath, f"unreadable: {e}"))
            continue
        file_fix = FileFix(path=path, relpath=relpath, old_source=source,
                           new_source=source)
        accepted: list[Edit] = []
        for finding in sorted(by_path.get(relpath, ()),
                              key=lambda f: (f.line, f.col)):
            fix = finding.fix
            assert fix is not None
            try:
                clash = edits_overlap(source, accepted, list(fix.edits))
            except ValueError as e:
                file_fix.skipped.append(
                    f"{finding.rule} at {relpath}:{finding.line}: "
                    f"bad edit span ({e})"
                )
                continue
            if clash:
                file_fix.skipped.append(
                    f"{finding.rule} at {relpath}:{finding.line}: "
                    "overlaps an earlier fix — refused, re-run --fix "
                    "after applying"
                )
                continue
            accepted.extend(fix.edits)
            file_fix.applied.append(
                f"{finding.rule} {relpath}:{finding.line}: "
                f"{fix.description}"
            )
        for edit, desc in suppression_edits(
            source, supp_by_path.get(relpath, [])
        ):
            if edits_overlap(source, accepted, [edit]):
                file_fix.skipped.append(
                    f"stale suppression at {relpath}:{edit.line}: "
                    "overlaps an earlier fix — refused"
                )
                continue
            accepted.extend([edit])
            file_fix.applied.append(f"{relpath}:{edit.line}: {desc}")
        if not accepted:
            if file_fix.skipped:
                plan.skipped.extend(("", s) for s in file_fix.skipped)
            continue
        new_source = apply_edits(source, accepted)
        try:
            ast.parse(new_source, filename=relpath)
        except SyntaxError as e:
            plan.skipped.append((
                relpath,
                f"fixed source no longer parses ({e.msg} at line "
                f"{e.lineno}) — file reverted, nothing applied",
            ))
            continue
        file_fix.new_source = new_source
        plan.files.append(file_fix)
        plan.skipped.extend((relpath, s) for s in file_fix.skipped)

    if baseline is not None and result.stale_baseline:
        remaining = []
        removed = 0
        stale_by_key = {
            (e["rule"], e["path"], e["context"]): int(e.get("unfired", 0))
            for e in result.stale_baseline
        }
        for e in baseline.entries:
            key = (e["rule"], e["path"], e["context"])
            unfired = stale_by_key.get(key, 0)
            if unfired <= 0:
                remaining.append(e)
                continue
            count = int(e.get("count", 1))
            take = min(count, unfired)
            stale_by_key[key] = unfired - take
            removed += take
            if count - take > 0:
                remaining.append(dict(e, count=count - take))
        if removed:
            plan.stale_baseline_removed = removed
            plan.baseline = Baseline(entries=remaining, path=baseline.path)
    return plan


def write_plan(plan: FixPlan) -> None:
    """Apply a plan to disk: rewrite each fixed file, save the trimmed
    baseline. (Dry-run callers print :meth:`FileFix.diff` instead.)"""
    for file_fix in plan.files:
        with open(file_fix.path, "w", encoding="utf-8") as fh:
            fh.write(file_fix.new_source)
    if plan.baseline is not None:
        plan.baseline.save()
