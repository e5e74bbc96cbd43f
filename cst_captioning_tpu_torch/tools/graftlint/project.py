"""The port's graftlint whole-program pass: the project index.

Pass 1 of the two-pass engine (see :mod:`core`): every module under the lint
paths is summarized into a :class:`ProjectIndex` — a project-wide symbol
table that the interprocedural ``ProjectRule``s (GL001, GL013, GL019) and
the mesh-aware per-file rules (GL012, GL015) query during pass 2. It is the
JAX package's index with its facts retargeted to torch and CUDA.

What the index knows:

- **modules** — dotted-name → :class:`ModuleSummary` (path, import-alias
  map, function table), with suffix-based lookup so both package-absolute
  (``cst_captioning_tpu_torch.rl.scst.rollout``) and fixture-local
  (``producer.f``) callee names resolve.
- **function summaries** — per top-level function/method: whether the
  return value is a CUDA tensor (the ``ops/`` wrappers' results,
  ``train.mesh.shard_batch``, ``.to(device)`` / ``.cuda()``, a torch
  factory given a ``device=``, and any callee returning one — resolved by a
  global fixpoint over the call graph), and whether a generator yields
  CUDA tensors (``data/prefetch.py``'s ``prefetch_to_device``: stages with
  ``.to(device)``, then yields).
- **mesh declaration** — the axes and ``*PARTITION_RULES`` families that
  ``<root>/cst_captioning_tpu_torch/train/mesh.py`` declares, scraped once
  per run.
- **call reach** — every def (nested ones included) with its resolved
  callees; the defs reachable from the distributed modules (``train/
  multihost.py``, ``train/mesh.py``, ``parallel/comms.py``,
  ``parallel/seq_parallel.py``, ``ops/decode_mp.py``) are GL019's scope.
- **rank taint** (:class:`HostTaint`) — per function, whether a value (and
  any shape or wire dtype derived from it) depends on this rank's identity
  (``dist.get_rank()``, ``mesh.rank``, ``multihost.process_index()``, a
  rank-conditional branch, a ragged slice). Results of the port's gather
  helpers (``allgather_pyobj``, ``global_scalar_mean``, ...) are the same
  on every rank and cleanse the taint. Whether a function's *return* has a
  rank-dependent shape propagates through the fixpoint.
- **on-disk summary cache** — ``<root>/.graftlint_torch_cache.json`` keyed
  by ``(mtime, size)`` per file; summaries are cached before the fixpoint,
  which is recomputed every run. A schema change (``_CACHE_VERSION``) or
  any edit of this module discards an old cache wholesale.

Everything here is stdlib-``ast`` only — no torch, numpy or JAX import.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from dataclasses import dataclass, field

# ---- shared AST helpers (canonical home; rules.py imports them) -------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

PACKAGE = "cst_captioning_tpu_torch"


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for a Name/Attribute chain, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def _unparse(node: ast.AST | None) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - defensive
        return ""


def module_name_for(relpath: str) -> str:
    """Dotted module name for a repo-relative posix path."""
    name = relpath[:-3] if relpath.endswith(".py") else relpath
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def import_aliases(tree: ast.Module, module_name: str,
                   nodes=None) -> dict[str, str]:
    """Local name -> canonical dotted target, from the module's imports.

    ``import torch.distributed as dist`` -> ``{'dist':
    'torch.distributed'}``; ``from ..train import mesh`` ->
    ``{'mesh': 'cst_captioning_tpu_torch.train.mesh'}``; relative imports
    resolve against ``module_name``'s package. ``nodes`` (the import
    nodes, when the caller already has them) spares a walk of the tree.
    """
    pkg = module_name.split(".")[:-1]
    out: dict[str, str] = {}
    for node in (ast.walk(tree) if nodes is None else nodes):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".", 1)[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg[: len(pkg) - (node.level - 1)]
                base = ".".join(
                    base_parts + ([node.module] if node.module else [])
                )
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{base}.{a.name}" if base else a.name
                out[a.asname or a.name] = target
    return out


def resolve_dotted(dotted: str, aliases: dict[str, str]) -> str:
    """Expand the first segment of a dotted name through the alias map."""
    if not dotted:
        return dotted
    first, _, rest = dotted.partition(".")
    base = aliases.get(first)
    if base is None:
        return dotted
    return f"{base}.{rest}" if rest else base


# ---- CUDA provenance ---------------------------------------------------------

# tensor methods whose result is a HOST value (the explicit readbacks)
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# resolved calls whose result is a host value
_HOST_EXACT = {"float", "int", "len", "str", "bool", "repr", "round"}
_HOST_BASES = ("numpy.", "math.", "json.")
# torch factories: a CUDA tensor when given a device= that is not the CPU
_TORCH_FACTORIES = {
    "zeros", "ones", "empty", "full", "arange", "rand", "randn", "randint",
    "randperm", "tensor", "as_tensor", "zeros_like", "ones_like",
    "empty_like", "full_like", "linspace", "eye",
}
# the port's kernel wrappers and placement helpers (matched by the last
# segment of the resolved name, inside the package): their results live on
# the device the caller computes on, which the lint takes to be the card
_DEVICE_WRAPPER_PREFIXES = ("fused_",)
_DEVICE_WRAPPERS = {
    "mp_decode_stride", "mp_beam_step", "shard_batch", "place_blocking",
    "put_global", "put_full_global", "from_host_local",
}
# generators whose yields are CUDA tensors
_DEVICE_GENERATORS = {"prefetch_to_device"}


def _is_cpu_literal(node: ast.AST | None) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` (the only device the lint can
    prove is not the card)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cpu")
    if isinstance(node, ast.Call) and _last(_dotted(node.func)) == "device" \
            and node.args:
        return _is_cpu_literal(node.args[0])
    return False


def _device_arg(node: ast.AST) -> bool:
    """Whether ``node``, given as a ``.to()`` argument, names a device."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return not node.value.startswith("cpu")
    if isinstance(node, ast.Call) and _last(_dotted(node.func)) == "device":
        return not _is_cpu_literal(node)
    d = _dotted(node)
    return bool(d) and ("device" in _last(d) or _last(d) in ("dev",))


def moves_to_device(call: ast.Call) -> bool:
    """A ``.cuda()``, or a ``.to(...)`` that names a device (not only a
    dtype)."""
    if call.func.attr == "cuda":
        return True
    return any(_device_arg(a) for a in call.args) or any(
        kw.arg == "device" and not _is_cpu_literal(kw.value)
        for kw in call.keywords)


class Provenance:
    """Which local names hold CUDA tensors, and why, over ONE function body
    walked in source order. ``lookup`` resolves a callee's summary (the
    index at rule time; None in pass 1, where unresolved calls are left
    pending for the fixpoint)."""

    def __init__(self, aliases: dict[str, str], lookup=None):
        self.aliases = aliases
        self.lookup = lookup
        self.device_vars: dict[str, str] = {}
        self.pending_vars: dict[str, str] = {}

    def of(self, expr: ast.AST | None) -> tuple[str, str]:
        """-> (why ``expr`` is a CUDA tensor or '', pending callee or '')."""
        if expr is None:
            return "", ""
        if isinstance(expr, ast.Name):
            return (self.device_vars.get(expr.id, ""),
                    self.pending_vars.get(expr.id, ""))
        if isinstance(expr, (ast.Attribute, ast.Subscript, ast.Starred)):
            if isinstance(expr, ast.Attribute) and expr.attr in (
                    "shape", "dtype", "device", "ndim", "is_cuda"):
                return "", ""  # metadata: a host value
            return self.of(expr.value)
        if isinstance(expr, ast.Call):
            return self._call(expr)
        if isinstance(expr, ast.BinOp):
            return self._first(expr.left, expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.of(expr.operand)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return self._first(*expr.elts)
        if isinstance(expr, ast.IfExp):
            return self._first(expr.body, expr.orelse)
        return "", ""

    def _first(self, *sides) -> tuple[str, str]:
        pending = ""
        for side in sides:
            why, p = self.of(side)
            if why:
                return why, ""
            pending = pending or p
        return "", pending

    def _call(self, call: ast.Call) -> tuple[str, str]:
        func = call.func
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr in HOST_METHODS:
                return "", ""
            if attr in ("to", "cuda") and moves_to_device(call):
                return f"{_unparse(call)[:40]}", ""
        resolved = resolve_dotted(_dotted(func), self.aliases)
        last = _last(resolved)
        if resolved in _HOST_EXACT or resolved.startswith(_HOST_BASES):
            return "", ""
        if resolved.startswith("torch."):
            for kw in call.keywords:
                if kw.arg == "device" and last in _TORCH_FACTORIES:
                    if _is_cpu_literal(kw.value):
                        return "", ""
                    return (f"{resolved}(..., device="
                            f"{_unparse(kw.value)[:24]})"), ""
            if not resolved.startswith(("torch.cuda.", "torch.distributed.")):
                # an op over a CUDA operand computes on the card
                for a in call.args:
                    why, _ = self.of(a)
                    if why:
                        return why, ""
            return "", ""
        if isinstance(func, ast.Attribute):
            # a method of a CUDA tensor returns a CUDA tensor
            why, _ = self.of(func.value)
            if why:
                return why, ""
        if resolved.startswith(PACKAGE + ".") or "." not in resolved:
            if last in _DEVICE_WRAPPERS or last.startswith(
                    _DEVICE_WRAPPER_PREFIXES):
                return f"result of {last}(...)", ""
        if not resolved or resolved.startswith(("torch.", "numpy.")):
            return "", ""
        if self.lookup is not None:
            target = self.lookup(resolved)
            if target is not None and target.returns_device:
                return (f"returns from {resolved}() "
                        f"[{target.device_reason}]"), ""
            return "", ""
        return "", resolved

    def bind(self, names: list[str], value: ast.AST) -> None:
        why, pending = self.of(value)
        for n in names:
            self.device_vars.pop(n, None)
            self.pending_vars.pop(n, None)
            if why:
                self.device_vars[n] = why
            elif pending:
                self.pending_vars[n] = pending

    def bind_loop_target(self, node: ast.For) -> None:
        """Loop targets over a CUDA-yielding generator are CUDA tensors."""
        names = [s.id for s in ast.walk(node.target)
                 if isinstance(s, ast.Name)]
        why = ""
        if isinstance(node.iter, ast.Call):
            resolved = resolve_dotted(_dotted(node.iter.func), self.aliases)
            if _last(resolved) in _DEVICE_GENERATORS:
                why = f"yielded by {_last(resolved)}()"
            elif self.lookup is not None:
                target = self.lookup(resolved)
                if target is not None and target.yields_device:
                    why = f"yielded by {resolved}() [{target.device_reason}]"
        for n in names:
            self.device_vars.pop(n, None)
            self.pending_vars.pop(n, None)
            if why:
                self.device_vars[n] = why


# ---- rank taint (GL019) ------------------------------------------------------

# resolved calls whose RESULT differs per rank: the seeds of the taint
PER_HOST_CALLS = {
    "torch.distributed.get_rank",
    "torch.distributed.get_node_local_rank",
}
PER_HOST_LASTS = {"process_index", "host_shard", "host_identity"}
# attributes whose value differs per rank (``mesh.rank``)
PER_HOST_ATTRS = {"rank"}
# the port's gather helpers: every rank gets the same result, whatever it
# fed in, so their results (and what derives from them) may size buffers
GLOBALLY_CONSISTENT_LASTS = {
    "allgather_pyobj", "broadcast_pyobj", "allgather_to_host",
    "global_scalar_mean", "global_weighted_mean", "allgather_arrays",
    "_allgather_f64", "_allgather_bytes", "all_gather_object",
    "broadcast_object_list",
}
# constructors whose first argument (or ``size=``) is the shape
_SHAPE_CTORS = {"zeros", "ones", "full", "empty", "new_zeros", "new_ones",
                "new_full", "new_empty", "randn", "rand"}


class HostTaint:
    """Abstract per-rank taint environment over ONE function body, in
    source order: whether a local name's VALUE differs per rank, and whether
    its SHAPE or wire dtype does (constructor sizes, ``.to`` dtypes, ragged
    slice bounds built from per-rank values). Used by the pass-1 summarizer
    without cross-module resolution (``lookup=None``), and by GL019 with the
    index plugged in."""

    def __init__(self, aliases: dict[str, str], lookup=None):
        self.aliases = aliases
        self.lookup = lookup
        self.host_vals: dict[str, str] = {}
        self.host_shapes: dict[str, str] = {}

    def _callee(self, resolved: str):
        if self.lookup is None or not resolved or \
                resolved.startswith(("torch.", "numpy.")):
            return None
        return self.lookup(resolved)

    def value_taint(self, expr: ast.AST | None) -> str:
        """Why ``expr``'s VALUE differs per rank ('' = no known reason)."""
        if expr is None:
            return ""
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                continue
            if isinstance(node, ast.Call):
                resolved = resolve_dotted(_dotted(node.func), self.aliases)
                last = _last(resolved)
                if resolved in PER_HOST_CALLS or (
                        resolved.startswith(PACKAGE) or "." not in resolved
                        or resolved.startswith("multihost.")) \
                        and last in PER_HOST_LASTS:
                    return f"{resolved}()"
                if last in GLOBALLY_CONSISTENT_LASTS:
                    continue  # the same on every rank: args don't leak out
                target = self._callee(resolved)
                if target is not None and target.returns_host_value:
                    return (f"{resolved}() → "
                            f"{target.host_value_reason or 'per-rank value'}")
            if isinstance(node, ast.Attribute) and \
                    node.attr in PER_HOST_ATTRS and \
                    isinstance(node.ctx, ast.Load):
                return _unparse(node)
            if isinstance(node, ast.Name) and node.id in self.host_vals:
                return self.host_vals[node.id]
            stack.extend(ast.iter_child_nodes(node))
        return ""

    def shape_taint(self, expr: ast.AST | None) -> str:
        """Why ``expr``'s SHAPE or wire dtype differs per rank ('' = no
        provable reason — unknown shapes stay quiet, never guess)."""
        if expr is None:
            return ""
        if isinstance(expr, ast.Name):
            return self.host_shapes.get(expr.id, "")
        if isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                t = self.shape_taint(e)
                if t:
                    return t
            return ""
        if isinstance(expr, ast.BinOp):
            return self.shape_taint(expr.left) or \
                self.shape_taint(expr.right)
        if isinstance(expr, ast.IfExp):
            t = self.value_taint(expr.test)
            if t:
                return f"shape chosen by a branch on {t}"
            return self.shape_taint(expr.body) or \
                self.shape_taint(expr.orelse)
        if isinstance(expr, ast.Subscript):
            sl = expr.slice
            bounds: list = []
            if isinstance(sl, ast.Slice):
                bounds = [b for b in (sl.lower, sl.upper, sl.step)
                          if b is not None]
            for b in bounds:
                t = self.value_taint(b)
                if t:
                    return f"ragged slice bound from {t}"
            return self.shape_taint(expr.value)
        if isinstance(expr, ast.Call):
            resolved = resolve_dotted(_dotted(expr.func), self.aliases)
            last = _last(resolved)
            recv = expr.func.value if isinstance(expr.func, ast.Attribute) \
                else None
            if last in _SHAPE_CTORS:
                size_args = list(expr.args) + [
                    kw.value for kw in expr.keywords if kw.arg == "size"]
                for a in size_args:
                    t = self.value_taint(a)
                    if t:
                        return f"constructor shape built from {t}"
                return self._dtype_kwarg_taint(expr)
            if last == "to":
                for a in list(expr.args) + [kw.value for kw in expr.keywords
                                            if kw.arg == "dtype"]:
                    t = self.value_taint(a)
                    if t:
                        return f"wire dtype chosen by {t}"
                return self.shape_taint(recv)
            if last in ("reshape", "view", "narrow", "expand", "repeat"):
                for a in expr.args:
                    t = self.value_taint(a)
                    if t:
                        return f"reshaped to a size from {t}"
                return self.shape_taint(recv)
            if last in ("cat", "stack", "concatenate", "hstack", "vstack",
                        "tensor", "as_tensor"):
                for a in expr.args:
                    t = self.shape_taint(a)
                    if t:
                        return t
                return self._dtype_kwarg_taint(expr)
            if last == "pad":
                for a in expr.args[1:]:
                    t = self.value_taint(a)
                    if t:
                        return f"pad widths from {t}"
                return self.shape_taint(expr.args[0]) if expr.args else ""
            if recv is not None and last in ("contiguous", "clone",
                                             "flatten", "float", "half",
                                             "bfloat16"):
                return self.shape_taint(recv)
            target = self._callee(resolved)
            if target is not None and target.returns_host_shape:
                return (f"{resolved}() returns a per-rank shape "
                        f"({target.host_shape_reason or 'see its body'})")
            return ""
        return ""

    def _dtype_kwarg_taint(self, call: ast.Call) -> str:
        for kw in call.keywords:
            if kw.arg == "dtype":
                t = self.value_taint(kw.value)
                if t:
                    return f"dtype chosen by {t}"
        return ""

    def bind(self, names: list[str], value: ast.AST) -> None:
        """Rebind ``names`` (pure Name/tuple targets only — mutations like
        ``x[i] = v`` must not clear what is known about ``x``)."""
        vt = self.value_taint(value)
        st = self.shape_taint(value)
        if not st and vt and isinstance(value, (ast.List, ast.ListComp)):
            st = f"a list built from {vt}"
        for n in names:
            self.host_vals.pop(n, None)
            self.host_shapes.pop(n, None)
            if vt:
                self.host_vals[n] = vt
            if st:
                self.host_shapes[n] = st

    def taint_branch_stores(self, stmts: list[ast.stmt],
                            reason: str) -> None:
        """Names assigned under a rank-conditional branch get BOTH taints:
        their value and (potentially) their shape now depend on which rank
        is running."""
        why = f"assigned under a branch on {reason}"
        work: list[ast.AST] = list(stmts)
        in_place: set[int] = set()   # augmented targets keep their shape
        while work:
            node = work.pop()
            if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(node, ast.AugAssign):
                in_place.add(id(node.target))
            if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Store
            ):
                self.host_vals.setdefault(node.id, why)
                if id(node) not in in_place:
                    self.host_shapes.setdefault(node.id, why)
            work.extend(ast.iter_child_nodes(node))


def bind_targets(targets: list[ast.AST]) -> list[str]:
    """Pure Name (and tuple-of-Name) targets of an assignment."""
    names: list[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                inner = e.value if isinstance(e, ast.Starred) else e
                if isinstance(inner, ast.Name):
                    names.append(inner.id)
    return names


# ---- per-function summaries -------------------------------------------------

@dataclass
class FunctionSummary:
    """What callers may rely on about one function, without reading it."""

    qualname: str                    # module-relative, e.g. "Trainer.fit"
    lineno: int
    params: list[str] = field(default_factory=list)
    returns_device: bool = False
    device_reason: str = ""          # human chain: why the return is CUDA
    yields_device: bool = False
    # callees whose result this function returns (pre-fixpoint pending set)
    returns_calls: list[str] = field(default_factory=list)
    # the return value's SHAPE (or wire dtype) depends on per-rank values
    returns_host_shape: bool = False
    host_shape_reason: str = ""
    # the return VALUE differs per rank (e.g. host_shard())
    returns_host_value: bool = False
    host_value_reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FunctionSummary":
        return cls(**d)


@dataclass
class DefInfo:
    """Call-graph view of ONE def — nested defs included, each its own
    entry: its direct callees and its lexical parent. GL019's reach runs
    over these."""

    qualname: str                    # dot-joined path, e.g. "make_step.step"
    lineno: int
    parent: str = ""                 # lexical parent qualname ("" = module)
    calls: list = field(default_factory=list)
    # callees called on every pass of one of this def's loops, and on
    # every call of this def (gated `if` bodies excluded: see
    # unconditional_nodes) — the per-step closure's edges
    loop_calls: list = field(default_factory=list)
    uncond_calls: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DefInfo":
        return cls(**d)


@dataclass
class ModuleSummary:
    module: str                      # dotted name
    relpath: str
    mtime: float = 0.0
    size: int = 0
    aliases: dict[str, str] = field(default_factory=dict)
    functions: dict[str, FunctionSummary] = field(default_factory=dict)
    defs: dict[str, DefInfo] = field(default_factory=dict)
    parse_error: bool = False

    def to_dict(self) -> dict:
        return {
            "module": self.module, "relpath": self.relpath,
            "mtime": self.mtime, "size": self.size, "aliases": self.aliases,
            "functions": {k: f.to_dict() for k, f in self.functions.items()},
            "defs": {k: d.to_dict() for k, d in self.defs.items()},
            "parse_error": self.parse_error,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModuleSummary":
        out = cls(
            module=d["module"], relpath=d["relpath"],
            mtime=d.get("mtime", 0.0), size=d.get("size", 0),
            aliases=dict(d.get("aliases", {})),
            parse_error=bool(d.get("parse_error", False)),
        )
        out.functions = {k: FunctionSummary.from_dict(f)
                         for k, f in d.get("functions", {}).items()}
        out.defs = {k: DefInfo.from_dict(v)
                    for k, v in d.get("defs", {}).items()}
        return out


class _FunctionSummarizer:
    """Single in-order walk of one function body (nested defs excluded:
    they are separate scopes, summarized — when top-level — on their own)."""

    def __init__(self, fn: ast.AST, qualname: str, aliases: dict[str, str]):
        self.fn = fn
        args = fn.args
        params = [a.arg for a in args.posonlyargs + args.args
                  + args.kwonlyargs]
        if args.vararg:
            params.append(args.vararg.arg)
        if args.kwarg:
            params.append(args.kwarg.arg)
        self.summary = FunctionSummary(qualname=qualname, lineno=fn.lineno,
                                       params=params)
        self.prov = Provenance(aliases)
        self.taint = HostTaint(aliases)
        self.stages_to_device = False
        self.yields_any = False

    def run(self) -> FunctionSummary:
        for stmt in self.fn.body:
            self._stmt(stmt)
        if self.yields_any and self.stages_to_device and \
                not self.summary.yields_device:
            # the prefetch pattern: stages with .to(device), yields the
            # result through a queue the walker cannot see through
            self.summary.yields_device = True
            self.summary.device_reason = (
                self.summary.device_reason
                or "generator stages values with .to(device)")
        return self.summary

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            self._visit_expr(node.value)
            self._bind(node.targets, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if node.value is not None:
                self._visit_expr(node.value)
                self._bind([node.target], node.value)
        elif isinstance(node, ast.Return) and node.value is not None:
            self._visit_expr(node.value)
            self._note_return(node.value)
        elif isinstance(node, ast.Expr):
            self._visit_expr(node.value)
        elif isinstance(node, ast.For):
            self._visit_expr(node.iter)
            self.prov.bind_loop_target(node)
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
        elif isinstance(node, ast.If):
            self._visit_expr(node.test)
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
            reason = self.taint.value_taint(node.test)
            if reason:
                self.taint.taint_branch_stores(node.body + node.orelse,
                                               reason)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._visit_expr(child)
                else:
                    self._stmt(child)

    def _bind(self, targets: list[ast.AST], value: ast.AST) -> None:
        rebinds = bind_targets(targets)
        if rebinds:
            self.prov.bind(rebinds, value)
            self.taint.bind(rebinds, value)

    def _note_return(self, expr: ast.AST) -> None:
        why, pending = self.prov.of(expr)
        if why and not self.summary.returns_device:
            self.summary.returns_device = True
            self.summary.device_reason = why
        elif pending and pending not in self.summary.returns_calls:
            self.summary.returns_calls.append(pending)
        if not self.summary.returns_host_shape:
            st = self.taint.shape_taint(expr)
            if st:
                self.summary.returns_host_shape = True
                self.summary.host_shape_reason = st
        if not self.summary.returns_host_value:
            vt = self.taint.value_taint(expr)
            if vt:
                self.summary.returns_host_value = True
                self.summary.host_value_reason = vt

    def _visit_expr(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                self.yields_any = True
                if isinstance(node, ast.Yield) and node.value is not None:
                    why, _ = self.prov.of(node.value)
                    if why:
                        self.summary.yields_device = True
                        self.summary.device_reason = why
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("to", "cuda"):
                why, _ = self.prov.of(node)
                if why:
                    self.stages_to_device = True


def summarize_module(tree: ast.Module, relpath: str) -> ModuleSummary:
    """Pass-1 summary of one parsed module (pure function of the AST)."""
    module = module_name_for(relpath)
    aliases = import_aliases(tree, module)
    out = ModuleSummary(module=module, relpath=relpath, aliases=aliases)

    def visit(body: list[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, _FUNC_NODES):
                qual = f"{prefix}{node.name}"
                out.functions[qual] = _FunctionSummarizer(
                    node, qual, aliases).run()
            elif isinstance(node, ast.ClassDef):
                visit(node.body, f"{prefix}{node.name}.")

    visit(tree.body, "")
    out.defs = scan_defs(tree, aliases)
    return out


def def_qualnames(tree: ast.Module) -> dict[int, str]:
    """id(def node) -> dot-joined qualname, for EVERY def (nested included,
    classes joined without a marker: ``Trainer.fit.step``)."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                qual = f"{prefix}{child.name}"
                out[id(child)] = qual
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def unconditional_nodes(body: list[ast.stmt]):
    """Every node of ``body`` that runs on each pass: statements and ``if``
    tests, not the body of an ``if`` without ``else`` (a log-every-N
    readback is a deliberate, amortized sync; of an ``if``/``else`` one
    arm runs every pass, so both count), not ``except`` handlers (the
    failure path), not nested defs, lambdas or classes."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.If) and not node.orelse:
            stack.extend(ast.walk(node.test))
            continue
        if isinstance(node, ast.ExceptHandler):
            continue  # the failure path, not every pass
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _callee_name(call: ast.Call, aliases: dict[str, str]) -> str:
    d = _dotted(call.func)
    if d.startswith(("self.", "cls.")):
        # a method: its bare name, looked up among this module's defs
        # (never through the imports, which may bind the same name)
        return d.split(".", 1)[1]
    resolved = resolve_dotted(d, aliases)
    if not resolved or resolved.startswith(("torch.", "numpy.")):
        return ""
    return resolved


def scan_defs(tree: ast.Module, aliases: dict[str, str]) -> dict[str, DefInfo]:
    """Every def's direct callees, its per-pass callees (those called
    unconditionally in one of its loops, and unconditionally in its body:
    gated ``if`` bodies excluded, as :func:`unconditional_nodes`) and its
    lexical parent (nested defs included). ``self.f(...)`` calls resolve
    to a method ``f`` by its bare name. One traversal; pure AST."""
    funcs: dict[str, DefInfo] = {}
    # (node, owner, prefix, unconditional, in an unconditional loop body)
    stack: list[tuple] = [(tree, "", "", False, False)]
    while stack:
        node, owner, prefix, uncond, in_loop = stack.pop()
        loop_body = isinstance(node, (ast.For, ast.While))
        if_node = isinstance(node, ast.If)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                qual = f"{prefix}{child.name}"
                funcs[qual] = DefInfo(qualname=qual, lineno=child.lineno,
                                      parent=owner)
                stack.append((child, qual, f"{qual}.", True, False))
                continue
            if isinstance(child, ast.ClassDef):
                stack.append((child, owner, f"{prefix}{child.name}.",
                              False, False))
                continue
            c_uncond, c_loop = uncond, in_loop
            if if_node and child is not node.test and not node.orelse or \
                    isinstance(child, ast.ExceptHandler):
                c_uncond = c_loop = False       # a gated or failure path
            elif loop_body and isinstance(child, ast.stmt) and uncond and \
                    child in node.body:
                c_loop = True
            elif isinstance(child, ast.Lambda):
                c_uncond = c_loop = False
            if isinstance(child, ast.Call) and owner:
                info = funcs[owner]
                resolved = _callee_name(child, aliases)
                if resolved:
                    if resolved not in info.calls:
                        info.calls.append(resolved)
                    if c_uncond and resolved not in info.uncond_calls:
                        info.uncond_calls.append(resolved)
                    if c_loop and resolved not in info.loop_calls:
                        info.loop_calls.append(resolved)
            stack.append((child, owner, prefix, c_uncond, c_loop))
    return funcs


# ---- mesh declaration (GL012/GL015/GL007 shared scrape) ---------------------

@dataclass
class MeshDecl:
    """What the port's train/mesh.py declares: the axes and the rule
    families the sharding-surface rules check literals against."""

    axes: frozenset = frozenset({"data", "seq", "mp"})
    families: tuple = ()             # ((family, regex), ...)
    found: bool = False

    def to_dict(self) -> dict:
        return {"axes": sorted(self.axes), "families": list(self.families),
                "found": self.found}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshDecl":
        return cls(axes=frozenset(d.get("axes", ("data", "seq", "mp"))),
                   families=tuple(tuple(f) for f in d.get("families", ())),
                   found=bool(d.get("found")))


MESH_RELPATH = f"{PACKAGE}/train/mesh.py"
# GL019 seed modules: collectives reachable from these are cross-rank
# rendezvous points where every participating rank must agree
MULTIHOST_SEED_RELPATHS = (
    f"{PACKAGE}/train/multihost.py",
    f"{PACKAGE}/train/mesh.py",
    f"{PACKAGE}/parallel/comms.py",
    f"{PACKAGE}/parallel/seq_parallel.py",
    f"{PACKAGE}/ops/decode_mp.py",
)


def scrape_mesh_decl(tree: ast.Module) -> MeshDecl:
    """Mesh axes — string defaults of ``*axis`` function parameters (the
    ``axis="data"`` / ``seq_axis="seq"`` spelling) and the string literals
    a ``for ..., row_axis in ((...), ...)`` loop binds to an ``*axis`` name
    (``make_mesh``'s ``'mp'``) — and the regex families of every
    ``*PARTITION_RULES`` table."""
    axes: set[str] = set()
    families: list[tuple[str, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_NODES):
            args = node.args
            pos = args.posonlyargs + args.args
            pairs = list(zip(pos[len(pos) - len(args.defaults):],
                             args.defaults)) + [
                (a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                if d is not None]
            for arg, default in pairs:
                if arg.arg.endswith("axis") and isinstance(
                        default, ast.Constant) and isinstance(
                        default.value, str) and default.value:
                    axes.add(default.value)
        elif isinstance(node, ast.For) and isinstance(
                node.target, ast.Tuple) and isinstance(
                node.iter, (ast.Tuple, ast.List)):
            slots = [i for i, t in enumerate(node.target.elts)
                     if isinstance(t, ast.Name) and t.id.endswith("axis")]
            for row in node.iter.elts:
                for i in slots:
                    elt = getattr(row, "elts", [])
                    if i < len(elt) and isinstance(elt[i], ast.Constant) \
                            and isinstance(elt[i].value, str):
                        axes.add(elt[i].value)
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if any(n.endswith("PARTITION_RULES") for n in names):
                for elt in getattr(node.value, "elts", []):
                    parts = getattr(elt, "elts", [])
                    if len(parts) >= 2 and isinstance(
                            parts[0], ast.Constant) and isinstance(
                            parts[1], ast.Constant):
                        families.append((str(parts[0].value),
                                         str(parts[1].value)))
    return MeshDecl(axes=frozenset(axes) if axes else MeshDecl.axes,
                    families=tuple(families), found=True)


# ---- the index --------------------------------------------------------------

CACHE_NAME = ".graftlint_torch_cache.json"
_CACHE_VERSION = 1
_FIXPOINT_MAX_ROUNDS = 25


@dataclass
class IndexStats:
    files: int = 0
    summarized: int = 0
    cached: int = 0


class ProjectIndex:
    """Project-wide symbol table + call-graph summaries (pass 1)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: dict[str, ModuleSummary] = {}      # dotted name ->
        self.by_relpath: dict[str, ModuleSummary] = {}
        self.mesh = MeshDecl()
        self.stats = IndexStats()
        # dotted function name ("<module>.<qual>") -> summary
        self.functions: dict[str, FunctionSummary] = {}
        self._suffix_cache: dict[str, str | None] = {}
        self._fn_by_last: dict[str, list[str]] | None = None
        # "<module>.<qualname>" (nested defs included) -> call-graph view
        self.defs: dict[str, DefInfo] = {}
        self._def_suffix_cache: dict[tuple[str, str], str | None] = {}
        self._def_by_last: dict[str, list[str]] | None = None
        # defs reachable from the distributed modules — GL019's scope
        self.multihost_reach: frozenset = frozenset()
        # hot-package defs that run every step -> what makes them per-step
        # ("the loop in X" / "the step function X", reached directly or
        # through per-step callees): GL001/GL003
        self.per_step: dict[str, str] = {}
        # (source, tree) for files parsed THIS run (cache misses): pass 2
        # adopts them instead of re-parsing
        self.parsed: dict[str, tuple[str, ast.Module]] = {}

    @classmethod
    def build(cls, files: list[str], root: str,
              cache_path: str | None = None) -> "ProjectIndex":
        """Summarize ``files`` (absolute paths) under ``root``; reuse the
        mtime-keyed on-disk cache at ``cache_path`` (default
        ``<root>/.graftlint_torch_cache.json``; '' disables caching)."""
        index = cls(root)
        if cache_path is None:
            cache_path = os.path.join(index.root, CACHE_NAME)
        cache = _load_cache(cache_path) if cache_path else {}
        entries = cache.get("files", {})
        dirty = False

        todo = list(files)
        # the mesh declaration joins every index, however narrow the
        # linted path set is
        decl_path = os.path.join(index.root, MESH_RELPATH)
        if os.path.exists(decl_path) and not any(
                os.path.abspath(p) == decl_path for p in todo):
            todo.append(decl_path)

        for path in todo:
            relpath = os.path.relpath(path, index.root).replace(os.sep, "/")
            try:
                st = os.stat(path)
            except OSError:
                continue
            index.stats.files += 1
            ent = entries.get(relpath)
            if ent and ent.get("mtime") == st.st_mtime and \
                    ent.get("size") == st.st_size:
                summary = ModuleSummary.from_dict(ent["summary"])
                mesh = MeshDecl.from_dict(ent["mesh"]) if "mesh" in ent \
                    else None
                index.stats.cached += 1
            else:
                summary, mesh, parsed = _summarize_path(path, relpath)
                if parsed is not None:
                    index.parsed[relpath] = parsed
                entries[relpath] = {
                    "mtime": st.st_mtime, "size": st.st_size,
                    "summary": summary.to_dict(),
                }
                if mesh is not None:
                    entries[relpath]["mesh"] = mesh.to_dict()
                index.stats.summarized += 1
                dirty = True
            summary.mtime, summary.size = st.st_mtime, st.st_size
            index.modules[summary.module] = summary
            index.by_relpath[relpath] = summary
            if relpath == MESH_RELPATH and mesh is not None:
                index.mesh = mesh

        for module in index.modules.values():
            for qual, fn in module.functions.items():
                index.functions[f"{module.module}.{qual}"] = fn
            for qual, info in module.defs.items():
                index.defs[f"{module.module}.{qual}"] = info
        index._fixpoint()
        index._reach()
        index._per_step()
        if cache_path and dirty:
            _save_cache(cache_path, {"version": _cache_version(),
                                     "files": entries})
        return index

    # -- lookups --------------------------------------------------------

    def lookup(self, dotted: str) -> tuple[str, FunctionSummary] | None:
        """Resolve an already-alias-expanded dotted callee name to its
        (full indexed name, summary): exact match first, then a unique
        suffix match; ambiguous suffixes resolve to nothing — never guess.
        """
        if not dotted:
            return None
        hit = self.functions.get(dotted)
        if hit is not None:
            return dotted, hit
        if dotted not in self._suffix_cache:
            by_last = self._fn_by_last
            if by_last is None:
                by_last = {}
                for k in self.functions:
                    by_last.setdefault(_last(k), []).append(k)
                self._fn_by_last = by_last
            suffix = "." + dotted
            matches = [k for k in by_last.get(_last(dotted), ())
                       if k.endswith(suffix)]
            self._suffix_cache[dotted] = (
                matches[0] if len(matches) == 1 else None)
        key = self._suffix_cache[dotted]
        return (key, self.functions[key]) if key else None

    def lookup_from(self, module: str,
                    dotted: str) -> tuple[str, FunctionSummary] | None:
        """Like :meth:`lookup`, but same-module names win first."""
        if module and dotted:
            local = f"{module}.{dotted}"
            hit = self.functions.get(local)
            if hit is not None:
                return local, hit
        return self.lookup(dotted)

    def module_of(self, relpath: str) -> str:
        mod = self.by_relpath.get(relpath)
        return mod.module if mod is not None else module_name_for(relpath)

    def aliases_for(self, relpath: str, tree: ast.Module) -> dict[str, str]:
        """Import-alias map for a file — from its module summary when the
        file was indexed, recomputed from ``tree`` otherwise."""
        mod = self.by_relpath.get(relpath)
        if mod is not None and not mod.parse_error:
            return mod.aliases
        return import_aliases(tree, module_name_for(relpath))

    def summary_lookup(self, module: str):
        """A ``dotted -> FunctionSummary | None`` resolver for one module
        (what :class:`Provenance` and :class:`HostTaint` take)."""
        def lookup(dotted: str):
            hit = self.lookup_from(module, dotted)
            return hit[1] if hit else None
        return lookup

    def _def_lookup(self, module: str, dotted: str) -> str | None:
        """A callee name -> its def entry: module-local exact first, then a
        unique suffix (same-module matches preferred)."""
        if not dotted:
            return None
        key = (module, dotted)
        if key not in self._def_suffix_cache:
            hit: str | None = None
            local = f"{module}.{dotted}"
            if dotted in self.defs:
                hit = dotted
            elif local in self.defs:
                hit = local
            else:
                by_last = self._def_by_last
                if by_last is None:
                    by_last = {}
                    for k in self.defs:
                        by_last.setdefault(_last(k), []).append(k)
                    self._def_by_last = by_last
                suffix = "." + dotted
                matches = [k for k in by_last.get(_last(dotted), ())
                           if k.endswith(suffix)]
                same_mod = [m for m in matches
                            if m.startswith(module + ".")]
                pool = same_mod or matches
                hit = pool[0] if len(pool) == 1 else None
            self._def_suffix_cache[key] = hit
        return self._def_suffix_cache[key]

    # -- cross-module fixpoint ------------------------------------------

    def _fixpoint(self) -> None:
        """Propagate CUDA-return provenance and per-rank return facts
        through returned callee results until stable."""
        owner_module = {
            f"{m.module}.{qual}": m.module
            for m in self.modules.values() for qual in m.functions
        }
        for _ in range(_FIXPOINT_MAX_ROUNDS):
            changed = False
            for name, fn in self.functions.items():
                mod = owner_module.get(name, "")
                for callee in fn.returns_calls:
                    hit = self.lookup_from(mod, callee)
                    target = hit[1] if hit else None
                    if target is None or target is fn:
                        continue
                    if target.returns_device and not fn.returns_device:
                        fn.returns_device = True
                        fn.device_reason = (
                            f"returns {callee}(...) → "
                            f"{target.device_reason or 'CUDA tensor'}")
                        changed = True
                    if target.returns_host_shape and \
                            not fn.returns_host_shape:
                        fn.returns_host_shape = True
                        fn.host_shape_reason = (
                            f"returns {callee}(...) → "
                            f"{target.host_shape_reason or 'per-rank shape'}")
                        changed = True
                    if target.returns_host_value and \
                            not fn.returns_host_value:
                        fn.returns_host_value = True
                        fn.host_value_reason = (
                            f"returns {callee}(...) → "
                            f"{target.host_value_reason or 'per-rank value'}")
                        changed = True
            if not changed:
                return

    def _per_step(self) -> None:
        """The hot-package defs that run every step: callees of a loop's
        unconditional body, then their own unconditional callees, within
        train/, rl/ and decoding/."""
        self.per_step = _per_step_closure(self)

    def _reach(self) -> None:
        """Forward closure from the distributed modules' defs over resolved
        call edges and lexical nesting: a helper a seed module calls
        (transitively) runs at the same rendezvous points."""
        edges: list[tuple[str, str]] = []
        reach: set[str] = set()
        for mod in self.modules.values():
            if mod.relpath in MULTIHOST_SEED_RELPATHS:
                reach.update(f"{mod.module}.{q}" for q in mod.defs)
            for qual, info in mod.defs.items():
                full = f"{mod.module}.{qual}"
                if info.parent:
                    edges.append((f"{mod.module}.{info.parent}", full))
                for callee in info.calls:
                    t = self._def_lookup(mod.module, callee)
                    if t is not None and t != full:
                        edges.append((full, t))
        for _ in range(_FIXPOINT_MAX_ROUNDS):
            before = len(reach)
            for caller, t in edges:
                if caller in reach:
                    reach.add(t)
            if len(reach) == before:
                break
        self.multihost_reach = frozenset(reach)


HOT_RELPATHS = tuple(f"{PACKAGE}/{p}/" for p in ("train", "rl", "decoding"))
# the kernels' wrappers: per-step only where hot code calls them each step
# (never a root of the closure themselves)
OPS_RELPATH = f"{PACKAGE}/ops/"


# a def whose name says it is one step (``step``, ``train_step``,
# ``xe_step``, ``update``, ``rl_update``): its body runs every step
STEP_DEF_RE = re.compile(r"(^|_)(step|update)$")


def _per_step_closure(index: "ProjectIndex") -> dict[str, str]:
    """Full name -> why, of every def that runs each step: the hot
    packages' step-named defs and the defs their loops call, then what
    those call unconditionally, into the ``ops/`` wrappers too."""
    reach = {f"{m.module}.{q}": (m.module, info, m.relpath.startswith(
                 HOT_RELPATHS))
             for m in index.modules.values() if m.relpath.startswith(
                 HOT_RELPATHS + (OPS_RELPATH,)) for q, info in m.defs.items()}
    out: dict[str, str] = {}
    work: list[str] = []
    for full, (module, info, hot) in reach.items():
        if hot and STEP_DEF_RE.search(_last(full)):
            out[full] = f"the step function {info.qualname}"
            work.append(full)
    for full, (module, info, hot) in reach.items():
        if not hot:
            continue
        for callee in info.loop_calls:
            t = index._def_lookup(module, callee)
            if t in reach and t != full and t not in out:
                out[t] = f"the loop in {info.qualname}"
                work.append(t)
    while work:
        full = work.pop()
        module, info, _ = reach[full]
        for callee in info.uncond_calls:
            t = index._def_lookup(module, callee)
            if t in reach and t not in out:
                out[t] = out[full]
                work.append(t)
    return out


def _summarize_path(
    path: str, relpath: str
) -> tuple[ModuleSummary, MeshDecl | None, tuple[str, ast.Module] | None]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        tree = ast.parse(source, filename=relpath)
    except (OSError, SyntaxError):
        return ModuleSummary(
            module=module_name_for(relpath), relpath=relpath,
            parse_error=True,
        ), None, None
    summary = summarize_module(tree, relpath)
    mesh = scrape_mesh_decl(tree) if relpath == MESH_RELPATH else None
    return summary, mesh, (source, tree)


def _cache_version() -> str:
    """The schema version plus this module's own (mtime, size): a change
    to the summarizer invalidates every cached summary, not only a
    schema bump."""
    try:
        st = os.stat(__file__)
        return f"{_CACHE_VERSION}:{st.st_mtime}:{st.st_size}"
    except OSError:
        return str(_CACHE_VERSION)


def _load_cache(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, dict) and \
                data.get("version") == _cache_version():
            return data
    except (OSError, ValueError):
        pass
    return {}


def _save_cache(path: str, data: dict) -> None:
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())  # durable before the rename publishes it
        os.replace(tmp, path)
    except OSError:
        pass  # caching is best-effort; never fail the lint over it
