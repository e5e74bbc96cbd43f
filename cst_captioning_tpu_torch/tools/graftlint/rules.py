"""The port's graftlint rules: the JAX package's rules retargeted to torch,
CUDA tensors, ``torch.distributed`` and the kernels' C interface.

Rule ids and names are the JAX lint's (a reader finds the JAX rule, its
fixtures and its README line by id). Three JAX rules have no counterpart
here and are not registered: GL004 and GL017 (buffer donation — torch has
none, and the port's optimizer updates parameters and moments in place)
and GL014 (a torch generator advances as it is consumed, so handing it to
a callee never repeats draws; generators seeded alike are GL002's).

Each rule's ``rationale`` is one line of "why this is a bug here"; the
README "Static analysis of the port" table follows these strings.
"""

from __future__ import annotations

import ast
import json
import os
import re

from cst_captioning_tpu_torch.tools.graftlint.core import (
    Edit,
    FileContext,
    Finding,
    Fix,
    ProjectRule,
    Rule,
    register,
)
from cst_captioning_tpu_torch.tools.graftlint.project import (
    _FUNC_NODES,
    MULTIHOST_SEED_RELPATHS,
    PACKAGE,
    HostTaint,
    ProjectIndex,
    Provenance,
    _dotted,
    _is_cpu_literal,
    _last,
    _unparse,
    bind_targets,
    def_qualnames,
    import_aliases,
    module_name_for,
    moves_to_device,
    resolve_dotted,
    unconditional_nodes,
)

_PKG = PACKAGE + "/"
_HOT_PACKAGES = (_PKG + "train/", _PKG + "rl/", _PKG + "decoding/")
_OPS = _PKG + "ops/"
_CHIP_SMOKE = "chip_smoke.py"
# the port's contract of parameter names, beside the lint
CONTRACT_RELPATH = _PKG + "tools/graftlint/shardings_contract.json"


def _in_package(ctx: FileContext) -> bool:
    return ctx.relpath.startswith(_PKG)


def _in_port(ctx: FileContext) -> bool:
    """The port's own code: the package and the chip smoke script."""
    return _in_package(ctx) or ctx.relpath == _CHIP_SMOKE


def _is_test_file(ctx: FileContext) -> bool:
    base = os.path.basename(ctx.relpath)
    return base.startswith("test_") or ctx.relpath.startswith("tests/")


def _not_tools(ctx: FileContext) -> bool:
    return _in_package(ctx) and not ctx.relpath.startswith(_PKG + "tools/")


def _aliases(ctx: FileContext) -> dict[str, str]:
    cached = ctx._cache.get("aliases")
    if cached is None:
        cached = import_aliases(ctx.tree, module_name_for(ctx.relpath),
                                nodes=ctx.nodes_of(ast.Import,
                                                   ast.ImportFrom))
        ctx._cache["aliases"] = cached
    return cached


def _resolved(ctx: FileContext, node: ast.AST) -> str:
    return resolve_dotted(_dotted(node), _aliases(ctx))


def _bound_names(node: ast.AST) -> list[str]:
    targets: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.For):
        targets = [node.target]
    elif isinstance(node, ast.withitem) and node.optional_vars is not None:
        targets = [node.optional_vars]
    elif isinstance(node, ast.NamedExpr):
        targets = [node.target]
    return [s.id for t in targets for s in ast.walk(t)
            if isinstance(s, ast.Name)]


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# ---- tensor-likeness (GL001/GL003/GL011) ------------------------------------

# tensor methods that return tensors (a reduction or an elementwise op): an
# expression calling one is a tensor expression
_TENSOR_METHODS = {
    "sum", "mean", "max", "min", "amax", "amin", "argmax", "argmin", "norm",
    "any", "all", "abs", "exp", "log", "float", "double", "half", "bfloat16",
    "long", "int", "bool", "to", "cuda", "clone", "detach", "view",
    "reshape", "eq", "ne", "lt", "gt", "le", "ge", "isfinite", "isnan",
    "logsumexp", "softmax", "log_softmax", "gather", "masked_fill",
    "count_nonzero", "prod", "cumsum", "squeeze", "unsqueeze", "flatten",
    "contiguous", "t", "matmul", "sub", "add", "mul", "div",
}


_SCALAR_TYPES = {"float", "int", "bool", "str"}


class _TensorNames:
    """Names bound, in one function, to torch tensor expressions: a
    ``torch.*`` call, a CUDA-provenance value, or a tensor method of a
    known tensor. Order-insensitive (a name once bound to a tensor stays
    one) — a heuristic the per-step rules share, never a type system."""

    def __init__(self, ctx: FileContext, fn: ast.AST | None,
                 prov: Provenance | None = None):
        self.ctx = ctx
        self.prov = prov
        self.names: set[str] = set()
        self.host: set[str] = set()     # names of host (CPU/numpy) data
        # parameters that may carry a tensor: no literal default (float()
        # or bool() of one is a candidate sync in per-step code, where
        # callers pass the step's scalars; int() of one is an index)
        self.tensor_params: set[str] = set()
        if fn is None:
            return
        args = fn.args
        pos = args.posonlyargs + args.args
        literal = {a.arg for a, d in zip(pos[len(pos) - len(args.defaults):],
                                         args.defaults)
                   if isinstance(d, ast.Constant) and d.value is not None}
        literal |= {a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
                    if isinstance(d, ast.Constant) and d.value is not None}
        # so may a parameter annotated as a Python scalar
        literal |= {a.arg for a in pos + args.kwonlyargs
                    if isinstance(a.annotation, ast.Name)
                    and a.annotation.id in _SCALAR_TYPES}
        self.tensor_params = {a.arg for a in pos + args.kwonlyargs
                              if a.arg not in literal
                              and a.arg not in ("self", "cls")}
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign))
                   and getattr(n, "value", None) is not None]
        for _ in range(3):  # names built from names: a short fixpoint
            before = len(self.names) + len(self.host)
            for n in assigns:
                # only names the statement rebinds: the names inside a
                # subscript or attribute target are read, not bound
                targets = bind_targets(n.targets if isinstance(
                    n, ast.Assign) else [n.target])
                if self.is_host(n.value):
                    self.host.update(targets)
                elif self.is_tensor(n.value):
                    self.names.update(targets)
            if len(self.names) + len(self.host) == before:
                break

    def is_host(self, expr: ast.AST | None) -> bool:
        """Whether ``expr`` is provably host data: numpy, a CPU tensor
        made from host data, a readback."""
        if isinstance(expr, ast.Name):
            return expr.id in self.host
        if isinstance(expr, ast.ListComp):
            return self.is_host(expr.elt)
        if isinstance(expr, (ast.Subscript, ast.Starred)):
            return self.is_host(expr.value)
        if isinstance(expr, ast.Call):
            resolved = _resolved(self.ctx, expr.func)
            if resolved.startswith("numpy."):
                return True
            if resolved == "torch.from_numpy":
                return True
            if resolved in ("torch.tensor", "torch.as_tensor"):
                dev = _kw(expr, "device")
                return dev is None or _is_cpu_literal(dev)
            if resolved.startswith("torch.") and expr.args and \
                    _kw(expr, "device") is None:
                # an op over host tensors (cat, stack, empty_like) stays
                # on the host
                first = expr.args[0]
                return self.is_host(first) or isinstance(
                    first, (ast.List, ast.Tuple)) and bool(first.elts) and \
                    all(self.is_host(e) for e in first.elts)
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in ("cpu", "numpy", "pin_memory"):
                    return True
                if expr.func.attr in ("float", "long", "int", "to",
                                      "contiguous", "view", "reshape"):
                    return self.is_host(expr.func.value) and not (
                        expr.func.attr == "to" and moves_to_device(expr))
        return False

    def is_tensor(self, expr: ast.AST | None) -> bool:
        if expr is None:
            return False
        if self.prov is not None and self.prov.of(expr)[0]:
            return True
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, (ast.Subscript, ast.Starred)):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Attribute):
            if expr.attr in ("shape", "dtype", "device", "ndim"):
                return False
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Call):
            resolved = _resolved(self.ctx, expr.func)
            if resolved.startswith("torch.") and not resolved.startswith(
                    ("torch.cuda.", "torch.distributed.", "torch.device",
                     "torch.Generator", "torch.no_grad", "torch.is_")):
                return True
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in ("item", "tolist", "numpy", "size",
                                      "dim", "numel", "data_ptr"):
                    return False
                if expr.func.attr in _TENSOR_METHODS:
                    return self.is_tensor(expr.func.value)
            return False
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            return self.is_tensor(expr.left) or any(
                self.is_tensor(c) for c in expr.comparators)
        return False


def _enclosing_defs(ctx: FileContext) -> dict[int, ast.AST]:
    """id(node) -> its nearest enclosing def node (absent at module
    scope). Cached per file."""
    cached = ctx._cache.get("enclosing_defs")
    if cached is not None:
        return cached
    out: dict[int, ast.AST] = {}

    def walk(node: ast.AST, owner) -> None:
        for child in ast.iter_child_nodes(node):
            if owner is not None:
                out[id(child)] = owner
            walk(child, child if isinstance(child, _FUNC_NODES) else owner)

    walk(ctx.tree, None)
    ctx._cache["enclosing_defs"] = out
    return out


def _tensor_names(ctx: FileContext, fn, index: ProjectIndex | None):
    cache = ctx._cache.setdefault("tensor_names", {})
    key = id(fn) if fn is not None else 0
    if key not in cache:
        prov = None
        if index is not None and fn is not None:
            prov = _function_provenance(ctx, fn, index)
        cache[key] = _TensorNames(ctx, fn, prov)
    return cache[key]


def _function_provenance(ctx: FileContext, fn: ast.AST,
                         index: ProjectIndex) -> Provenance:
    """The CUDA provenance of ``fn``'s names at the END of its body (a
    flow-insensitive view for the per-step rules' tensor test)."""
    module = index.module_of(ctx.relpath)
    prov = Provenance(index.aliases_for(ctx.relpath, ctx.tree),
                      lookup=index.summary_lookup(module))
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            names = bind_targets(node.targets)
            why, _ = prov.of(node.value)
            if why:
                for n in names:
                    prov.device_vars[n] = why
        elif isinstance(node, ast.For):
            prov.bind_loop_target(node)
    return prov


# ---- GL001: host sync in a per-step loop -------------------------------------

_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SCALAR_CASTS = {"float", "int", "bool"}


def _imports_torch(ctx: FileContext) -> bool:
    return any(
        isinstance(n, ast.Import) and any(
            a.name == "torch" or a.name.startswith("torch.")
            for a in n.names)
        or isinstance(n, ast.ImportFrom) and (n.module or "").split(
            ".")[0] == "torch"
        for n in ctx.nodes_of(ast.Import, ast.ImportFrom))


def _sync_prim(ctx: FileContext, node: ast.AST, tensors) -> str | None:
    """The host-sync primitive a call node invokes, else None: an explicit
    readback (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``), a
    ``synchronize()`` of the device, a stream or an event, or
    ``float()``/``int()``/``bool()`` of a tensor."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_ATTRS and not node.args:
        recv = node.func.value
        if tensors.is_host(recv):
            return None  # a CPU tensor or numpy array: nothing to wait for
        if node.func.attr in ("tolist", "numpy") and \
                not tensors.is_tensor(recv):
            return None  # numpy arrays and lists read back nothing
        return f".{node.func.attr}()"
    d = _dotted(node.func)
    if d in _SCALAR_CASTS and len(node.args) == 1 and \
            not tensors.is_host(node.args[0]):
        arg = node.args[0]
        if tensors.is_tensor(arg):
            return f"{d}()"
        if d != "int" and isinstance(arg, ast.Name) and \
                arg.id in tensors.tensor_params:
            return f"{d}() of the parameter {arg.id!r}"
    return _h2d_copy(ctx, node, tensors)


def _h2d_copy(ctx: FileContext, node: ast.Call, tensors) -> str | None:
    """A blocking host→device copy: ``torch.tensor``/``as_tensor`` of host
    data onto a device, or ``.to(device)``/``.cuda()`` of provably host
    data without ``non_blocking=True`` (a pageable copy the host waits
    for)."""
    resolved = _resolved(ctx, node.func)
    if resolved in ("torch.tensor", "torch.as_tensor"):
        dev = _kw(node, "device")
        if dev is not None and not _is_cpu_literal(dev) and not (
                node.args and tensors.is_tensor(node.args[0])
                and not tensors.is_host(node.args[0])):
            return f"{resolved}(..., device=...) (a host→device copy)"
        return None
    if isinstance(node.func, ast.Attribute) and node.func.attr in (
            "to", "cuda") and moves_to_device(node):
        nb = _kw(node, "non_blocking")
        if isinstance(nb, ast.Constant) and nb.value is True:
            return None
        recv = node.func.value
        if tensors.is_host(recv):
            return f".{node.func.attr}(device) of host data (a blocking " \
                "host→device copy)"
        if isinstance(recv, ast.Name) and recv.id in tensors.tensor_params \
                and recv.id not in tensors.names:
            return f".{node.func.attr}(device) of the parameter " \
                f"{recv.id!r} (a blocking host→device copy when a caller " \
                "passes host data)"
    return None


def _capture_regions(ctx: FileContext) -> list[ast.With]:
    if "graph" not in ctx.source:
        return []
    out = []
    for node in ctx.nodes_of(ast.With):
        for item in node.items:
            call = item.context_expr
            if isinstance(call, ast.Call) and _resolved(
                    ctx, call.func) in ("torch.cuda.graph",
                                        "torch.cuda.graphs.graph"):
                out.append(node)
    return out


def per_step_sites(ctx: FileContext, index: ProjectIndex) -> dict:
    """(line, col) -> (primitive, why-per-step) of every host sync that
    runs each step in a hot-package file: unconditionally in a loop body,
    or unconditionally in a function that such a loop calls (through the
    index's per-step closure). Cached per file; GL001 reports these and
    GL013 leaves them to it."""
    cached = ctx._cache.get("per_step_sites")
    if cached is not None:
        return cached
    out: dict = {}
    ctx._cache["per_step_sites"] = out
    hot = ctx.relpath.startswith(_HOT_PACKAGES)
    if not (hot or ctx.relpath.startswith(_OPS)) or not _imports_torch(ctx):
        return out
    enclosing = _enclosing_defs(ctx)

    def scan(body, why, fn):
        tensors = _tensor_names(ctx, fn, index)
        for node in unconditional_nodes(body):
            prim = _sync_prim(ctx, node, tensors)
            if prim:
                out.setdefault((node.lineno, node.col_offset),
                               (prim, why, node))

    # an ops/ wrapper's loops run per step only where hot code calls it
    for loop in ctx.nodes_of(ast.For, ast.While) if hot else ():
        scan(loop.body, "runs every iteration of this loop",
             enclosing.get(id(loop)))
    module = index.module_of(ctx.relpath)
    quals = def_qualnames(ctx.tree)
    for fn in ctx.nodes_of(*_FUNC_NODES):
        full = f"{module}.{quals.get(id(fn), fn.name)}"
        caller = index.per_step.get(full)
        if caller:
            scan(fn.body, f"runs every step (reached from {caller})", fn)
    return out


@register
class HostSyncRule(ProjectRule):
    id = "GL001"
    name = "host-sync-in-hot-path"
    severity = "error"
    rationale = (
        "a .item()/.tolist()/.cpu()/.numpy()/float() of a tensor or a "
        "synchronize() that runs every step of a train/rl/decoding loop "
        "(or inside a torch.cuda.graph capture) stalls the host until the "
        "card drains — the device idles while the host waits"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _in_package(ctx)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        out: list[Finding] = []
        captured: set[int] = set()
        for region in _capture_regions(ctx):
            tensors = _tensor_names(ctx, _enclosing_defs(ctx).get(
                id(region)), index)
            for stmt in region.body:
                for node in ast.walk(stmt):
                    prim = _sync_prim(ctx, node, tensors)
                    if prim and id(node) not in captured:
                        captured.add(id(node))
                        out.append(ctx.finding(
                            self, node,
                            f"host sync {prim} inside a torch.cuda.graph "
                            "capture region: the capture fails, or records "
                            "a graph whose replay never re-reads the host "
                            "value"))
        for (line, col), (prim, why, node) in sorted(
                per_step_sites(ctx, index).items()):
            if id(node) in captured:
                continue
            out.append(ctx.finding(
                self, node,
                f"per-step host sync: {prim} {why}, blocking the host "
                "until the card drains before it can queue the next step; "
                "keep the value on the device (accumulate, read back once "
                "an epoch) or gate it behind a log-every-N branch",
                severity="warning"))
        return out


# ---- GL002: unseeded sampling and shared seeds -------------------------------

_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "normal", "poisson",
}
_SAMPLER_METHODS = {
    "uniform_", "normal_", "exponential_", "bernoulli_", "random_",
    "geometric_", "cauchy_", "log_normal_",
}
_DROPOUTS = {"torch.nn.functional.dropout", "torch.dropout",
             "torch.nn.functional.dropout1d", "torch.nn.functional.dropout2d",
             "torch.nn.functional.alpha_dropout"}


@register
class UnseededSamplingRule(Rule):
    id = "GL002"
    name = "prng-key-reuse"
    severity = "error"
    rationale = (
        "the port draws every sample from an explicit torch.Generator: a "
        "sampling call with no generator= (or torch.manual_seed) reads the "
        "process-global stream, so a rollout's draws depend on what ran "
        "before it; two generators seeded from one expression give the "
        "correlated SCST rollouts the JAX rule guards against"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _in_package(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Call):
            resolved = _resolved(ctx, node.func)
            if resolved == "torch.manual_seed" or \
                    resolved == "torch.cuda.manual_seed_all" or \
                    resolved == "torch.cuda.manual_seed":
                out.append(ctx.finding(
                    self, node,
                    f"{resolved}() in package code reseeds the "
                    "process-global stream every caller shares: seed a "
                    "torch.Generator and pass it as generator="))
                continue
            if _kw(node, "generator") is not None:
                continue
            sampler = ""
            if resolved.startswith("torch.") and _last(resolved) in \
                    _SAMPLERS and resolved.count(".") == 1:
                sampler = resolved
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SAMPLER_METHODS:
                sampler = f".{node.func.attr}"
            elif resolved in _DROPOUTS:
                training = _kw(node, "training")
                if training is None and len(node.args) >= 3:
                    training = node.args[2]
                if isinstance(training, ast.Constant) and \
                        training.value is False:
                    continue
                sampler = resolved
            if sampler:
                out.append(ctx.finding(
                    self, node,
                    f"{sampler}(...) with no generator= draws from the "
                    "process-global stream: pass the caller's "
                    "torch.Generator so the draws are reproducible and "
                    "independent"))
        if "manual_seed" in ctx.source:
            for fn in ctx.nodes_of(*_FUNC_NODES):
                out.extend(self._shared_seeds(ctx, fn))
        return out

    def _shared_seeds(self, ctx: FileContext, fn: ast.AST) -> list[Finding]:
        """Two ``manual_seed(expr)`` calls on generators with one ``expr``
        (no rebinding of its names between them) in one function."""
        seen: dict[str, ast.AST] = {}
        events = []
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                continue
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr == "manual_seed" and node.args and \
                    _resolved(ctx, node.func) != "torch.manual_seed":
                events.append((node.lineno, node.col_offset, "seed",
                               _unparse(node.args[0]), node))
            for name in _bound_names(node):
                events.append((getattr(node, "lineno", 0),
                               getattr(node, "col_offset", 0), "bind",
                               name, node))
            stack.extend(ast.iter_child_nodes(node))
        out = []
        for _, _, kind, payload, node in sorted(events,
                                                key=lambda e: e[:2]):
            if kind == "bind":
                for expr in [e for e in seen
                             if re.search(rf"\b{re.escape(payload)}\b", e)]:
                    del seen[expr]
            elif payload in seen:
                out.append(ctx.finding(
                    self, node,
                    f"a second generator seeded from {payload!r} (first "
                    f"on line {seen[payload].lineno}): the two streams "
                    "are identical, so their draws are perfectly "
                    "correlated — derive distinct seeds"))
            else:
                seen[payload] = node
        return out


# ---- GL003: implicit __bool__ sync on a tensor in a hot loop ----------------

@register
class TensorBranchRule(ProjectRule):
    id = "GL003"
    name = "python-branch-on-traced-value"
    severity = "error"
    rationale = (
        "`if`/`while`/`assert` on a tensor (a comparison of tensors, "
        ".any(), .all()) in a per-step loop calls Tensor.__bool__: an "
        "implicit blocking readback the code never spells"
    )

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(_HOT_PACKAGES)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        enclosing = _enclosing_defs(ctx)
        out: dict[tuple[int, int], Finding] = {}
        bodies = [(loop.body, enclosing.get(id(loop)))
                  for loop in ctx.nodes_of(ast.For, ast.While)]
        for loop in ctx.nodes_of(ast.While):
            bodies.append(([loop], enclosing.get(id(loop))))
        module = index.module_of(ctx.relpath)
        quals = def_qualnames(ctx.tree)
        for fn in ctx.nodes_of(*_FUNC_NODES):
            if index.per_step.get(
                    f"{module}.{quals.get(id(fn), fn.name)}"):
                bodies.append((fn.body, fn))
        for body, fn in bodies:
            tensors = _tensor_names(ctx, fn, index)
            for node in self._tests(body):
                test = node.test
                if self._is_tensor_test(ctx, test, tensors):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.Assert: "assert", ast.IfExp: "if"}[
                        type(node)]
                    out.setdefault((node.lineno, node.col_offset),
                                   ctx.finding(
                        self, node,
                        f"Python `{kind}` on a tensor in a per-step loop: "
                        "Tensor.__bool__ reads the value back and blocks "
                        "the host every pass — keep the decision on the "
                        "device (torch.where, a mask) or decide it once "
                        "from host state"))
        return list(out.values())

    @staticmethod
    def _tests(body):
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _is_tensor_test(ctx, test, tensors) -> bool:
        for node in ast.walk(test):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("any", "all", "is_nonzero") and \
                        tensors.is_tensor(node.func.value):
                    return True
                if _resolved(ctx, node.func) in (
                        "torch.equal", "torch.allclose", "torch.any",
                        "torch.all"):
                    return True
            if isinstance(node, ast.Compare) and not all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) \
                    and tensors.is_tensor(node):
                return True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        return isinstance(test, ast.Name) and tensors.is_tensor(test)


# ---- GL005: float32 literals in models/ and decoding/ -----------------------

_F32_DOTTED = {"torch.float32", "torch.float"}


@register
class F32LiteralRule(Rule):
    id = "GL005"
    name = "f32-literal-in-bf16-module"
    severity = "warning"
    rationale = (
        "an explicit torch.float32 / .float() in the model and decode code "
        "upcasts what it touches off the bfloat16 tensor-core path; route "
        "dtypes through the config's dtype, or baseline the f32 numerics "
        "the kernels and their plain versions keep by design"
    )

    _SCOPE = (_PKG + "models/", _PKG + "decoding/")

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(self._SCOPE)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        params: dict[int, frozenset] | None = None
        for node in ctx.nodes_of(ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "float" and not node.args and \
                    not node.keywords:
                out.append(ctx.finding(
                    self, node,
                    f"{_unparse(node)[:40]} casts to float32 in a module "
                    "that runs under the model's compute dtype: cast to "
                    "the configured dtype, or baseline the f32 numerics "
                    "with their reason"))
                continue
            literals = [a for a in node.args if _dotted(a) in _F32_DOTTED]
            dtype = _kw(node, "dtype")
            if dtype is not None and _dotted(dtype) in _F32_DOTTED:
                literals.append(dtype)
            for lit in literals:
                if params is None:
                    params = _enclosing_param_sets(ctx)
                fix = None
                if "dtype" in params.get(id(node), frozenset()):
                    fix = Fix(
                        edits=(Edit.from_node(lit, "dtype"),),
                        description=(
                            "route the literal through the enclosing "
                            "function's `dtype` parameter"))
                out.append(ctx.finding(
                    self, node,
                    f"float32 literal {_dotted(lit)} in "
                    f"{_unparse(node.func)[:30]}(...): pass the model's "
                    "compute dtype, or baseline the f32 numerics with "
                    "their reason",
                    fix=fix))
        return out


def _enclosing_param_sets(ctx: FileContext) -> dict[int, frozenset]:
    """id(node) -> parameter names of the enclosing functions (closures see
    their outer functions' params). Cached."""
    cached = ctx._cache.get("enclosing_params")
    if cached is not None:
        return cached
    out: dict[int, frozenset] = {}

    def walk(node: ast.AST, params: frozenset) -> None:
        for child in ast.iter_child_nodes(node):
            child_params = params
            if isinstance(child, _FUNC_NODES):
                args = child.args
                own = {a.arg for a in args.posonlyargs + args.args
                       + args.kwonlyargs}
                child_params = params | own
            out[id(child)] = child_params
            walk(child, child_params)

    walk(ctx.tree, frozenset())
    ctx._cache["enclosing_params"] = out
    return out


# ---- GL006: JAX imports and CUDA initialised at import ----------------------

_FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "optax", "cst_captioning_tpu"}
_CUDA_INIT = {"torch.cuda.init", "torch.cuda.is_available",
              "torch.cuda.device_count", "torch.cuda.current_device",
              "torch.cuda.set_device", "torch.cuda.get_device_name",
              "torch.cuda.get_device_properties"}
_BUILD_CALLS = {f"{PACKAGE}.ops.build.build", f"{PACKAGE}.ops.build.load"}


def _is_main_guard(stmt: ast.AST) -> bool:
    return (
        isinstance(stmt, ast.If)
        and isinstance(stmt.test, ast.Compare)
        and isinstance(stmt.test.left, ast.Name)
        and stmt.test.left.id == "__name__"
    )


@register
class HeavyImportRule(Rule):
    id = "GL006"
    name = "heavy-import-or-import-side-effect"
    severity = "error"
    rationale = (
        "the port imports torch and numpy only — a jax/flax/optax or "
        "cst_captioning_tpu import brings the reference package onto the "
        "card's machine; and CUDA initialised at import (torch.cuda.init/"
        "is_available/device_count, a tensor on 'cuda', a kernel build) "
        "makes every importer, test and CPU child pay for a device"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _in_port(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Import, ast.ImportFrom):
            mods: list[str] = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif node.module and not node.level:
                mods = [node.module]
            for mod in mods:
                if mod.split(".", 1)[0] in _FORBIDDEN_IMPORTS:
                    out.append(ctx.finding(
                        self, node,
                        f"import of {mod!r} in the port: the port imports "
                        "torch and numpy, never JAX or the JAX package — "
                        "keep a copy of what it needs"))
        for stmt in ctx.tree.body:
            if isinstance(stmt, _FUNC_NODES + (ast.ClassDef,)) or \
                    _is_main_guard(stmt):
                continue
            for node in ast.walk(stmt):
                if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                    continue
                if isinstance(node, ast.Call):
                    what = self._cuda_at_import(ctx, node)
                    if what:
                        out.append(ctx.finding(
                            self, node,
                            f"{what} at module level initialises CUDA (or "
                            "builds a kernel) when the module is imported: "
                            "move it into the function that needs the "
                            "device"))
        return out

    @staticmethod
    def _cuda_at_import(ctx: FileContext, call: ast.Call) -> str:
        resolved = _resolved(ctx, call.func)
        if resolved in _CUDA_INIT:
            return f"{resolved}()"
        if resolved in _BUILD_CALLS:
            return f"{resolved}()"
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "cuda" and not call.args:
            return ".cuda()"
        for arg in list(call.args) + [kw.value for kw in call.keywords
                                      if kw.arg == "device"]:
            if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str) and arg.value.startswith("cuda") and (
                    resolved.startswith("torch.") or isinstance(
                        call.func, ast.Attribute) and call.func.attr == "to"):
                return f"{_unparse(call.func)}(..., {arg.value!r})"
        return ""


# ---- GL007: partition-rule coverage vs the port's contract ------------------

def _load_contract(root: str) -> list[str] | None:
    try:
        with open(os.path.join(root, CONTRACT_RELPATH),
                  encoding="utf-8") as f:
            return list(json.load(f)["params"])
    except (OSError, ValueError, KeyError):
        return None


def _table_rows(node: ast.AST) -> tuple[list, bool]:
    """((family, pattern, spec node, row node), ...) of a rule table and
    whether every row is literal."""
    elts = getattr(node, "elts", [])
    rows = []
    for elt in elts:
        parts = getattr(elt, "elts", [])
        if len(parts) >= 2 and isinstance(parts[0], ast.Constant) and \
                isinstance(parts[1], ast.Constant):
            rows.append((str(parts[0].value), str(parts[1].value),
                         parts[2] if len(parts) > 2 else None, elt))
    return rows, bool(rows) and len(rows) == len(elts)


def _rule_tables(ctx: FileContext) -> list[tuple[str, ast.AST]]:
    out = []
    for node in ctx.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                node.value is not None:
            for name in _bound_names(node):
                if name.endswith("PARTITION_RULES"):
                    out.append((name, node))
    return out


@register
class PartitionCoverageRule(Rule):
    id = "GL007"
    name = "partition-rule-coverage"
    severity = "error"
    rationale = (
        "a PARAM_PARTITION_RULES regex that matches no parameter (or a "
        "parameter no rule covers) means a model refactor silently changed "
        "the layout; the port's contract (shardings_contract.json beside "
        "the lint, regenerated from train.mesh.param_path_names) pins the "
        "names the rules were written against"
    )

    def applies(self, ctx: FileContext) -> bool:
        return "PARAM_PARTITION_RULES" in ctx.source and _in_package(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        tables = dict(_rule_tables(ctx))
        node = tables.get("PARAM_PARTITION_RULES")
        if node is None:
            return []
        params = _load_contract(ctx.root)
        if params is None:
            return [ctx.finding(
                self, node,
                f"the port's contract {CONTRACT_RELPATH} is missing or "
                "unreadable: run `python -m cst_captioning_tpu_torch.tools"
                ".graftlint.contract --write` to dump the parameter names",
                severity="info")]
        out: list[Finding] = []
        rows, _ = _table_rows(node.value)
        unruled = set(params)
        for family, pattern, _spec, elt in rows:
            try:
                rx = re.compile(pattern)
            except re.error as e:
                out.append(ctx.finding(
                    self, elt,
                    f"partition rule {family!r} has an invalid regex: {e}"))
                continue
            matched = [p for p in params if rx.fullmatch(p)]
            if not matched:
                out.append(ctx.finding(
                    self, elt,
                    f"partition rule {family!r} ({pattern!r}) matches no "
                    "parameter of the port's contract — the family it was "
                    "written for was renamed or removed"))
            unruled.difference_update(matched)
        for p in sorted(unruled):
            out.append(ctx.finding(
                self, node,
                f"parameter {p!r} (from the port's contract) matches no "
                "partition rule: add a rule for its family so its layout "
                "is an explicit decision"))
        return out


# ---- GL008: CUDA tests carry the gpu marker ----------------------------------

@register
class GpuTestMarkerRule(Rule):
    id = "GL008"
    name = "tpu-test-without-slow-marker"
    severity = "warning"
    rationale = (
        "tier-1 runs on a CPU host with no card: a tests/test_torch_*.py "
        "test that needs CUDA (device='cuda', .cuda(), ops.build, a kernel "
        "launch) must carry the gpu marker, at function or module level, "
        "so it skips with its reason instead of failing"
    )

    def applies(self, ctx: FileContext) -> bool:
        base = os.path.basename(ctx.relpath)
        return base.startswith("test_torch_") and base.endswith(".py")

    def check(self, ctx: FileContext) -> list[Finding]:
        if self._module_marked(ctx.tree):
            return []
        out: list[Finding] = []
        for fn in ctx.nodes_of(*_FUNC_NODES):
            if not fn.name.startswith("test_") or self._marked(fn):
                continue
            why = self._needs_cuda(ctx, fn)
            if why:
                out.append(ctx.finding(
                    self, fn,
                    f"test {fn.name} needs CUDA ({why}) but carries no "
                    "gpu marker: mark it @pytest.mark.gpu (or the module "
                    "with pytestmark) so a host without a card skips it"))
        return out

    @staticmethod
    def _needs_cuda(ctx: FileContext, fn: ast.AST) -> str:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = _resolved(ctx, node.func)
            if resolved in _BUILD_CALLS or resolved.endswith(
                    ("ops.build.build", "ops.build.load")):
                return f"{_last(resolved)}() of ops.build"
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("cuda", "_lib") and not node.args:
                return f".{node.func.attr}()"
            # a tensor made or moved there (torch.device("cuda") alone
            # is only a value and needs no card)
            for arg in list(node.args[:1]) + [
                    kw.value for kw in node.keywords if kw.arg == "device"]:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and arg.value.startswith("cuda") \
                        and _last(resolved) != "device" and (
                            _kw(node, "device") is arg
                            or _last(resolved) == "to"):
                    return f"device {arg.value!r}"
        return ""

    @staticmethod
    def _is_gpu_mark(node: ast.AST) -> bool:
        return any(_dotted(sub).endswith("mark.gpu")
                   for sub in ast.walk(node))

    def _marked(self, fn: ast.AST) -> bool:
        return any(self._is_gpu_mark(d) for d in fn.decorator_list)

    def _module_marked(self, tree: ast.Module) -> bool:
        for node in tree.body:
            if isinstance(node, ast.Assign) and "pytestmark" in \
                    _bound_names(node) and self._is_gpu_mark(node.value):
                return True
        return False


# ---- GL009: silently swallowed broad exceptions -----------------------------

@register
class SwallowedExceptionRule(Rule):
    id = "GL009"
    name = "silent-exception-swallow"
    severity = "warning"
    rationale = (
        "a bare `except Exception: pass/continue` in package code hides "
        "corrupt checkpoints and I/O failures without a trace — log a "
        "structured event (or narrow the exception type) before falling back"
    )

    def applies(self, ctx: FileContext) -> bool:
        # package code only: tests swallow on purpose when asserting
        # failure modes
        return _in_package(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Try):
            for handler in node.handlers:
                if not self._broad(handler.type):
                    continue
                if not all(self._silent(stmt) for stmt in handler.body):
                    continue  # the handler logs/recovers — that's the fix
                caught = (
                    "bare except" if handler.type is None
                    else _last(_dotted(handler.type)) or "Exception"
                )
                out.append(ctx.finding(
                    self, handler,
                    f"{caught} swallowed silently (body is only "
                    "pass/continue): a corrupt checkpoint or failed I/O "
                    "vanishes without a structured event — log which "
                    "operation failed and why before falling back",
                ))
        return out

    @classmethod
    def _broad(cls, type_node) -> bool:
        """True for ``except:``, ``except (Base)Exception``, or a tuple
        containing one — narrow types are a deliberate contract."""
        if type_node is None:
            return True
        if isinstance(type_node, ast.Tuple):
            return any(cls._broad(elt) for elt in type_node.elts)
        return _last(_dotted(type_node)) in ("Exception", "BaseException")

    @staticmethod
    def _silent(stmt: ast.stmt) -> bool:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            return True
        # a lone string/ellipsis expression is documentation, not handling
        return isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, ast.Constant
        )


# ---- GL010: ad-hoc timing / bare print in package hot paths -----------------

# CLIs print their reports and the linter prints its findings — both are
# user-facing stdout by design, not hot-path instrumentation
_GL010_EXCLUDED = (_PKG + "cli/", _PKG + "tools/")


@register
class AdHocTimingRule(Rule):
    id = "GL010"
    name = "adhoc-timing-or-print-in-hot-path"
    severity = "warning"
    rationale = (
        "hand-rolled time.time() deltas and bare print() in package code "
        "are invisible to run reports and traces: time windows belong in "
        "obs.span / obs.metrics, messages in EventLogger.log / obs.event"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _in_package(ctx) and not ctx.relpath.startswith(
            _GL010_EXCLUDED)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Call):
            d = _dotted(node.func)
            if d == "time.time":
                out.append(ctx.finding(
                    self, node,
                    "raw time.time() in package code: wrap the window in "
                    "obs.span(...) (or feed an obs.metrics histogram via "
                    "time.perf_counter) so the duration reaches the run "
                    "report and Perfetto trace; wall-clock event timestamps "
                    "belong to EventLogger/obs",
                ))
            elif d == "print":
                out.append(ctx.finding(
                    self, node,
                    "bare print() in package code: route it through "
                    "EventLogger.log / obs.event so the message lands in "
                    "the structured event stream instead of a scrollback "
                    "buffer",
                ))
        return out


# ---- GL011: loop-carry dtype drift -------------------------------------------

_DTYPE_METHODS = {"float": "float32", "double": "float64", "half": "float16",
                  "bfloat16": "bfloat16", "long": "int64", "int": "int32",
                  "bool": "bool"}
_DTYPE_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
                  "long": "int64", "int": "int32"}
_DTYPE_CTORS = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like",
                "full_like", "empty_like", "arange", "tensor", "as_tensor",
                "new_zeros", "new_ones", "new_full", "new_empty"}


def _dtype_literal(node: ast.AST | None) -> tuple[str, ast.AST | None]:
    """(dtype name, the node spelling it) of an explicit torch dtype."""
    d = _dotted(node) if node is not None else ""
    if d.startswith("torch.") and _last(d) in (
            set(_DTYPE_METHODS.values()) | set(_DTYPE_ALIASES)):
        return _DTYPE_ALIASES.get(_last(d), _last(d)), node
    return "", None


def _explicit_dtype(expr: ast.AST) -> tuple[str, ast.AST | None]:
    """The explicit dtype an expression produces, and the literal node to
    rewrite (None for the method spelling ``.float()``)."""
    if not isinstance(expr, ast.Call):
        return "", None
    if isinstance(expr.func, ast.Attribute):
        attr = expr.func.attr
        if attr in _DTYPE_METHODS and not expr.args:
            return _DTYPE_METHODS[attr], None
        if attr == "to":
            for a in list(expr.args) + [kw.value for kw in expr.keywords
                                        if kw.arg == "dtype"]:
                name, node = _dtype_literal(a)
                if name:
                    return name, node
            return "", None
    if _last(_dotted(expr.func)) in _DTYPE_CTORS:
        return _dtype_literal(_kw(expr, "dtype"))
    return "", None


@register
class LoopCarryDtypeRule(Rule):
    id = "GL011"
    name = "scan-carry-dtype-drift"
    severity = "error"
    rationale = (
        "a decode-loop carry initialised with one explicit dtype and "
        "rebound inside the loop from an expression of another silently "
        "widens or narrows the carry after the first pass (a float32 init "
        "rounded to bfloat16 each step); keep the carry dtype "
        "loop-invariant"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _in_package(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for fn in ctx.nodes_of(*_FUNC_NODES):
            out.extend(self._check_body(ctx, fn.body))
        return out

    def _check_body(self, ctx, body) -> list[Finding]:
        out: list[Finding] = []
        inits: dict[str, tuple[str, ast.AST | None]] = {}
        for stmt in body:
            if isinstance(stmt, (ast.For, ast.While)):
                for node in ast.walk(stmt):
                    if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                        continue
                    if not isinstance(node, ast.Assign) or \
                            len(node.targets) != 1 or not isinstance(
                                node.targets[0], ast.Name):
                        continue
                    name = node.targets[0].id
                    if name not in inits:
                        continue
                    d_init, lit = inits[name]
                    d_new, _ = _explicit_dtype(node.value)
                    if d_new and d_new != d_init:
                        fix = None
                        if lit is not None and d_new.isidentifier():
                            fix = Fix(
                                edits=(Edit.from_node(
                                    lit, f"torch.{d_new}"),),
                                description=(
                                    f"rewrite the carry init's dtype "
                                    f"literal to torch.{d_new} (the dtype "
                                    "the loop rebinds it with)"))
                        out.append(ctx.finding(
                            self, node,
                            f"loop carry {name!r} is rebound as {d_new!r} "
                            f"but initialised as {d_init!r} before the "
                            "loop: the carry's dtype changes after the "
                            "first pass — initialise it in the dtype the "
                            "loop keeps",
                            fix=fix))
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name):
                d, lit = _explicit_dtype(stmt.value)
                if d:
                    inits[stmt.targets[0].id] = (d, lit)
                else:
                    inits.pop(stmt.targets[0].id, None)
        return out


# ---- GL012: axis-name typos in the mesh API ----------------------------------

_GL012_AXES = frozenset({"data", "seq", "mp"})
# the mesh API's axis-taking keywords and, for _grid, positional slots
_AXIS_KWARGS = {"axis", "seq_axis", "mp_axis", "row_axis", "data_axis"}
_AXIS_CALLS = {"make_mesh", "DataMesh", "_grid", "_named", "sp_model",
               "sp_batch_specs", "sp_batch_shardings", "mp_cell_specs",
               "make_sp_decode"}
_GRID_AXIS_POS = {"_grid": (3, 4), "_named": (0,)}


@register
class MeshAxisRule(ProjectRule):
    id = "GL012"
    name = "collective-axis-name-typo"
    severity = "error"
    rationale = (
        "an axis literal given to the mesh API (make_mesh/DataMesh/_grid "
        "axis=, a grid's _named) or compared with a mesh's .axis that is "
        "not a declared axis ('data', 'seq', 'mp') builds or selects the "
        "wrong grid silently — a grid whose kind no branch recognises"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _not_tools(ctx)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        allowed = index.mesh.axes | _GL012_AXES
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Call):
            name = _last(_dotted(node.func))
            if name not in _AXIS_CALLS:
                continue
            lits = [kw.value for kw in node.keywords
                    if kw.arg in _AXIS_KWARGS]
            for pos in _GRID_AXIS_POS.get(name, ()):
                if pos < len(node.args):
                    lits.append(node.args[pos])
            for lit in lits:
                if isinstance(lit, ast.Constant) and isinstance(
                        lit.value, str) and lit.value and \
                        lit.value not in allowed:
                    out.append(self._finding(ctx, lit, lit.value,
                                             f"{name}(...)", allowed))
        for node in ctx.nodes_of(ast.Compare):
            sides = [node.left] + list(node.comparators)
            axis_side = any(
                isinstance(s, ast.Attribute) and s.attr in (
                    "axis", "axis_names") for s in sides)
            if not axis_side:
                continue
            for s in sides:
                for lit in ast.walk(s):
                    if isinstance(lit, ast.Constant) and isinstance(
                            lit.value, str) and lit.value and \
                            lit.value not in allowed:
                        out.append(self._finding(
                            ctx, lit, lit.value,
                            "a comparison with a mesh's axis", allowed))
        return out

    def _finding(self, ctx, node, axis, where, allowed) -> Finding:
        return ctx.finding(
            self, node,
            f"axis {axis!r} in {where} is not an axis train/mesh.py "
            f"declares ({', '.join(sorted(allowed))}): a typo here builds "
            "or selects the wrong grid without an error")


# ---- GL013: implicit host transfers on CUDA-provenance values ---------------

_GL013_NP_SINKS = {
    "asarray", "array", "ascontiguousarray", "copy", "mean", "sum", "max",
    "min", "abs", "concatenate", "stack", "vstack", "hstack", "where",
    "argmax", "argmin", "argsort", "sort", "unique", "square", "sqrt",
    "clip", "dot", "einsum", "std", "var", "median", "prod", "all", "any",
    "allclose", "array_equal", "count_nonzero", "save", "savez", "isfinite",
    "exp", "log",
}
# ops whose output shape depends on the data: the host reads the count back
_DATA_SHAPE_FUNCS = {"nonzero", "masked_select", "unique",
                     "unique_consecutive", "argwhere"}
_DATA_SHAPE_METHODS = {"nonzero", "masked_select", "unique",
                       "unique_consecutive", "argwhere"}
_BOOL_MAKERS = {"bool", "isfinite", "isnan", "isinf", "logical_not",
                "logical_and", "logical_or", "eq", "ne", "lt", "gt", "le",
                "ge"}


class _DeviceFlow:
    """In-order local dataflow over one function body (pass 2 of GL013):
    which names hold CUDA tensors, and the interprocedural path that made
    them so (the project index resolves callee returns and CUDA-yielding
    generators). Boolean CUDA masks are tracked for the mask-index sink."""

    def __init__(self, rule: "ImplicitTransferRule", ctx: FileContext,
                 index: ProjectIndex, skip: set):
        self.rule = rule
        self.ctx = ctx
        self.aliases = index.aliases_for(ctx.relpath, ctx.tree)
        self.prov = Provenance(
            self.aliases,
            lookup=index.summary_lookup(index.module_of(ctx.relpath)))
        self.masks: set[str] = set()
        self.skip = skip          # (line, col) GL001 already reports
        self.findings: list[Finding] = []
        self._reported: set[tuple[int, int]] = set()

    def run(self, body: list[ast.stmt]) -> list[Finding]:
        for stmt in body:
            self._stmt(stmt)
        return self.findings

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            self._sinks(node.value)
            self._bind(node.targets, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if node.value is not None:
                self._sinks(node.value)
                self._bind([node.target], node.value)
        elif isinstance(node, ast.For):
            self._sinks(node.iter)
            self.prov.bind_loop_target(node)
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
        elif isinstance(node, ast.If):
            # exclusive branches: only names CUDA in BOTH arms stay CUDA
            self._sinks(node.test)
            before = dict(self.prov.device_vars)
            for stmt in node.body:
                self._stmt(stmt)
            after_body = self.prov.device_vars
            self.prov.device_vars = dict(before)
            for stmt in node.orelse:
                self._stmt(stmt)
            after_else = self.prov.device_vars
            self.prov.device_vars = {k: v for k, v in after_body.items()
                                     if k in after_else}
        elif isinstance(node, ast.expr):
            self._sinks(node)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._sinks(child)
                else:
                    self._stmt(child)

    def _is_mask(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.masks
        if isinstance(expr, ast.Compare):
            return bool(self.prov.of(expr.left)[0] or any(
                self.prov.of(c)[0] for c in expr.comparators))
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return self._is_mask(expr.operand)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr)):
            return self._is_mask(expr.left) or self._is_mask(expr.right)
        if isinstance(expr, ast.Call):
            name = _last(_dotted(expr.func))
            if name in _BOOL_MAKERS:
                arg = expr.func.value if isinstance(
                    expr.func, ast.Attribute) and not _resolved(
                    self.ctx, expr.func).startswith("torch.") else (
                    expr.args[0] if expr.args else None)
                return bool(self.prov.of(arg)[0])
        return False

    def _bind(self, targets: list[ast.AST], value: ast.AST) -> None:
        names = bind_targets(targets)
        self.prov.bind(names, value)
        is_mask = self._is_mask(value)
        for n in names:
            self.masks.discard(n)
            if is_mask:
                self.masks.add(n)

    def _sinks(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    self._is_mask(node.slice) and self.prov.of(
                        node.value)[0]:
                self._report(
                    node,
                    f"indexing {self._describe(node.value)} with a "
                    f"boolean CUDA mask ({self._describe(node.slice)}) "
                    "has a data-dependent shape: the host reads the count "
                    "back before it can size the result — keep the shape "
                    "fixed (torch.where, masked_fill) or read back once, "
                    "explicitly")
                continue
            if not isinstance(node, ast.Call):
                continue
            resolved = resolve_dotted(_dotted(node.func), self.aliases)
            base, _, attr = resolved.rpartition(".")
            if base == "numpy" and attr in _GL013_NP_SINKS and node.args:
                self._sink(node, f"np.{attr}(...)", node.args[0])
            elif resolved in ("float", "int", "bool") and \
                    len(node.args) == 1:
                self._sink(node, f"{resolved}(...)", node.args[0])
            elif resolved.startswith("torch.") and \
                    attr in _DATA_SHAPE_FUNCS and node.args:
                self._sink(node, f"torch.{attr}(...)", node.args[0],
                           shape=True)
            elif resolved == "torch.where" and len(node.args) == 1:
                self._sink(node, "torch.where(cond)", node.args[0],
                           shape=True)
            elif resolved == "torch.repeat_interleave" and \
                    _kw(node, "output_size") is None and len(node.args) >= 2:
                self._sink(node, "torch.repeat_interleave(...) with no "
                           "output_size", node.args[1], shape=True)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _DATA_SHAPE_METHODS and \
                    not resolved.startswith(("torch.", "numpy.")):
                self._sink(node, f".{node.func.attr}()", node.func.value,
                           shape=True)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "repeat_interleave" and \
                    _kw(node, "output_size") is None and node.args:
                self._sink(node, ".repeat_interleave(...) with no "
                           "output_size", node.args[0], shape=True)

    def _sink(self, node: ast.Call, what: str, arg: ast.AST,
              shape: bool = False) -> None:
        if (node.lineno, node.col_offset) in self.skip:
            return
        chain, _ = self.prov.of(arg)
        if not chain:
            return
        if shape:
            msg = (f"{what} on a CUDA tensor has a data-dependent output "
                   "shape: the host blocks on the count before it can "
                   "size the result")
            hint = "keep the shape fixed, or read back once, explicitly"
        else:
            msg = (f"{what} of a CUDA tensor is an implicit, blocking "
                   "device→host transfer")
            hint = ("read it back explicitly (.item()/.cpu(), one visible "
                    "sync) or keep the math on the device")
        self._report(node, f"{msg}: {self._describe(arg)} ← {chain}; {hint}")

    @staticmethod
    def _describe(expr: ast.AST) -> str:
        src = _unparse(expr) or "<expr>"
        return src if len(src) <= 40 else src[:37] + "…"

    def _report(self, node: ast.AST, message: str) -> None:
        key = (node.lineno, node.col_offset)
        if key not in self._reported:
            self._reported.add(key)
            self.findings.append(self.ctx.finding(self.rule, node, message))


@register
class ImplicitTransferRule(ProjectRule):
    id = "GL013"
    name = "implicit-host-transfer"
    severity = "warning"
    rationale = (
        "np.* math, float()/int()/bool(), a boolean-mask index or a "
        "data-dependent-shape op (nonzero, masked_select, unique, "
        "repeat_interleave without output_size) on a value whose "
        "provenance traces to a CUDA tensor — even two calls deep in "
        "another module — is a blocking sync the code never spells; "
        "chip_smoke's syncs phase checks the same claim at runtime"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _not_tools(ctx)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        skip = set(per_step_sites(ctx, index))
        out: list[Finding] = []
        scopes: list[list[ast.stmt]] = [ctx.tree.body]
        scopes += [fn.body for fn in ctx.nodes_of(*_FUNC_NODES)]
        for body in scopes:
            out.extend(_DeviceFlow(self, ctx, index, skip).run(body))
        return out


# ---- GL015: spec axes vs the mesh declaration --------------------------------

@register
class ShardingSpecDriftRule(ProjectRule):
    id = "GL015"
    name = "sharding-spec-drift"
    severity = "error"
    rationale = (
        "a spec axis in a *PARTITION_RULES table or in ops/decode_mp.py's "
        "mp_cell_specs that train/mesh.py does not declare names an axis "
        "no grid has: after a rename the leaf is silently treated as "
        "replicated where it was meant to be sharded"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _not_tools(ctx)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        allowed = index.mesh.axes
        out: list[Finding] = []
        for table, node in _rule_tables(ctx):
            rows, _ = _table_rows(node.value)
            for family, _pattern, spec, _elt in rows:
                for lit in self._axis_literals(spec):
                    if lit.value not in allowed:
                        out.append(self._finding(
                            ctx, lit, f"{table} rule {family!r}", allowed))
        for fn in ctx.nodes_of(*_FUNC_NODES):
            if fn.name != "mp_cell_specs":
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.Tuple, ast.List)):
                    for lit in self._axis_literals(node):
                        if lit.value not in allowed:
                            out.append(self._finding(
                                ctx, lit, "mp_cell_specs", allowed))
            for arg, default in zip(
                    fn.args.args[len(fn.args.args) - len(fn.args.defaults):],
                    fn.args.defaults):
                if arg.arg.endswith("axis") and isinstance(
                        default, ast.Constant) and isinstance(
                        default.value, str) and \
                        default.value not in allowed:
                    out.append(self._finding(
                        ctx, default, "mp_cell_specs's axis default",
                        allowed))
        return out

    @staticmethod
    def _axis_literals(spec) -> list[ast.Constant]:
        if not isinstance(spec, (ast.Tuple, ast.List)):
            return []
        return [e for e in spec.elts if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]

    def _finding(self, ctx, node, where, allowed) -> Finding:
        return ctx.finding(
            self, node,
            f"spec axis {node.value!r} in {where} is not an axis "
            f"train/mesh.py declares ({', '.join(sorted(allowed))}): the "
            "spec drifted from the mesh declaration — rename the axis or "
            "declare it in make_mesh")


# ---- GL016: a collective with no group ---------------------------------------

_DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "reduce", "all_to_all",
    "all_to_all_single", "barrier", "gather", "scatter",
    "broadcast_object_list", "all_gather_object", "gather_object",
    "scatter_object_list", "monitored_barrier",
}
_WORLD_HELPERS = _PKG + "train/multihost.py"


@register
class CollectiveGroupRule(Rule):
    id = "GL016"
    name = "collective-axis-unbound-in-scope"
    severity = "error"
    rationale = (
        "a torch.distributed collective with no group= (or group=None) "
        "runs over the WORLD: on a ('data','seq') or ('data','mp') grid it "
        "reduces over the wrong ranks, or deadlocks against the ranks that "
        "called it on their group; only train/multihost.py's world-level "
        "helpers may leave it out"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _not_tools(ctx) and ctx.relpath != _WORLD_HELPERS

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ctx.nodes_of(ast.Call):
            resolved = _resolved(ctx, node.func)
            base, _, name = resolved.rpartition(".")
            if base != "torch.distributed" or name not in _DIST_COLLECTIVES:
                continue
            group = _kw(node, "group")
            if group is None or (isinstance(group, ast.Constant)
                                 and group.value is None):
                spelled = "no group=" if group is None else "group=None"
                out.append(ctx.finding(
                    self, node,
                    f"dist.{name}(...) with {spelled} runs over the WORLD "
                    "group: on a grid it reduces over the wrong ranks — "
                    "pass the axis's group (mesh.group, row.group)"))
        return out


# ---- GL018: regex partition-rule table coverage and shadowing ---------------

def _delete_element_fix(ctx: FileContext, elt: ast.AST,
                        description: str) -> Fix:
    """Span-delete one tuple/list element plus its trailing comma; when
    the element owns its line(s) outright, take the whole lines so no
    blank husk is left behind."""
    start_line, start_col = elt.lineno, elt.col_offset
    end_line = int(elt.end_lineno or elt.lineno)
    end_col = int(elt.end_col_offset or elt.col_offset)
    tail = ctx.lines[end_line - 1][end_col:] if end_line <= len(ctx.lines) \
        else ""
    i = 0
    while i < len(tail) and tail[i] in " \t":
        i += 1
    if i < len(tail) and tail[i] == ",":
        i += 1
        end_col += i
        tail = tail[i:]
    prefix = ctx.lines[start_line - 1][:start_col]
    if not prefix.strip() and not tail.strip() and end_line < len(ctx.lines):
        return Fix(edits=(Edit(line=start_line, col=0,
                               end_line=end_line + 1, end_col=0,
                               replacement=""),),
                   description=description)
    return Fix(edits=(Edit(line=start_line, col=start_col,
                           end_line=end_line, end_col=end_col,
                           replacement=""),),
               description=description)


@register
class PartitionTableShadowingRule(Rule):
    """GL007 generalized to EVERY ``*PARTITION_RULES`` regex table:
    coverage and first-match-wins shadowing against the contract.
    Coverage findings are skipped for the canonical
    ``PARAM_PARTITION_RULES`` table (GL007 owns those there), shadowing is
    checked everywhere, and deleting a fully shadowed row is the autofix.
    The contract is the port's (``CONTRACT_RELPATH``) when the file is in
    the port, else the file's ``SHARDING_CONTRACT``."""

    id = "GL018"
    name = "partition-rule-shadowing"
    severity = "error"
    rationale = (
        "first-match-wins regex rule tables rot silently: a later rule "
        "fully shadowed by earlier ones is dead code that reads like a "
        "live sharding decision, and in non-canonical tables a rule "
        "matching nothing (or a param matched by nothing) means the "
        "table drifted from the contract dump"
    )

    def applies(self, ctx: FileContext) -> bool:
        return "PARTITION_RULES" in ctx.source and not _is_test_file(ctx)

    def check(self, ctx: FileContext) -> list[Finding]:
        tables = _rule_tables(ctx)
        if not tables:
            return []
        if _in_package(ctx):
            params = _load_contract(ctx.root)
        else:
            contract_rel = "scripts/shardings_contract.json"
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and "SHARDING_CONTRACT" in \
                        _bound_names(node) and isinstance(
                            node.value, ast.Constant):
                    contract_rel = str(node.value.value)
            try:
                with open(os.path.join(ctx.root, contract_rel),
                          encoding="utf-8") as f:
                    params = list(json.load(f)["params"])
            except (OSError, ValueError, KeyError):
                params = None
        if params is None:
            return []  # no readable contract: nothing is checkable here
        out: list[Finding] = []
        for table_name, node in tables:
            out.extend(self._check_table(ctx, table_name, node, params))
        return out

    def _check_table(self, ctx: FileContext, table_name: str,
                     node: ast.AST, params: list[str]) -> list[Finding]:
        canonical = table_name == "PARAM_PARTITION_RULES"
        rows, literal = _table_rows(node.value)
        if not literal:
            # dynamically-built (or partially literal) table: single-file
            # analysis provably cannot check it — never guess
            return []
        out: list[Finding] = []
        claimed: set[str] = set()
        unruled = set(params)
        for family, pattern, _spec, elt in rows:
            try:
                rx = re.compile(pattern)
            except re.error as e:
                if not canonical:  # GL007 reports this on the canonical
                    out.append(ctx.finding(
                        self, elt,
                        f"{table_name} rule {family!r} has an invalid "
                        f"regex: {e}",
                    ))
                continue
            matched = {p for p in params if rx.fullmatch(p)}
            unruled -= matched
            if not matched:
                if not canonical:
                    out.append(ctx.finding(
                        self, elt,
                        f"{table_name} rule {family!r} ({pattern!r}) "
                        "matches no parameter in the contract dump — the "
                        "family it was written for was renamed or removed",
                    ))
            elif matched <= claimed:
                out.append(ctx.finding(
                    self, elt,
                    f"{table_name} rule {family!r} ({pattern!r}) is fully "
                    "shadowed: every contract param it matches is already "
                    "claimed by an earlier rule, so under first-match-wins "
                    "this row can never be selected — it is dead code that "
                    "reads like a live sharding decision",
                    fix=_delete_element_fix(
                        ctx, elt,
                        f"delete dead {table_name} rule {family!r} "
                        "(fully shadowed by earlier rules)",
                    ),
                ))
            claimed |= matched
        if not canonical:
            for p in sorted(unruled):
                out.append(ctx.finding(
                    self, node,
                    f"parameter {p!r} (from the contract dump) matches no "
                    f"{table_name} rule: add a rule for its family so its "
                    "sharding is an explicit decision",
                ))
        return out


# ---- GL019: cross-rank collective operand drift ------------------------------

_GL019_DIST = _DIST_COLLECTIVES - {"barrier", "monitored_barrier"}
# the port's collective wrappers (matched by last segment in the package)
_GL019_WRAPPERS = {
    "_all_reduce", "_all_gather", "broadcast_row", "broadcast_tensors",
    "seq_sum", "seq_max", "reduce_sums", "start_reduce", "reduce_tree",
    "_psum_embed", "_psum_select", "_merge_argmax", "_merge_lse",
}


class _DriftFlow:
    """Source-order walk of one scope with the project index plugged into
    the :class:`~.project.HostTaint` environment, so calls to functions
    whose summaries carry per-rank facts taint their results. At every
    collective call site each operand's shape/wire dtype is checked for
    per-rank dependence."""

    def __init__(self, rule: Rule, ctx: FileContext, index: ProjectIndex,
                 aliases: dict[str, str], module: str):
        self.rule = rule
        self.ctx = ctx
        self.aliases = aliases
        self.env = HostTaint(aliases, lookup=index.summary_lookup(module))
        self.findings: list[Finding] = []

    def run(self, body: list[ast.stmt]) -> list[Finding]:
        for stmt in body:
            self._stmt(stmt)
        return self.findings

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            self._expr(node.value)
            self._bind(node.targets, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if node.value is not None:
                self._expr(node.value)
                self._bind([node.target], node.value)
        elif isinstance(node, ast.If):
            self._expr(node.test)
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
            reason = self.env.value_taint(node.test)
            if reason:
                self.env.taint_branch_stores(node.body + node.orelse,
                                             reason)
        elif isinstance(node, ast.For):
            self._expr(node.iter)
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._expr(child)
                else:
                    self._stmt(child)

    def _bind(self, targets: list[ast.AST], value: ast.AST) -> None:
        names = bind_targets(targets)
        if names:
            self.env.bind(names, value)

    def _expr(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            resolved = resolve_dotted(_dotted(node.func), self.aliases)
            base, _, name = resolved.rpartition(".")
            if not (base == "torch.distributed" and name in _GL019_DIST
                    or name in _GL019_WRAPPERS and (
                        resolved.startswith(PACKAGE) or not base)):
                continue
            for operand in node.args[:2]:
                reason = self.env.shape_taint(operand)
                if not reason:
                    continue
                self.findings.append(self.ctx.finding(
                    self.rule, node,
                    f"{name}(...) operand {_unparse(operand)[:40]!r} has a "
                    f"per-rank shape or wire dtype ({reason}): every rank "
                    "of the group must pass identically shaped, "
                    "identically typed operands, or the collective hangs "
                    "or reads past a buffer — derive the size from values "
                    "every rank agrees on (gather the lengths first, pad "
                    "to the gathered max)"))
                break


@register
class CollectiveOperandDriftRule(ProjectRule):
    id = "GL019"
    name = "cross-host-collective-operand-drift"
    severity = "error"
    rationale = (
        "a collective whose operand shape or dtype depends on rank-local "
        "values (a dist.get_rank()/mesh.rank conditional, len() of a "
        "rank-local list, a ragged bucket tail) hangs the group at the "
        "rendezvous; the rank taint checks every collective reachable from "
        "train/multihost.py, train/mesh.py, parallel/comms.py, "
        "parallel/seq_parallel.py and ops/decode_mp.py"
    )

    def applies(self, ctx: FileContext) -> bool:
        return _not_tools(ctx)

    def check_project(self, ctx: FileContext,
                      index: ProjectIndex) -> list[Finding]:
        mod = index.by_relpath.get(ctx.relpath)
        if mod is None or mod.parse_error:
            return []
        seeded = ctx.relpath in MULTIHOST_SEED_RELPATHS
        if not seeded and not any(
                q.startswith(f"{mod.module}.") for q in index.multihost_reach):
            return []
        aliases = index.aliases_for(ctx.relpath, ctx.tree)
        quals = def_qualnames(ctx.tree)
        out: list[Finding] = []
        for node in ctx.nodes_of(*_FUNC_NODES):
            full = f"{mod.module}.{quals.get(id(node), node.name)}"
            if not seeded and full not in index.multihost_reach:
                continue
            out.extend(_DriftFlow(self, ctx, index, aliases,
                                  mod.module).run(node.body))
        if seeded:
            out.extend(_DriftFlow(self, ctx, index, aliases,
                                  mod.module).run(ctx.tree.body))
        return out


# ---- GL020: the CUDA kernel contract -----------------------------------------

_CSRC = "csrc"
_MIRROR_RE = re.compile(r"Mirror of ``struct (\w+)`` in (csrc/[\w/]+\.\w+)")
_C_INCLUDE_RE = re.compile(r'#include\s+"([^"]+)"')
_C_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_C_STRUCT_RE = re.compile(r"\bstruct\s+(\w+)\s*\{(.*?)\};", re.S)
_C_EXTERN_RE = re.compile(r'extern\s+"C"\s*\{')
_C_FUNC_RE = re.compile(
    r"(?:^|[;}\n])\s*((?:const\s+)?[\w\s]*?[\w*]+[\s*]+)(\w+)\s*\(([^)]*)\)\s*\{")
_CTYPES_KINDS = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_int": "i32", "c_int32": "i32", "c_uint": "i32", "c_uint32": "i32",
    "c_longlong": "i64", "c_int64": "i64", "c_ulonglong": "i64",
    "c_uint64": "i64", "c_size_t": "i64", "c_ssize_t": "i64",
    "c_float": "f32", "c_double": "f64", "c_bool": "i8", "c_char": "i8",
    "c_int8": "i8", "c_uint8": "i8", "c_short": "i16", "c_int16": "i16",
}


def c_kind(decl_type: str, structs: set[str]) -> str:
    """The kind of a C declaration's type: 'ptr' (or 'ptr:Name' for a
    pointer to a known struct), 'i32', 'i64', 'f32', 'f64', 'i8', 'i16',
    'struct:Name', or '?'."""
    t = " ".join(decl_type.replace("const", " ").replace("volatile", " ")
                 .replace("unsigned", " ").split())
    if "*" in t:
        base = t.replace("*", "").strip()
        return f"ptr:{base}" if base in structs else "ptr"
    if t in structs:
        return f"struct:{t}"
    return {"int": "i32", "int32_t": "i32", "uint32_t": "i32",
            "long long": "i64", "int64_t": "i64", "uint64_t": "i64",
            "size_t": "i64", "long": "i64", "float": "f32",
            "double": "f64", "char": "i8", "bool": "i8", "int8_t": "i8",
            "uint8_t": "i8", "short": "i16", "int16_t": "i16"}.get(t, "?")


def read_c(path: str, seen: set | None = None) -> str | None:
    """A C/C++ source with its local ``#include "..."`` headers inlined
    (each once), so a struct declared in a header is in scope."""
    seen = set() if seen is None else seen
    path = os.path.normpath(path)
    if path in seen:
        return ""
    seen.add(path)
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError:
        return None
    parts = []
    for m in _C_INCLUDE_RE.finditer(source):
        inc = read_c(os.path.join(os.path.dirname(path), m.group(1)), seen)
        if inc:
            parts.append(inc)
    return "\n".join(parts + [source])


def parse_c(source: str) -> tuple[dict, dict]:
    """A small regex pass over a C/C++ source: ``{struct: [(field, kind),
    ...]}`` and, for the functions defined in its ``extern "C"`` blocks,
    ``{name: (return kind, [param kinds])}``."""
    src = _C_COMMENT_RE.sub(" ", source)
    raw = {m.group(1): m.group(2) for m in _C_STRUCT_RE.finditer(src)}
    names = set(raw)
    structs: dict[str, list] = {}
    for name, body in raw.items():
        fields = []
        for decl in body.split(";"):
            decl = " ".join(decl.split())
            if not decl or "(" in decl:
                continue
            m = re.match(r"(.*?[\s*])(\w+(?:\s*,\s*\**\s*\w+)*)$", decl)
            if not m:
                continue
            base = m.group(1)
            for i, part in enumerate(m.group(2).split(",")):
                part = part.strip()
                stars = part.count("*")
                fname = part.replace("*", "").strip()
                fields.append((fname, c_kind(base + "*" * stars, names)))
        structs[name] = fields
    funcs: dict[str, tuple] = {}
    for m in _C_EXTERN_RE.finditer(src):
        depth, i = 1, m.end()
        while i < len(src) and depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        block = src[m.end():i - 1]
        # only the block's top level: drop every brace-nested body
        top, depth = [], 0
        for ch in block:
            if ch == "}":
                depth -= 1
                top.append(";")
                continue
            if depth == 0:
                top.append(ch)
            if ch == "{":
                depth += 1
        for fm in _C_FUNC_RE.finditer("".join(top)):
            ret, fname, params = fm.group(1), fm.group(2), fm.group(3)
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if not p or p == "void":
                    continue
                pm = re.match(r"(.*?[\s*])(\w+)$", p)
                kinds.append(c_kind(pm.group(1) if pm else p, names))
            funcs[fname] = (c_kind(ret, names), kinds)
    return structs, funcs


def _ctypes_kind(node: ast.AST, mirrors: dict[str, str]) -> str:
    """The kind of a ctypes type expression (see :func:`c_kind`)."""
    if isinstance(node, ast.Call) and _last(_dotted(node.func)) == \
            "POINTER" and node.args:
        inner = _last(_dotted(node.args[0]))
        return f"ptr:{mirrors[inner]}" if inner in mirrors else "ptr"
    name = _last(_dotted(node))
    if name in mirrors:
        return f"struct:{mirrors[name]}"
    return _CTYPES_KINDS.get(name, "?")


def _eval_fields(node: ast.AST) -> list[tuple[str, ast.AST]] | None:
    """(name, type node) pairs of a literal ``_fields_`` expression: lists
    of 2-tuples, ``[(n, T) for n in (literal names)]`` comprehensions, and
    their ``+`` concatenations. None when not literal (never guess)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _eval_fields(node.left), _eval_fields(node.right)
        return None if left is None or right is None else left + right
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Tuple) and len(elt.elts) >= 2 and \
                    isinstance(elt.elts[0], ast.Constant):
                out.append((str(elt.elts[0].value), elt.elts[1]))
            else:
                return None
        return out
    if isinstance(node, ast.ListComp) and len(node.generators) == 1:
        gen = node.generators[0]
        elt = node.elt
        if gen.ifs or not isinstance(gen.target, ast.Name) or \
                not isinstance(elt, ast.Tuple) or len(elt.elts) < 2 or \
                not isinstance(elt.elts[0], ast.Name) or \
                elt.elts[0].id != gen.target.id or \
                not isinstance(gen.iter, (ast.Tuple, ast.List)):
            return None
        names = []
        for e in gen.iter.elts:
            if not isinstance(e, ast.Constant):
                return None
            names.append(str(e.value))
        return [(n, elt.elts[1]) for n in names]
    return None


@register
class KernelContractRule(Rule):
    """The port's form of the JAX Pallas kernel contract: a kernel is
    reached through a hand-written ctypes mirror of a C struct, so the
    mirror, the C struct and the ``extern "C"`` signatures must agree
    field for field; each wrapper module keeps its plain version; and no
    CUDA branch falls back to the plain version from an ``except``."""

    id = "GL020"
    name = "pallas-kernel-contract"
    severity = "error"
    rationale = (
        "a ctypes Structure whose _fields_ drift from the C struct it "
        "mirrors (order, count, kind), or an argtypes/restype that drifts "
        "from its extern \"C\" declaration, makes the card read the wrong "
        "pointer silently; a wrapper module must keep its plain version, "
        "and a CUDA branch that calls it from an except hides the kernel"
    )

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(_PKG + "ops/") and \
            ("ctypes" in ctx.source or "build" in ctx.source)

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        here = os.path.dirname(ctx.path)
        c_cache: dict[str, tuple] = {}

        def c_of(rel: str):
            if rel not in c_cache:
                source = read_c(os.path.join(here, rel))
                c_cache[rel] = None if source is None else parse_c(source)
            return c_cache[rel]

        # (a) ctypes mirrors against their C structs
        mirrors: dict[str, str] = {}
        classes = []
        for cls in ctx.nodes_of(ast.ClassDef):
            doc = ast.get_docstring(cls) or ""
            m = _MIRROR_RE.search(doc)
            if m:
                mirrors[cls.name] = m.group(1)
                classes.append((cls, m.group(1), m.group(2)))
        imported = self._imported_mirrors(ctx)
        all_mirrors = {**imported, **mirrors}
        struct_files: dict[str, str] = {}
        for cls, struct, rel in classes:
            struct_files[struct] = rel
            parsed = c_of(rel)
            if parsed is None or struct not in parsed[0]:
                out.append(ctx.finding(
                    self, cls,
                    f"{cls.name} names struct {struct} in {rel}, which the "
                    "lint cannot find: the mirror has no C side to hold "
                    "it against"))
                continue
            out.extend(self._check_fields(ctx, cls, struct,
                                          parsed[0][struct], all_mirrors))
        # (b) argtypes/restype against the extern "C" declarations
        out.extend(self._check_signatures(ctx, c_of, all_mirrors))
        # (c) the plain version beside the kernel, (d) no except fallback
        out.extend(self._check_plain(ctx))
        return out

    @staticmethod
    def _imported_mirrors(ctx: FileContext) -> dict[str, str]:
        """Mirrors imported from a sibling ops module (``_StepArgs`` into
        beam_step.py): read the sibling's docstrings for their structs."""
        out: dict[str, str] = {}
        for node in ctx.nodes_of(ast.ImportFrom):
            for a in node.names:
                if not a.name.startswith("_") or not a.name.endswith("Args"):
                    continue
                mod = (node.module or "").rsplit(".", 1)[-1]
                path = os.path.join(os.path.dirname(ctx.path), mod + ".py")
                try:
                    with open(path, encoding="utf-8") as f:
                        tree = ast.parse(f.read())
                except (OSError, SyntaxError):
                    continue
                for cls in ast.walk(tree):
                    if isinstance(cls, ast.ClassDef) and cls.name == a.name:
                        m = _MIRROR_RE.search(ast.get_docstring(cls) or "")
                        if m:
                            out[a.asname or a.name] = m.group(1)
        return out

    def _check_fields(self, ctx, cls, struct, c_fields,
                      mirrors) -> list[Finding]:
        fields_node = None
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_fields_"
                    for t in stmt.targets):
                fields_node = stmt
        if fields_node is None:
            return [ctx.finding(self, cls, f"{cls.name} mirrors struct "
                                f"{struct} but defines no _fields_")]
        py = _eval_fields(fields_node.value)
        if py is None:
            return [ctx.finding(
                self, fields_node,
                f"{cls.name}._fields_ is not a literal list the lint can "
                f"hold against struct {struct}: spell it as lists of "
                "(name, ctypes type) pairs")]
        out = []
        if len(py) != len(c_fields):
            out.append(ctx.finding(
                self, fields_node,
                f"{cls.name} has {len(py)} fields but struct {struct} has "
                f"{len(c_fields)}: every later field is read at the wrong "
                "offset"))
        for i, ((pname, ptype), (cname, ckind)) in enumerate(
                zip(py, c_fields)):
            pkind = _ctypes_kind(ptype, mirrors)
            if pname != cname or not self._kinds_match(pkind, ckind):
                out.append(ctx.finding(
                    self, ptype if hasattr(ptype, "lineno") else
                    fields_node,
                    f"{cls.name} field {i} is {pname!r} ({pkind}) but "
                    f"struct {struct} field {i} is {cname!r} ({ckind}): "
                    "the mirror drifted from the C struct, so the card "
                    "reads the wrong value at this offset"))
                break  # one drift shifts every later field
        return out

    @staticmethod
    def _kinds_match(py: str, c: str) -> bool:
        if py == c:
            return True
        # a void pointer carries any pointer (the mirrors pass data_ptr())
        return py == "ptr" and c.startswith("ptr")

    def _check_signatures(self, ctx, c_of, mirrors) -> list[Finding]:
        out: list[Finding] = []
        loads: dict[str, str] = {}   # the module's kernel library name
        for node in ctx.nodes_of(ast.Call):
            if _last(_dotted(node.func)) == "load" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    "build" in _dotted(node.func) + str(_aliases(ctx).get(
                        _dotted(node.func).split(".")[0], "")):
                loads["lib"] = str(node.args[0].value)
        if "lib" not in loads:
            return out
        rel = f"{_CSRC}/{loads['lib']}.cu"
        parsed = c_of(rel)
        if parsed is None:
            return [ctx.finding(self, ctx.tree.body[0] if ctx.tree.body
                                else ctx.tree,
                                f"kernel source {rel} not found")]
        funcs = parsed[1]
        for fname, attr, value, anchor in self._ctypes_assignments(ctx):
            if fname not in funcs:
                out.append(ctx.finding(
                    self, anchor,
                    f"{fname}.{attr} is set but {rel} declares no "
                    f"extern \"C\" function {fname}"))
                continue
            c_ret, c_params = funcs[fname]
            if attr == "restype":
                kind = _ctypes_kind(value, mirrors)
                if not self._kinds_match(kind, c_ret):
                    out.append(ctx.finding(
                        self, anchor,
                        f"{fname}.restype is {kind} but {rel} returns "
                        f"{c_ret}: the caller reads the result wrongly"))
            else:
                elts = getattr(value, "elts", None)
                if elts is None:
                    continue
                kinds = [_ctypes_kind(e, mirrors) for e in elts]
                if len(kinds) != len(c_params) or not all(
                        self._kinds_match(p, c)
                        for p, c in zip(kinds, c_params)):
                    out.append(ctx.finding(
                        self, anchor,
                        f"{fname}.argtypes {kinds} do not match {rel}'s "
                        f"extern \"C\" {fname}({', '.join(c_params)})"))
        return out

    @staticmethod
    def _ctypes_assignments(ctx: FileContext):
        """(C function, 'argtypes'|'restype', value node, anchor) of every
        ``lib.f.argtypes = ...`` and of ``for fn in (lib.f, lib.g):
        fn.argtypes = ...`` loops."""
        loop_names: dict[str, list[str]] = {}
        for loop in ctx.nodes_of(ast.For):
            if isinstance(loop.target, ast.Name) and isinstance(
                    loop.iter, (ast.Tuple, ast.List)):
                loop_names[loop.target.id] = [
                    e.attr for e in loop.iter.elts
                    if isinstance(e, ast.Attribute)]
        for node in ctx.nodes_of(ast.Assign):
            for t in node.targets:
                if not isinstance(t, ast.Attribute) or t.attr not in (
                        "argtypes", "restype"):
                    continue
                owner = t.value
                if isinstance(owner, ast.Attribute):
                    yield owner.attr, t.attr, node.value, node
                elif isinstance(owner, ast.Name) and \
                        owner.id in loop_names:
                    for fname in loop_names[owner.id]:
                        yield fname, t.attr, node.value, node

    def _check_plain(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        launches = "_lib" in {f.name for f in ctx.nodes_of(*_FUNC_NODES)}
        plains = {f.name for f in ctx.nodes_of(*_FUNC_NODES)
                  if f.name.endswith("_plain")}
        if launches and not plains:
            out.append(ctx.finding(
                self, ctx.tree.body[0] if ctx.tree.body else ctx.tree,
                "this wrapper module binds a kernel but defines no plain "
                "version (a *_plain function) beside it: the CPU path and "
                "the kernel's tests have nothing to hold it against"))
        all_plain = plains | self._imported_plains(ctx)
        for node in ctx.nodes_of(ast.Try):
            for handler in node.handlers:
                for sub in ast.walk(handler):
                    if isinstance(sub, ast.Call) and _last(
                            _dotted(sub.func)) in all_plain:
                        out.append(ctx.finding(
                            self, sub,
                            f"{_last(_dotted(sub.func))}(...) called from "
                            "an except handler: a fallback from the kernel "
                            "to its plain version hides a kernel that did "
                            "not build or launch — raise instead"))
        return out

    @staticmethod
    def _imported_plains(ctx: FileContext) -> set[str]:
        return {a.asname or a.name
                for node in ctx.nodes_of(ast.ImportFrom)
                for a in node.names if a.name.endswith("_plain")}
