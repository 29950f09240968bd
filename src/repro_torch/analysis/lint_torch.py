"""AST lint for PyTorch hazards over the port's package.

The runtime tests prove numerical parity; this pass catches what parity
tests cannot see: code that is correct but silently slow (a host sync per
element), correct today but fragile (a draw from the global generator, so
two runs from one seed differ once something else draws), or wrong only
off the tested path (a silent fall back to the CPU).  The port's
counterpart of ``repro.analysis.lint_jax``, with its suppression syntax.

Rules
-----

=======  ====================  ==============================================
id       name                  flags
=======  ====================  ==============================================
TXH001   global-generator      a torch sampling call (``torch.rand``,
                               ``randn``, ``randint``, ``randperm``,
                               ``bernoulli``, ``multinomial``, ``normal``,
                               ``poisson``, the ``*_like`` draws, or a
                               tensor's ``.uniform_``, ``.normal_``, ...)
                               without ``generator=``: it draws from torch's
                               global generator
TXH002   host-sync-loop        ``.item()``, ``.tolist()``, ``.cpu()``, or
                               ``float()``/``int()``/``bool()`` of a
                               subscripted value, in the part of a Python
                               loop or comprehension that runs every
                               iteration: one host transfer per element when
                               the value lies on the card
TXH004   mutable-default       mutable default argument values
TXH005   device-fallback       ``torch.cuda.is_available()`` in the package:
                               a branch that runs the CPU where the card is
                               missing (entry points take ``device=None`` for
                               the card and raise without one)
TXH006   package-boundary      an import of ``jax``, ``jaxlib`` or the JAX
                               package ``repro``: the port imports torch and
                               numpy only
PYL001   unused-import         module-level import never referenced
                               (``__init__.py`` re-export files are exempt)
PYL002   shadowed-builtin      a parameter or assignment shadowing a python
                               builtin
=======  ====================  ==============================================

The reference's JXH003 (``static_argnames`` out of sync with a jitted
signature) has no counterpart: the port jits nothing.

Suppression: append ``# repro-lint: disable=RULE[,RULE...]`` to the flagged
line, or put it on the line above (``disable=all`` silences every rule
there); ``# noqa`` on an import exempts a deliberate re-export from PYL001.
Pair a suppression with the reason.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Violation

# files scanned by default (relative to the repo root)
DEFAULT_PATHS: Tuple[str, ...] = ("src/repro_torch",)
DEFAULT_EXCLUDE: Tuple[str, ...] = ()

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+)")

# torch functions that draw from a generator, and tensor methods that fill
# in place from one
_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal", "poisson", "rand_like",
    "randn_like", "randint_like",
}
_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_", "geometric_", "cauchy_", "log_normal_",
}
_TORCH_PREFIXES = {("torch",), ("torch", "random")}
_FALLBACK_QUERIES = {("torch", "cuda", "is_available")}
_FORBIDDEN_MODULES = ("jax", "jaxlib", "repro")

_SHADOW_BUILTINS = {
    "list", "dict", "set", "tuple", "type", "id", "input", "filter", "map",
    "next", "format", "object", "str", "int", "float", "bool", "len", "hash",
    "iter", "round", "slice", "compile", "eval", "open", "sum", "min", "max",
    "all", "any", "vars", "dir", "range", "zip", "sorted", "enumerate",
    "bytes", "print", "property",
}


@dataclass(frozen=True)
class LintRule:
    id: str
    name: str
    description: str
    hint: str
    check: Callable[["_Module"], Iterator[Violation]]


LINT_RULES: Dict[str, LintRule] = {}


def _register(rule_id: str, name: str, description: str, hint: str):
    def deco(fn):
        LINT_RULES[rule_id] = LintRule(rule_id, name, description, hint, fn)
        return fn

    return deco


# --------------------------------------------------------------------- helpers
class _Module:
    """One parsed source file plus the per-line suppression table."""

    def __init__(self, source: str, path: str):
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.path = path

    def suppressed(self, node: ast.AST) -> Set[str]:
        """Rule ids suppressed on any physical line of ``node``'s statement,
        or on the line directly above it (comment-on-its-own-line form)."""
        first = getattr(node, "lineno", None)
        if first is None:
            return set()
        last = getattr(node, "end_lineno", first) or first
        out: Set[str] = set()
        for ln in range(max(first - 1, 1), last + 1):
            if 0 < ln <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[ln - 1])
                if m:
                    out |= {t.strip() for t in m.group(1).split(",") if t.strip()}
        return out

    def violation(self, rule: str, node: ast.AST, message: str) -> Optional[Violation]:
        sup = self.suppressed(node)
        if rule in sup or "all" in sup:
            return None
        return Violation(
            rule=rule,
            where=f"{self.path}:{getattr(node, 'lineno', 0)}",
            message=message,
            hint=LINT_RULES[rule].hint if rule in LINT_RULES else "",
        )


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for anything non-dotted."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _scopes(tree: ast.Module) -> Iterator[ast.AST]:
    """The module plus every (nested) function definition."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Walk a scope's own statements without descending into nested defs."""
    stack = list(getattr(scope, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # a nested def is its own scope; class-body bindings are class
            # attributes, which shadow nothing outside the class statement
            continue
        stack.extend(ast.iter_child_nodes(node))


def _func_params(fn: ast.AST) -> List[str]:
    a = fn.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


def _defaults_of(fn: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    a = fn.args
    pos = a.posonlyargs + a.args
    for arg, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        yield arg.arg, default
    for arg, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None:
            yield arg.arg, default


def _per_iteration(loop: ast.AST) -> List[ast.AST]:
    """The parts of a loop that run once an iteration: not the iterable of
    a ``for`` or of a comprehension's first ``for``, evaluated once."""
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return [loop.target, *loop.body, *loop.orelse]
    if isinstance(loop, ast.While):
        return [loop.test, *loop.body]
    parts = [loop.key, loop.value] if isinstance(loop, ast.DictComp) else [loop.elt]
    for i, gen in enumerate(loop.generators):
        parts += [gen.target, *gen.ifs] + ([gen.iter] if i else [])
    return parts


# ----------------------------------------------------------------------- rules
@_register(
    "TXH001",
    "global-generator",
    "a torch sampling call without generator=",
    "pass an explicit torch.Generator (seeded from the run's seed) as "
    "generator=; the global generator makes a draw depend on every other "
    "draw the process made before it",
)
def _check_global_generator(mod: _Module) -> Iterator[Violation]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or any(kw.arg == "generator" for kw in node.keywords):
            continue
        dotted = _dotted(node.func)
        what = None
        if dotted and len(dotted) >= 2 and dotted[:-1] in _TORCH_PREFIXES and dotted[-1] in _SAMPLERS:
            what = ".".join(dotted)
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_SAMPLERS:
            what = f".{node.func.attr}"
        if what:
            v = mod.violation("TXH001", node, f"{what}() draws from torch's global generator")
            if v:
                yield v


@_register(
    "TXH002",
    "host-sync-loop",
    "per-element .item()/.tolist()/.cpu()/float()/int()/bool() inside a Python loop",
    "one host transfer per element when the operand lies on the card; pull "
    "the whole tensor once (.cpu() or .tolist() before the loop) or keep "
    "the work on the device",
)
def _check_host_sync_loop(mod: _Module) -> Iterator[Violation]:
    loops = [
        n
        for n in ast.walk(mod.tree)
        if isinstance(n, (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp))
    ]
    seen: Set[int] = set()
    for loop in loops:
        for node in (n for part in _per_iteration(loop) for n in ast.walk(part)):
            if id(node) in seen or not isinstance(node, ast.Call):
                continue
            msg = None
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Subscript)
            ):
                msg = (
                    f"{node.func.id}() of a subscripted value inside a loop — "
                    "a tensor operand on the card costs one host sync per element"
                )
            elif isinstance(node.func, ast.Attribute) and node.func.attr in ("item", "tolist", "cpu") \
                    and not node.args and not node.keywords:
                msg = f".{node.func.attr}() inside a loop — one host sync per element"
            if msg:
                seen.add(id(node))
                v = mod.violation("TXH002", node, msg)
                if v:
                    yield v


@_register(
    "TXH004",
    "mutable-default",
    "mutable default argument value",
    "default values are evaluated once at def time and shared across calls; "
    "use None and create the object in the body",
)
def _check_mutable_default(mod: _Module) -> Iterator[Violation]:
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for arg, default in _defaults_of(fn):
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set")
            )
            if mutable:
                v = mod.violation("TXH004", fn, f"{fn.name!r} has a mutable default for parameter {arg!r}")
                if v:
                    yield v


@_register(
    "TXH005",
    "device-fallback",
    "torch.cuda.is_available() in the package",
    "an entry point takes device=None for the card and raises where there "
    "is none; a branch on is_available() runs the CPU twins silently "
    "instead.  Let the caller ask for the CPU",
)
def _check_device_fallback(mod: _Module) -> Iterator[Violation]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in _FALLBACK_QUERIES:
            v = mod.violation("TXH005", node, "torch.cuda.is_available() chooses a device for the caller")
            if v:
                yield v


@_register(
    "TXH006",
    "package-boundary",
    "an import of jax, jaxlib or the JAX package repro",
    "the port imports torch and numpy only; keep its own copy of what it "
    "needs from the JAX package",
)
def _check_package_boundary(mod: _Module) -> Iterator[Violation]:
    for node in ast.walk(mod.tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        for name in names:
            if name.split(".")[0] in _FORBIDDEN_MODULES:
                v = mod.violation("TXH006", node, f"imports {name!r}")
                if v:
                    yield v


@_register(
    "PYL001",
    "unused-import",
    "module-level import never referenced",
    "delete it (re-exports belong in __init__.py, which this rule skips)",
)
def _check_unused_import(mod: _Module) -> Iterator[Violation]:
    if os.path.basename(mod.path) == "__init__.py":
        return
    imported: Dict[str, ast.AST] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                imported[alias.asname or alias.name.split(".")[0]] = node
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name != "*":
                    imported[alias.asname or alias.name] = node
    used: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # __all__ entries and string annotations ("Algo | None") count
            used.update(re.findall(r"\w+", node.value))
        elif isinstance(node, ast.Attribute):
            root = _dotted(node)
            if root:
                used.add(root[0])
    for name, node in imported.items():
        if name in used:
            continue
        # honor ruff/flake8-style suppression on deliberate re-exports
        lines = mod.lines[node.lineno - 1 : (node.end_lineno or node.lineno)]
        if any("# noqa" in ln for ln in lines):
            continue
        v = mod.violation("PYL001", node, f"imported name {name!r} is never used")
        if v:
            yield v


@_register(
    "PYL002",
    "shadowed-builtin",
    "parameter or assignment shadowing a python builtin",
    "rename it; shadowing len/type/id/... breaks the builtin for the rest of the scope",
)
def _check_shadowed_builtin(mod: _Module) -> Iterator[Violation]:
    for fn in ast.walk(mod.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for param in _func_params(fn):
                if param in _SHADOW_BUILTINS:
                    v = mod.violation("PYL002", fn, f"parameter {param!r} of {fn.name!r} shadows a builtin")
                    if v:
                        yield v
    for scope in _scopes(mod.tree):
        for node in _scope_nodes(scope):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) and node.id in _SHADOW_BUILTINS:
                v = mod.violation("PYL002", node, f"assignment to {node.id!r} shadows a builtin")
                if v:
                    yield v


# ------------------------------------------------------------------ public api
def lint_source(source: str, path: str = "<string>", rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Run the (selected) lint rules over one source string."""
    mod = _Module(source, path)
    out: List[Violation] = []
    for rule_id, rule in LINT_RULES.items():
        if rules is None or rule_id in rules:
            out.extend(rule.check(mod))
    return sorted(out, key=lambda v: (v.where, v.rule))


def iter_python_files(paths: Iterable[str], exclude: Sequence[str] = DEFAULT_EXCLUDE):
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                if f.endswith(".py") and f not in exclude:
                    yield os.path.join(root, f)


def lint_paths(paths: Sequence[str] = DEFAULT_PATHS, *, rules: Optional[Sequence[str]] = None,
               exclude: Sequence[str] = DEFAULT_EXCLUDE) -> List[Violation]:
    """Run the lint over every ``.py`` file under ``paths``."""
    out: List[Violation] = []
    for path in iter_python_files(paths, exclude):
        with open(path, "r", encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), path, rules))
    return out
