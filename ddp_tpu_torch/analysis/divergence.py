"""AST lint for multi-rank control-flow divergence (the counterpart of
``ddp_tpu/analysis/divergence.py``).

The contract of a process group is that every rank runs the SAME sequence
of collectives.  A collective (an ``all_reduce``, a barrier, the
preemption stop vote, the straggler gather) that is only *sometimes*
reached (under a rank check, inside an exception handler, behind
queue/timing state) is the classic whole-job hang: the ranks that enter
it wait forever for the ranks that didn't.  This pass flags exactly that
shape in host code.

Two rules, per function:

1. **Guarded collective**: a collective call lexically under a condition
   the pass cannot prove uniform across ranks (anything but constants,
   ``world_size``/``device_count``-style topology reads, and locals
   derived only from those).  ``except`` handlers are rank-local by
   definition (one rank's I/O error is not another's).  A collective in
   an ``if``'s TEST position is fine: the test itself executes
   unconditionally (the preemption guard's ``if dist.any_rank(local):``
   is the sanctioned pattern: decide *collectively*, then branch).
2. **Rank-local early exit**: a ``return`` under a non-uniform condition,
   followed later in the same function by a collective: the rank that
   returned early skips a collective the others enter.  Same deadlock, no
   lexical nesting.

The vocabulary is a table (:class:`Vocabulary`) the scanners take as an
argument.  :data:`JAX_RULES` is JAX's (the parity tests run it on JAX's
own sources); :data:`TORCH_RULES`, the default, adds
``torch.distributed``'s collectives, the port's rendezvous helpers in
``parallel/dist.py`` and its topology reads.  ``get_rank``, ``rank``,
``data_rank`` and ``stage_index`` stay non-uniform: a rank check is the
canonical divergent condition.

Two deliberate differences from JAX's pass:

- **No excluded modules.**  JAX skips ``step.py``, ``zero.py``,
  ``epoch.py`` and ``layers.py`` because they are traced SPMD bodies,
  uniform by construction.  The port's versions of those files are eager
  host code that issues collectives, so they are exactly what this lint
  is for (:data:`EXCLUDE_BASENAMES` is empty; JAX's list is kept as
  :data:`JAX_EXCLUDE_BASENAMES` for the parity tests).
- **Point-to-point stays out.**  ``send_stage``/``recv_stage`` (and
  ``torch.distributed``'s ``send``/``recv``/``isend``/``irecv``) pair
  one rank with one other, rank-dependent by design: the pipeline's stage
  s sends where stage s+1 receives.  They are not collectives, and
  counting them would flag every schedule.

Deliberate exceptions carry ``# analysis: divergence-ok(<why all ranks
agree>)`` on the flagged line, the line above, or the guard line, the same
greppable decision-trail vocabulary as ``host-sync-ok`` /
``unlocked-ok``.  The annotation's argument should say why the condition
is in fact uniform (configuration identical on every rank, a value that
is itself the result of a collective, ...).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

from .findings import Finding, make_finding

SCAN_PACKAGES = ("train", "resilience", "obs", "parallel", "serve", "data")

# JAX's traced-SPMD module basenames (uniform by construction there); the
# port's counterparts are eager host code and are scanned.
JAX_EXCLUDE_BASENAMES = ("step.py", "zero.py", "epoch.py", "layers.py")
EXCLUDE_BASENAMES: Tuple[str, ...] = ()


class Vocabulary(NamedTuple):
    """Which calls are collectives, and which reads are uniform."""
    # A call is "a collective" when its last dotted component is one of
    # these (each is, or transitively runs, a cross-rank rendezvous).
    collective_calls: frozenset
    # Calls whose result is identical on every rank: topology reads.
    uniform_calls: frozenset


JAX_RULES = Vocabulary(
    collective_calls=frozenset((
        "psum", "pmean", "pmax", "pmin", "all_gather", "reduce_scatter",
        "psum_scatter", "ppermute", "all_to_all", "pbroadcast",
        "process_allgather", "sync_global_devices", "broadcast_one_to_all",
        # repo coordination helpers (resilience/, obs/):
        "should_stop", "_process_any", "straggler_report",
        "epoch_straggler_record", "_gather_host_rows",
    )),
    uniform_calls=frozenset(("process_count", "device_count",
                             "local_device_count", "vma_semantics")))

TORCH_RULES = Vocabulary(
    collective_calls=JAX_RULES.collective_calls | frozenset((
        # torch.distributed's collectives:
        "all_reduce", "all_gather", "all_gather_into_tensor",
        "all_gather_object", "reduce_scatter_tensor", "broadcast",
        "broadcast_object_list", "barrier", "monitored_barrier",
        "all_to_all", "reduce", "gather", "scatter",
        # the port's rendezvous helpers (parallel/dist.py):
        "any_rank", "all_gather_rows", "all_reduce_grads",
        "average_buffers", "broadcast_state", "all_reduce_sum_",
        "_all_reduce_sum", "reduce_scatter_flat", "all_gather_flat",
        "all_reduce_model_", "all_gather_model", "pipe_broadcast_",
    )),
    uniform_calls=JAX_RULES.uniform_calls | frozenset((
        "get_world_size", "world_size", "data_size", "num_stages",
        "is_initialized")))

# Kept under JAX's names: the default (port) tables.
COLLECTIVE_CALLS = TORCH_RULES.collective_calls
UNIFORM_CALLS = TORCH_RULES.uniform_calls

_OK_RE = re.compile(r"#\s*analysis:\s*divergence-ok\(([^)]*)\)")


class _Guard(NamedTuple):
    lineno: int
    reason: str


class _Exit(NamedTuple):
    lineno: int
    guard: _Guard


def _annotated_ok(lines: List[str], *linenos: int) -> bool:
    for ln in linenos:
        for cand in (ln, ln - 1):
            if 1 <= cand <= len(lines) and _OK_RE.search(lines[cand - 1]):
                return True
    return False


def _call_name(node: ast.Call) -> str:
    parts: List[str] = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _describe(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:
        text = type(node).__name__
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _own_statements(fn: ast.AST):
    """Walk a function's own statements, not those of nested defs."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                stack.append(child)


_NONUNIFORM = ast.Call(func=ast.Name(id="<nonuniform>", ctx=ast.Load()),
                       args=[], keywords=[])


def _uniform_names(fn: ast.AST, rules: Vocabulary) -> frozenset:
    """Locals provably uniform: assigned only from uniform expressions
    (fixpoint, so ``multi = dist.process_count() > 1`` then
    ``quiet = not multi`` both qualify).  A name bound by a loop target,
    an augmented assignment, tuple unpacking, or a ``with ... as`` is
    never provable."""
    assigns: Dict[str, List[ast.AST]] = {}

    def taint(target: ast.AST) -> None:
        for t in ast.walk(target):
            if isinstance(t, ast.Name):
                assigns.setdefault(t.id, []).append(_NONUNIFORM)

    for node in _own_statements(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    assigns.setdefault(tgt.id, []).append(node.value)
                else:
                    taint(tgt)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                assigns.setdefault(node.target.id, []).append(node.value)
            else:
                taint(node.target)
        elif isinstance(node, (ast.AugAssign, ast.For)):
            taint(node.target)
        elif isinstance(node, ast.With):
            for item in node.items:
                if item.optional_vars is not None:
                    taint(item.optional_vars)
        elif isinstance(node, ast.NamedExpr):
            taint(node.target)
    uniform: set = set()
    for _ in range(len(assigns) + 1):
        changed = False
        for name, values in assigns.items():
            if name in uniform:
                continue
            if all(_is_uniform(v, frozenset(uniform), rules)
                   for v in values):
                uniform.add(name)
                changed = True
        if not changed:
            break
    return frozenset(uniform)


def _is_uniform(node: ast.AST, uniform_names: frozenset,
                rules: Vocabulary) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in uniform_names
    if isinstance(node, ast.UnaryOp):
        return _is_uniform(node.operand, uniform_names, rules)
    if isinstance(node, ast.BoolOp):
        return all(_is_uniform(v, uniform_names, rules)
                   for v in node.values)
    if isinstance(node, ast.Compare):
        return (_is_uniform(node.left, uniform_names, rules)
                and all(_is_uniform(c, uniform_names, rules)
                        for c in node.comparators))
    if isinstance(node, ast.BinOp):
        return (_is_uniform(node.left, uniform_names, rules)
                and _is_uniform(node.right, uniform_names, rules))
    if isinstance(node, ast.IfExp):
        return all(_is_uniform(n, uniform_names, rules)
                   for n in (node.test, node.body, node.orelse))
    if isinstance(node, ast.Call):
        name = _call_name(node).rsplit(".", 1)[-1]
        return (name in rules.uniform_calls
                and all(_is_uniform(a, uniform_names, rules)
                        for a in node.args))
    return False


class _FunctionScan:
    def __init__(self, path: str, lines: List[str], fn: ast.AST,
                 rules: Vocabulary):
        self.path = path
        self.lines = lines
        self.fn = fn
        self.rules = rules
        self.uniform = _uniform_names(fn, rules)
        self.findings: List[Finding] = []
        self.exits: List[_Exit] = []
        self.unguarded: List[Tuple[int, str]] = []

    def run(self) -> List[Finding]:
        self._scan(self.fn.body, [])
        for lineno, name in self.unguarded:
            prior = [e for e in self.exits if e.lineno < lineno]
            if not prior:
                continue
            e = prior[0]
            if _annotated_ok(self.lines, lineno, e.lineno, e.guard.lineno):
                continue
            self.findings.append(make_finding(
                "error", "divergence", f"{self.path}:{lineno}",
                f"collective {name}() is only reached past a host-local "
                f"early return at line {e.lineno} (condition at line "
                f"{e.guard.lineno}: {e.guard.reason}) — a host that "
                "returns early skips a collective the others enter and "
                "the pod hangs; make the exit condition uniform or "
                "annotate '# analysis: divergence-ok(why all hosts "
                "agree)'"))
        return self.findings

    # -- statement walk ---------------------------------------------------

    def _scan(self, stmts, guards: List[_Guard]) -> None:
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue                       # scanned as its own function
            if isinstance(node, ast.If):
                self._check_expr(node.test, guards)
                new = guards
                if not _is_uniform(node.test, self.uniform, self.rules):
                    new = guards + [_Guard(node.lineno,
                                           f"`{_describe(node.test)}`")]
                self._scan(node.body, new)
                self._scan(node.orelse, new)
            elif isinstance(node, ast.While):
                self._check_expr(node.test, guards)
                new = guards
                if not _is_uniform(node.test, self.uniform, self.rules):
                    new = guards + [_Guard(node.lineno,
                                           f"`{_describe(node.test)}`")]
                self._scan(node.body, new)
                self._scan(node.orelse, new)
            elif isinstance(node, ast.For):
                self._check_expr(node.iter, guards)
                self._scan(node.body, guards)
                self._scan(node.orelse, guards)
            elif isinstance(node, ast.Try):
                self._scan(node.body, guards)
                for handler in node.handlers:
                    hg = guards + [_Guard(
                        handler.lineno,
                        "except handler (a host-local failure path)")]
                    self._scan(handler.body, hg)
                self._scan(node.orelse, guards)
                self._scan(node.finalbody, guards)
            elif isinstance(node, ast.With):
                for item in node.items:
                    self._check_expr(item.context_expr, guards)
                self._scan(node.body, guards)
            elif isinstance(node, ast.Return):
                if guards:
                    self.exits.append(_Exit(node.lineno, guards[-1]))
                if node.value is not None:
                    self._check_expr(node.value, guards)
            else:
                self._check_expr(node, guards)

    def _check_expr(self, node: ast.AST, guards: List[_Guard]) -> None:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            name = _call_name(call)
            if name.rsplit(".", 1)[-1] not in self.rules.collective_calls:
                continue
            if not guards:
                self.unguarded.append((call.lineno, name))
                continue
            g = guards[-1]
            if _annotated_ok(self.lines, call.lineno, g.lineno):
                continue
            self.findings.append(make_finding(
                "error", "divergence", f"{self.path}:{call.lineno}",
                f"collective {name}() under a host-local condition "
                f"(line {g.lineno}: {g.reason}) — hosts that disagree on "
                "it run different collective sequences and the pod "
                "hangs; decide collectively first (the "
                "`if dist.any_rank(...)` pattern), make the condition "
                "uniform, or annotate '# analysis: divergence-ok(why "
                "all hosts agree)'"))


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def scan_source(path: str, source: str,
                rules: Vocabulary = TORCH_RULES) -> List[Finding]:
    """Divergence findings for one module's source text."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [make_finding("warning", "divergence", path,
                             f"unparseable: {e}")]
    lines = source.splitlines()
    out: List[Finding] = []
    for fn in _functions(tree):
        out.extend(_FunctionScan(path, lines, fn, rules).run())
    return out


def scan_packages(root: str,
                  packages: Tuple[str, ...] = SCAN_PACKAGES,
                  exclude: Tuple[str, ...] = EXCLUDE_BASENAMES,
                  rules: Vocabulary = TORCH_RULES) -> List[Finding]:
    """Walk the given subpackages of the package root."""
    out: List[Finding] = []
    for pkg in packages:
        pkg_dir = os.path.join(root, pkg)
        if not os.path.isdir(pkg_dir):
            continue
        for dirpath, _dirs, files in os.walk(pkg_dir):
            for fname in sorted(files):
                if not fname.endswith(".py") or fname in exclude:
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, os.path.dirname(root))
                with open(fpath, "r", encoding="utf-8") as fh:
                    out.extend(scan_source(rel, fh.read(), rules))
    return out
