"""Lockset lint for the threaded runtime subsystems (a copy of
``ddp_tpu/analysis/lockset.py``: the AST logic is library-agnostic).

The threaded modules (data/prefetch.py, the batchers, the router and the
fleet, serve/model_group.py, the checkpoint writer thread in
train/trainer.py, resilience/watchdog.py and store.py, obs/inspect.py)
each follow the same discipline: shared mutable attributes are guarded by
a named ``threading.Lock``, thread-safe primitives (Queue/Event/deque)
synchronize themselves, and the few deliberately lock-free shared values
(a monotonic heartbeat float, an error slot read only after ``join()``)
are DOCUMENTED races.  This lint makes the discipline machine-checked
from the AST:

**Annotation vocabulary** (inline comments on the ``__init__`` assignment
line, or the line above):

- ``# analysis: shared-under(<lock>)`` — every read/write of the
  attribute outside ``__init__``'s top level must happen lexically inside
  ``with self.<lock>:``; any access outside is an ``error``.
- ``# analysis: unlocked-ok(<reason>)`` — the attribute is shared but
  deliberately unsynchronized (or synchronized by something the AST
  can't see, e.g. ``Thread.join``); the lint skips it, the reason is the
  audit trail.

**Discovery** (no annotation needed): a class that spawns a thread
(``threading.Thread(target=self.m)`` or ``target=<nested fn>``) gets its
methods partitioned into worker-reachable and caller-reachable sets via
the intra-class call graph.  An attribute that is MUTATED outside
``__init__``, accessed from BOTH sides, is not a lock/thread-safe
primitive, carries no annotation, and has at least one access under no
lock at all, is flagged as a lock-free shared attribute — the data-race
shape, caught before a chip run instead of in one.

Nested functions handed to ``Thread(target=...)`` (the trainer's
checkpoint ``write()`` closure) count as worker context; ``nonlocal``
declarations inside such a function are flagged too (a shared mutable
local with no lock to name).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from .findings import Finding, make_finding

# Modules whose classes are held to the lockset discipline: JAX's ten
# counterparts, then every other port module that constructs a
# ``threading.Thread``.
JAX_SCAN_MODULES = ("data/prefetch.py", "serve/batcher.py",
                    "serve/engine.py", "serve/router.py", "serve/fleet.py",
                    "train/trainer.py", "train/checkpoint.py",
                    "resilience/watchdog.py", "resilience/store.py",
                    "obs/registry.py")
SCAN_MODULES = JAX_SCAN_MODULES + (
    "cli.py", "bench.py", "fleet_load.py", "serve/__main__.py",
    "serve/model_group.py", "serve/token_batcher.py", "obs/blackbox.py",
    "obs/inspect.py")

_ANN_RE = re.compile(
    r"#\s*analysis:\s*(shared-under|unlocked-ok)\(([^)]*)\)")

LOCK_CTORS = {"Lock", "RLock"}
# Constructors whose instances synchronize themselves (or are only ever
# touched through their own thread-safe methods).
SAFE_CTORS = {"Lock", "RLock", "Event", "Condition", "Semaphore",
              "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
              "LifoQueue", "PriorityQueue", "deque", "Thread",
              "ThreadPoolExecutor"}


class Access(NamedTuple):
    attr: str
    method: str          # defining method name (worker closures keep it)
    lineno: int
    is_store: bool
    locks: frozenset     # lock attr names lexically held
    worker: bool         # True when reached from a thread target closure
    init_top: bool       # top-level __init__ statement (pre-publication)


def _last_name(node: ast.AST) -> str:
    while isinstance(node, ast.Attribute):
        node = node.attr if isinstance(node.attr, ast.AST) else node.attr
        break
    if isinstance(node, str):
        return node
    return ""


def _ctor_name(value: ast.AST) -> str:
    """Class name of ``self.x = <Ctor>(...)``, '' otherwise."""
    if not isinstance(value, ast.Call):
        return ""
    f = value.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _annotation_on(lines: List[str], lineno: int):
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _ANN_RE.search(lines[ln - 1])
            if m:
                return m.group(1), m.group(2).strip()
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, lines: List[str]):
        self.node = node
        self.name = node.name
        self.lines = lines
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.annotations: Dict[str, Tuple[str, str]] = {}
        self.accesses: List[Access] = []
        self.thread_targets: Set[str] = set()   # method names
        self.calls: Dict[str, Set[str]] = {}    # method -> self.m() called
        self.nonlocal_findings: List[Tuple[str, int]] = []
        self._collect()

    # -- collection --------------------------------------------------------

    def _collect(self) -> None:
        for item in self.node.body:
            if isinstance(item, ast.FunctionDef):
                if item.name == "__init__":
                    self._collect_init_decls(item)
                self._collect_method(item)

    def _collect_init_decls(self, init: ast.FunctionDef) -> None:
        for stmt in init.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            ctor = _ctor_name(value)
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if ctor in LOCK_CTORS:
                    self.lock_attrs.add(attr)
                if ctor in SAFE_CTORS:
                    self.safe_attrs.add(attr)
                ann = _annotation_on(self.lines, stmt.lineno)
                if ann is not None:
                    self.annotations[attr] = ann

    def _collect_method(self, method: ast.FunctionDef) -> None:
        """Record self-attribute accesses, lexical lock context, nested
        thread-target closures, and the intra-class call graph."""
        info = self
        calls: Set[str] = set()
        info.calls[method.name] = calls
        # Nested function defs that are Thread targets in this method.
        nested_targets: Set[str] = set()
        for node in ast.walk(method):
            if isinstance(node, ast.Call):
                f = node.func
                is_thread = ((isinstance(f, ast.Attribute)
                              and f.attr == "Thread")
                             or (isinstance(f, ast.Name)
                                 and f.id == "Thread"))
                if is_thread:
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        tgt_attr = _self_attr(kw.value)
                        if tgt_attr is not None:
                            info.thread_targets.add(tgt_attr)
                        elif isinstance(kw.value, ast.Name):
                            nested_targets.add(kw.value.id)

        class V(ast.NodeVisitor):
            def __init__(self):
                self.locks: List[str] = []
                self.fn_stack: List[str] = [method.name]
                self.worker = False

            def visit_With(self, node: ast.With) -> None:
                held = []
                for item in node.items:
                    expr = item.context_expr
                    # with self._lock:  /  with self._lock, self._other:
                    attr = _self_attr(expr)
                    if attr is not None and attr in info.lock_attrs:
                        held.append(attr)
                self.locks.extend(held)
                for child in node.body:
                    self.visit(child)
                for _ in held:
                    self.locks.pop()

            def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                was_worker = self.worker
                if node.name in nested_targets:
                    self.worker = True
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Nonlocal):
                            info.nonlocal_findings.extend(
                                (n, sub.lineno) for n in sub.names)
                self.fn_stack.append(node.name)
                for child in node.body:
                    self.visit(child)
                self.fn_stack.pop()
                self.worker = was_worker

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Attribute(self, node: ast.Attribute) -> None:
                attr = _self_attr(node)
                if attr is not None:
                    init_top = (method.name == "__init__"
                                and len(self.fn_stack) == 1)
                    info.accesses.append(Access(
                        attr, method.name, node.lineno,
                        isinstance(node.ctx, (ast.Store, ast.Del)),
                        frozenset(self.locks),
                        self.worker or method.name in info.thread_targets,
                        init_top))
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call) -> None:
                attr = _self_attr(node.func)
                if attr is not None:
                    calls.add(attr)
                self.generic_visit(node)

        v = V()
        for child in method.body:
            v.visit(child)

    # -- context partition -------------------------------------------------

    def _reach(self, roots: Set[str]) -> Set[str]:
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            m = frontier.pop()
            for callee in self.calls.get(m, ()):
                if callee in self.calls and callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    def contexts(self) -> Tuple[Set[str], Set[str]]:
        """(worker-reachable, caller-reachable) method-name sets."""
        worker = self._reach(self.thread_targets & set(self.calls))
        called_by: Set[str] = set()
        for m, callees in self.calls.items():
            called_by |= callees
        caller_roots = {m for m in self.calls
                        if m not in self.thread_targets
                        and m not in called_by}
        caller = self._reach(caller_roots)
        return worker, caller


def lint_class(info: _ClassInfo, where_prefix: str) -> List[Finding]:
    out: List[Finding] = []
    # -- annotated contract: shared-under --------------------------------
    for attr, (kind, arg) in sorted(info.annotations.items()):
        if kind != "shared-under":
            continue
        locks = {a.strip() for a in arg.split(",") if a.strip()}
        unknown = locks - info.lock_attrs
        if unknown:
            out.append(make_finding(
                "error", "lockset", where_prefix,
                f"{info.name}.{attr}: shared-under names unknown lock(s) "
                f"{sorted(unknown)}; locks declared in __init__: "
                f"{sorted(info.lock_attrs)}"))
            continue
        for acc in info.accesses:
            if acc.attr != attr or acc.init_top:
                continue
            if not locks & acc.locks:
                op = "write" if acc.is_store else "read"
                out.append(make_finding(
                    "error", "lockset", f"{where_prefix}:{acc.lineno}",
                    f"{info.name}.{attr} is declared shared-under"
                    f"({arg}) but this {op} in {acc.method}() holds "
                    f"{sorted(acc.locks) or 'no lock'}"))
    # -- discovery: unannotated cross-thread mutable state ---------------
    worker_m, caller_m = info.contexts()
    # A class is "threaded" when it hands ANY target to Thread(): one of
    # its own methods (worker_m) or a nested closure (accesses carry
    # worker=True but no method name lands in worker_m).
    if worker_m or any(a.worker for a in info.accesses):
        by_attr: Dict[str, List[Access]] = {}
        for acc in info.accesses:
            if not acc.init_top:
                by_attr.setdefault(acc.attr, []).append(acc)
        for attr, accs in sorted(by_attr.items()):
            if (attr in info.annotations or attr in info.safe_attrs
                    or attr in info.lock_attrs):
                continue
            mutated = any(a.is_store for a in accs)
            in_worker = any(a.worker or a.method in worker_m for a in accs)
            in_caller = any(not a.worker and a.method in caller_m
                            for a in accs)
            some_unlocked = any(not a.locks for a in accs)
            if mutated and in_worker and in_caller and some_unlocked:
                lines = sorted({a.lineno for a in accs})
                out.append(make_finding(
                    "error", "lockset", f"{where_prefix}:{lines[0]}",
                    f"{info.name}.{attr} is mutated and reached from "
                    f"both the spawned thread and its caller (lines "
                    f"{lines}) with no lock held and no annotation — a "
                    "data race; guard it (shared-under) or document the "
                    "benign race (unlocked-ok)"))
    for name, lineno in info.nonlocal_findings:
        out.append(make_finding(
            "error", "lockset", f"{where_prefix}:{lineno}",
            f"nonlocal {name!r} inside a Thread target closure — a "
            "shared mutable local no lock can be named for; hoist it "
            "into an attribute with a declared lock"))
    return out


def lint_source(path: str, source: str) -> List[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [make_finding("warning", "lockset", path,
                             f"unparseable: {e}")]
    lines = source.splitlines()
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(lint_class(_ClassInfo(node, lines), path))
    return out


def scan_modules(root: str,
                 modules: Tuple[str, ...] = SCAN_MODULES) -> List[Finding]:
    """Lint the configured threaded modules under the package ``root``."""
    out: List[Finding] = []
    for mod in modules:
        fpath = os.path.join(root, *mod.split("/"))
        if not os.path.exists(fpath):
            out.append(make_finding(
                "warning", "lockset", mod,
                "configured threaded module is missing — update "
                "analysis/lockset.py SCAN_MODULES"))
            continue
        rel = os.path.join(os.path.basename(root), *mod.split("/"))
        with open(fpath, "r", encoding="utf-8") as fh:
            out.extend(lint_source(rel, fh.read()))
    return out
