"""AST pass for device-to-host syncs inside step/epoch loops (the
counterpart of ``ddp_tpu/analysis/hostsync.py``).

CUDA launches are asynchronous: the host loop stays ahead of the card
exactly as long as nothing in the loop body waits for it.  One
``loss.item()`` (or a ``float()`` of a device scalar, a ``.cpu()`` of a
step's output, an explicit ``torch.cuda.synchronize()``) inside the hot
loop serializes every iteration on the previous step's completion, the
classic silent 2x.  This pass walks ``train/``, ``data/``, ``serve/`` and
``parallel/`` (the pipeline schedule and the drills are host loops too)
and flags, inside any ``for``/``while`` body:

- a call that always waits for the device: JAX's ``jax.device_get``, and
  in the port ``torch.cuda.synchronize()`` and ``Stream.synchronize()`` /
  ``Event.synchronize()``;
- ``float(x)`` / ``int(x)`` / ``bool(x)`` / ``np.asarray(x)`` /
  ``np.array(x)`` where ``x`` was assigned IN THE SAME LOOP BODY from a
  call whose name ends in one of the step producers (``step``,
  ``forward``, ...), the device-value dataflow the pass can prove
  statically (``loss = self.train_step(...)``) without drowning the
  report in false positives on host values;
- in the port, ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()``
  and ``x.to("cpu")`` on such a name (or an expression rooted at one:
  ``logits.argmax(-1).cpu()``).

The vocabulary is a table (:class:`Vocabulary`) the scanners take as an
argument: :data:`JAX_RULES` is JAX's pass unchanged (the parity tests run
it on JAX's own sources), and :data:`TORCH_RULES`, the default, extends it
to the port's device-to-host syncs.

Deliberate syncs (an epoch-boundary flush, a d2h span in the serve
pipeline) carry the annotation ``# analysis: host-sync-ok(<reason>)`` on
the statement line or the line above; the annotation is the audit trail
that someone DECIDED the sync is off the hot path.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, NamedTuple, Tuple

from .findings import Finding, make_finding

SCAN_PACKAGES = ("train", "data", "serve", "parallel")


class Vocabulary(NamedTuple):
    """What the pass counts as a device value and as a sync."""
    # Last name component of a call whose assigned names are device
    # values (``state, loss = self.train_step(...)``).
    producer_suffixes: Tuple[str, ...]
    # Dotted-name suffixes of calls that always wait for the device.
    sync_calls: Tuple[str, ...]
    # ``f(x)`` casts of a device name, matched on the whole dotted name.
    cast_names: Tuple[str, ...]
    # ``...suffix(x)`` casts of a device name (``np.asarray(x)``).
    cast_suffixes: Tuple[str, ...]
    # ``x.<method>()`` transfers whose receiver is rooted at a device name.
    methods: Tuple[str, ...]
    # ``x.to("cpu")`` / ``x.to(device="cpu")`` on a device name.
    to_cpu: bool
    # A cast or transfer may read any expression rooted at a device name
    # or at a producer's call (``float(step_fn(...))``, ``loss[0].item()``);
    # JAX's rule reads a bare name only.
    rooted: bool


JAX_RULES = Vocabulary(
    producer_suffixes=("step", "forward", "apply", "fwd"),
    sync_calls=("device_get",),
    cast_names=("float", "int"),
    cast_suffixes=(".item", "np.asarray", "np.array", "numpy.asarray",
                   "numpy.array"),
    methods=(),
    to_cpu=False,
    rooted=False)

# The port's step producers whose names JAX's suffixes miss: the decode
# and prefill programs of the KV engine, a captured graph's replay, the
# pipeline's stage forward/backward, and the epoch bodies.
TORCH_RULES = JAX_RULES._replace(
    producer_suffixes=JAX_RULES.producer_suffixes + (
        "decode", "prefill", "replay", "backward", "epoch", "_fn"),
    sync_calls=JAX_RULES.sync_calls + ("synchronize",),
    cast_names=JAX_RULES.cast_names + ("bool",),
    methods=("item", "tolist", "cpu", "numpy"),
    to_cpu=True,
    rooted=True)

# Kept under JAX's name: the producers the default (port) rules use.
DEVICE_PRODUCER_SUFFIXES = TORCH_RULES.producer_suffixes

_OK_RE = re.compile(r"#\s*analysis:\s*host-sync-ok\(([^)]*)\)")


def _annotated_ok(lines: List[str], lineno: int) -> bool:
    """True when line ``lineno`` (1-based) or the line above carries the
    host-sync-ok annotation."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and _OK_RE.search(lines[ln - 1]):
            return True
    return False


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target, '' when not a plain name/attr."""
    parts: List[str] = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _is_producer(node: ast.Call, rules: Vocabulary) -> bool:
    last = _call_name(node).rsplit(".", 1)[-1]
    return last.endswith(rules.producer_suffixes)


def _device_root(node: ast.AST, device_names: set,
                 rules: Vocabulary) -> str:
    """The device value ``node`` reads: a device name (with
    ``rules.rooted``, also the name or producer call an expression such as
    ``x.a[0].b()`` is rooted at), else ''."""
    while True:
        if isinstance(node, ast.Name):
            return node.id if node.id in device_names else ""
        if not rules.rooted:
            return ""
        if isinstance(node, ast.Call) and _is_producer(node, rules):
            return _call_name(node) + "()"
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return ""


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and _call_name(node).endswith("device")
            and len(node.args) == 1 and _is_cpu(node.args[0]))


def _to_cpu(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr == "to"):
        return False
    return (any(_is_cpu(a) for a in node.args[:1])
            or any(k.arg == "device" and _is_cpu(k.value)
                   for k in node.keywords))


def _assigned_names(node: ast.AST) -> Iterator[str]:
    for t in ast.walk(node):
        if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
            yield t.id


def _loops(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While)):
            yield node


def _device_names_in_loop(loop: ast.AST, rules: Vocabulary) -> set:
    """Names assigned inside this loop body from a device-producing call
    (``state, loss = self.train_step(...)``)."""
    names: set = set()
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if _is_producer(node.value, rules):
                for tgt in node.targets:
                    names.update(_assigned_names(tgt))
    return names


def _transfer(node: ast.Call, device_names: set,
              rules: Vocabulary) -> str:
    """The device name a ``.item()``-style transfer reads, else ''."""
    if not isinstance(node.func, ast.Attribute):
        return ""
    if not ((node.func.attr in rules.methods and not node.args)
            or (rules.to_cpu and _to_cpu(node))):
        return ""
    return _device_root(node.func.value, device_names, rules)


def scan_source(path: str, source: str,
                rules: Vocabulary = TORCH_RULES) -> List[Finding]:
    """Host-sync findings for one module's source text."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [make_finding("warning", "host-sync", path,
                             f"unparseable: {e}")]
    lines = source.splitlines()
    out: List[Finding] = []
    seen: set = set()
    for loop in _loops(tree):
        device_names = _device_names_in_loop(loop, rules)
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call) or node.lineno in seen:
                continue
            name = _call_name(node)
            where = f"{path}:{node.lineno}"
            if name.endswith(rules.sync_calls):
                if not _annotated_ok(lines, node.lineno):
                    seen.add(node.lineno)
                    out.append(make_finding(
                        "error", "host-sync", where,
                        f"{name}() inside a loop — a device->host sync "
                        "per iteration serializes the step loop on device "
                        "completion; hoist it past the loop (or annotate "
                        "'# analysis: host-sync-ok(reason)' if it is "
                        "deliberately off the hot path)"))
            elif ((name in rules.cast_names
                   or name.endswith(rules.cast_suffixes)) and node.args):
                root = _device_root(node.args[0], device_names, rules)
                if root and not _annotated_ok(lines, node.lineno):
                    seen.add(node.lineno)
                    out.append(make_finding(
                        "error", "host-sync", where,
                        f"{name}({root}) inside a loop, on a value "
                        "produced by a jitted step/forward in the same "
                        "loop body — an implicit per-iteration device "
                        "sync; keep it on device (append the raw value) "
                        "and read the batch once after the loop"))
            else:
                root = _transfer(node, device_names, rules)
                if root and not _annotated_ok(lines, node.lineno):
                    seen.add(node.lineno)
                    out.append(make_finding(
                        "error", "host-sync", where,
                        f".{node.func.attr}() of {root} inside a loop, on "
                        "a value a step/forward produced in the same loop "
                        "body — a per-iteration device->host copy that "
                        "waits for the step; keep it on the device and "
                        "read the batch once after the loop"))
    return out


def scan_packages(root: str,
                  packages: Tuple[str, ...] = SCAN_PACKAGES,
                  rules: Vocabulary = TORCH_RULES) -> List[Finding]:
    """Walk the given subpackages of the package root."""
    out: List[Finding] = []
    for pkg in packages:
        pkg_dir = os.path.join(root, pkg)
        if not os.path.isdir(pkg_dir):
            continue
        for dirpath, _dirs, files in sorted(os.walk(pkg_dir)):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, os.path.dirname(root))
                with open(fpath, "r", encoding="utf-8") as fh:
                    out.extend(scan_source(rel, fh.read(), rules))
    return out
