"""The port's static passes (``ddp_tpu_torch/analysis``) against JAX's
(``ddp_tpu/analysis``): the same sources give the same findings, the
port's own tree scans clean under ``--strict``, every annotation in it
suppresses a finding, and what the port does not run is refused by name.

All of it is AST work in this process: no program is traced or run."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from ddp_tpu.analysis import divergence as jax_divergence
from ddp_tpu.analysis import findings as jax_findings
from ddp_tpu.analysis import fixtures as jax_fixtures
from ddp_tpu.analysis import hostsync as jax_hostsync
from ddp_tpu.analysis import lockset as jax_lockset
from ddp_tpu.analysis.__main__ import run as jax_cli_run
from ddp_tpu_torch.analysis import divergence, findings, hostsync, lockset
from ddp_tpu_torch.analysis.__main__ import run as cli_run
from ddp_tpu_torch.analysis.fixtures import (ERROR_FIXTURES, REFUSED,
                                             run_fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ddp_tpu_torch")
JAX_PKG = os.path.join(ROOT, "ddp_tpu")
_ANNOTATION = re.compile(r"#\s*analysis:\s*(host-sync-ok|unlocked-ok|"
                         r"shared-under|divergence-ok)\(")


def _keys(found):
    return sorted((f.severity, f.check, f.where) for f in found)


# JAX's passes, and the port's with JAX's vocabulary and scope.
def _jax_static(root):
    return (jax_hostsync.scan_packages(root) + jax_lockset.scan_modules(root)
            + jax_divergence.scan_packages(root))


def _port_static_jax_rules(root):
    return (hostsync.scan_packages(root, jax_hostsync.SCAN_PACKAGES,
                                   hostsync.JAX_RULES)
            + lockset.scan_modules(root, lockset.JAX_SCAN_MODULES)
            + divergence.scan_packages(root, jax_divergence.SCAN_PACKAGES,
                                       divergence.JAX_EXCLUDE_BASENAMES,
                                       divergence.JAX_RULES))


def _port_static(root):
    return (hostsync.scan_packages(root) + lockset.scan_modules(root)
            + divergence.scan_packages(root))


# ---------------------------------------------------------------------------
# JAX's sources through both detectors.
# ---------------------------------------------------------------------------

_JAX_FIXTURE_SOURCES = {
    "hot_loop_device_get": (jax_fixtures._HOT_LOOP_DEVICE_GET, "hostsync"),
    "lock_free_shared_attr": (jax_fixtures._LOCK_FREE_SHARED_ATTR,
                              "lockset"),
    "rank_gated_collective": (jax_fixtures._RANK_GATED_COLLECTIVE,
                              "divergence"),
}


def _scan_both(kind, src):
    """(JAX's findings, the port's with JAX's vocabulary, the port's with
    its own) for one source text."""
    path = "t.py"
    if kind == "hostsync":
        return (jax_hostsync.scan_source(path, src),
                hostsync.scan_source(path, src, hostsync.JAX_RULES),
                hostsync.scan_source(path, src))
    if kind == "lockset":
        return (jax_lockset.lint_source(path, src),
                lockset.lint_source(path, src),
                lockset.lint_source(path, src))
    return (jax_divergence.scan_source(path, src),
            divergence.scan_source(path, src, divergence.JAX_RULES),
            divergence.scan_source(path, src))


@pytest.mark.parametrize("name", sorted(_JAX_FIXTURE_SOURCES))
def test_jax_fixture_sources_give_jax_findings(name):
    src, kind = _JAX_FIXTURE_SOURCES[name]
    want, got, _ = _scan_both(kind, src)
    assert want and [f.severity for f in want].count("error") >= 1
    assert _keys(got) == _keys(want)
    # The same findings render as the same table.
    assert findings.format_table(want) == jax_findings.format_table(want)


# JAX's static test cases (tests/test_analysis.py), each through both.
_STATIC_CASES = {
    "hostsync_annotated": ("hostsync",
                           "def f(xs):\n"
                           "    for x in xs:\n"
                           "        # analysis: host-sync-ok(test)\n"
                           "        jax.device_get(x)\n"),
    "hostsync_unannotated": ("hostsync",
                             "def f(xs):\n"
                             "    for x in xs:\n"
                             "        jax.device_get(x)\n"),
    "lockset_contract_broken": (
        "lockset",
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0  # analysis: shared-under(_lock)\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n"
        "    def bad(self):\n"
        "        return self.n\n"),
    "lockset_contract_kept": (
        "lockset",
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0  # analysis: shared-under(_lock)\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n"
        "    def bad(self):\n"
        "        with self._lock:\n"
        "            return self.n\n"),
    "lockset_unknown_lock": (
        "lockset",
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0  # analysis: shared-under(_mutex)\n"),
    "lockset_unlocked_ok": (
        "lockset",
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        # analysis: unlocked-ok(join-synchronized)\n"
        "        self.err = None\n"
        "        t = threading.Thread(target=self._run)\n"
        "    def _run(self):\n"
        "        self.err = 1\n"
        "    def check(self):\n"
        "        return self.err\n"),
    "lockset_nonlocal_closure": (
        "lockset",
        "import threading\n"
        "class C:\n"
        "    def go(self):\n"
        "        done = False\n"
        "        def work():\n"
        "            nonlocal done\n"
        "            done = True\n"
        "        threading.Thread(target=work).start()\n"
        "        return done\n"),
    "divergence_rank_guarded": (
        "divergence",
        "def f(x):\n"
        "    if jax.process_index() == 0:\n"
        "        return lax.psum(x, 'data')\n"
        "    return x\n"),
    "divergence_annotated": (
        "divergence",
        "def f(x):\n"
        "    if jax.process_index() == 0:\n"
        "        # analysis: divergence-ok(test)\n"
        "        return lax.psum(x, 'data')\n"
        "    return x\n"),
    "divergence_uniform_guard": (
        "divergence",
        "def f(x):\n"
        "    multi = jax.process_count() > 1\n"
        "    if multi:\n"
        "        return lax.psum(x, 'data')\n"
        "    return x\n"),
    "divergence_test_position": (
        "divergence",
        "def f(mesh, local):\n"
        "    if _process_any(mesh, local):\n"
        "        return 'stop'\n"
        "    return 'go'\n"),
    "divergence_early_exit": (
        "divergence",
        "def f(x, q):\n"
        "    if q.empty():\n"
        "        return None\n"
        "    return lax.psum(x, 'data')\n"),
    "divergence_except_handler": (
        "divergence",
        "def f(x):\n"
        "    try:\n"
        "        y = load(x)\n"
        "    except OSError:\n"
        "        y = lax.pmax(x, 'data')\n"
        "    return y\n"),
}


@pytest.mark.parametrize("name", sorted(_STATIC_CASES))
def test_jax_static_cases_same_result(name):
    kind, src = _STATIC_CASES[name]
    want, got_jax_rules, got = _scan_both(kind, src)
    assert _keys(got_jax_rules) == _keys(want)
    # JAX's cases hold for the port's vocabulary too.
    assert _keys(got) == _keys(want)
    if kind == "lockset":  # a copy of JAX's: the same sentences too
        assert [f.detail for f in got] == [f.detail for f in want]


@pytest.fixture(scope="module")
def stripped_jax_tree(tmp_path_factory):
    """``ddp_tpu/``'s sources with every ``# analysis:`` comment removed
    (line numbers kept), outside its ``analysis/`` package."""
    root = str(tmp_path_factory.mktemp("stripped") / "ddp_tpu")
    shutil.copytree(JAX_PKG, root, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc"))
    strip = re.compile(r"#\s*analysis:.*$")
    for dirpath, _dirs, files in os.walk(root):
        if dirpath == os.path.join(root, "analysis"):
            continue
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                with open(path, encoding="utf-8") as fh:
                    lines = fh.read().split("\n")
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write("\n".join(strip.sub("", ln) for ln in lines))
    return root


def test_stripped_jax_tree_gives_jax_findings(stripped_jax_tree):
    want = _jax_static(stripped_jax_tree)
    got = _port_static_jax_rules(stripped_jax_tree)
    assert _keys(got) == _keys(want)
    by_check = {c: sum(f.check == c for f in want)
                for c in ("host-sync", "lockset", "divergence")}
    assert by_check == {"host-sync": 2, "lockset": 3, "divergence": 6}
    assert all(f.severity == "error" for f in want)
    assert findings.format_table(want) == jax_findings.format_table(want)
    assert findings.count_by_severity(got) == \
        jax_findings.count_by_severity(want)


def test_stripped_jax_tree_under_the_port_vocabulary(stripped_jax_tree):
    """The port's own tables on JAX's tree: every JAX finding, plus the
    LM loop's per-step ``float(loss)`` after ``step_fn`` (the ``_fn``
    producer), and a warning for each threaded module only the port has."""
    want = set(_keys(_jax_static(stripped_jax_tree)))
    got = set(_keys(_port_static(stripped_jax_tree)))
    assert want <= got
    assert sorted(got - want) == [
        ("error", "host-sync", "ddp_tpu/train/lm.py:228"),
        ("warning", "lockset", "bench.py"),
        ("warning", "lockset", "fleet_load.py"),
        ("warning", "lockset", "serve/model_group.py")]


# ---------------------------------------------------------------------------
# The port's own fixtures and CLI.
# ---------------------------------------------------------------------------

_EXPECTED_CHECK = {"hot_loop_device_get": "host-sync",
                   "lock_free_shared_attr": "lockset",
                   "rank_gated_collective": "divergence"}


@pytest.mark.parametrize("name", sorted(_EXPECTED_CHECK))
def test_port_fixture_is_flagged_and_fails_strict(name):
    errors = [f for f in run_fixture(name) if f.severity == "error"]
    assert errors and all(f.check == _EXPECTED_CHECK[name] for f in errors)
    assert name in ERROR_FIXTURES
    assert cli_run(["--fixture", name, "--strict"], out=_Sink()) == 1
    assert cli_run(["--fixture", name], out=_Sink()) == 0


def test_port_hot_loop_fixture_flags_both_syncs():
    lines = sorted(int(f.where.rsplit(":", 1)[1])
                   for f in run_fixture("hot_loop_device_get"))
    assert lines == [7, 8]  # loss.item() and loss.cpu()


class _Sink:
    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_jax_program_fixtures_refused_by_name(name):
    assert name in jax_fixtures.FIXTURES
    item = "C5" if name in ("captured_constant", "missing_donation",
                            "scalar_closure") else (
        "A13c.3" if name == "budget_buster" else "A13c.2")
    with pytest.raises(SystemExit, match=re.escape(item)):
        cli_run(["--fixture", name, "--strict"], out=_Sink())


@pytest.mark.parametrize("argv,item", [
    (["--skip-programs", "--programs", "train_step@dp8"], "A13c.2"),
    (["--skip-programs", "--model", "deepnn"], "A13c.2"),
    (["--skip-programs", "--mesh-shape", "2,4"], "A13c.2"),
    (["--skip-programs", "--budgets", "BUDGETS.json"], "A13c.3"),
    (["--skip-programs", "--write-budgets"], "A13c.3"),
    (["--strict"], "A13c.2"),
    (["--skip-static"], "A13c.2"),
])
def test_program_flags_and_default_run_refused_by_name(argv, item):
    with pytest.raises(SystemExit, match=re.escape(item)):
        cli_run(argv, out=_Sink())


def test_port_tree_strict_clean_with_jax_artifact_keys(tmp_path):
    art = tmp_path / "a.json"
    sink = _Sink()
    assert cli_run(["--skip-programs", "--strict", "--json", str(art)],
                   out=sink) == 0, sink.text
    assert "no findings" in sink.text
    data = json.loads(art.read_text())
    jax_art = tmp_path / "jax.json"
    assert jax_cli_run(["--skip-programs", "--json", str(jax_art)],
                       out=_Sink()) == 0
    assert set(data) == set(json.loads(jax_art.read_text()))
    assert data["counts"] == {"error": 0, "warning": 0, "info": 0}
    assert data["inventories"] == {} and data["cost_table"] == {}
    assert _port_static(PORT) == []


def test_cli_list_names_fixtures_and_refusals():
    sink = _Sink()
    assert cli_run(["--list"], out=sink) == 0
    for name in list(_EXPECTED_CHECK) + list(REFUSED):
        assert name in sink.text
    assert "A13c.2" in sink.text


# ---------------------------------------------------------------------------
# The port's annotations, and the lockset scan's coverage.
# ---------------------------------------------------------------------------

def _port_annotations():
    """(relative path, 1-based line, kind) of every annotation in the
    port's tree outside the analysis package (whose docstrings name the
    vocabulary)."""
    out = []
    for dirpath, _dirs, files in os.walk(PORT):
        if os.path.basename(dirpath) in ("analysis", "__pycache__"):
            continue
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    m = _ANNOTATION.search(line)
                    if m:
                        out.append((os.path.relpath(path, ROOT), i,
                                    m.group(1)))
    return out


_PORT_ANNOTATIONS = _port_annotations()


def test_port_tree_carries_annotations():
    kinds = {k for _, _, k in _PORT_ANNOTATIONS}
    assert {"host-sync-ok", "unlocked-ok", "divergence-ok"} <= kinds
    assert len(_PORT_ANNOTATIONS) >= 17


def _scan_one(rel, source):
    return (hostsync.scan_source(rel, source)
            + lockset.lint_source(rel, source)
            + divergence.scan_source(rel, source))


@pytest.mark.parametrize("rel,line,kind", _PORT_ANNOTATIONS,
                         ids=[f"{r}:{n}" for r, n, _ in _PORT_ANNOTATIONS])
def test_every_port_annotation_suppresses_a_finding(rel, line, kind):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
        lines = fh.read().split("\n")
    before = _scan_one(rel, "\n".join(lines))
    assert [f for f in before if f.severity == "error"] == []
    lines[line - 1] = re.sub(r"#\s*analysis:.*$", "", lines[line - 1])
    after = [f for f in _scan_one(rel, "\n".join(lines))
             if f.severity == "error"]
    check = {"host-sync-ok": "host-sync", "divergence-ok": "divergence"
             }.get(kind, "lockset")
    assert any(f.check == check for f in after), (
        f"{rel}:{line}: the {kind} annotation suppresses nothing")


def _thread_constructors():
    """Port modules (relative to the package) that call
    ``threading.Thread(...)`` or ``Thread(...)``."""
    out = set()
    for dirpath, _dirs, files in os.walk(PORT):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and (
                        (isinstance(node.func, ast.Attribute)
                         and node.func.attr == "Thread")
                        or (isinstance(node.func, ast.Name)
                            and node.func.id == "Thread")):
                    out.add(os.path.relpath(path, PORT).replace(os.sep, "/"))
    return out


def test_lockset_scans_every_thread_constructor():
    constructors = _thread_constructors()
    assert len(constructors) >= 14
    assert constructors <= set(lockset.SCAN_MODULES), sorted(
        constructors - set(lockset.SCAN_MODULES))
    assert set(jax_lockset.SCAN_MODULES) <= set(lockset.SCAN_MODULES)
    # Every configured module exists: no "missing" warning on the port.
    assert lockset.scan_modules(PORT) == []


def test_vocabulary_tables():
    """JAX's tables are JAX's; the port's extend them, keep rank reads
    non-uniform and point-to-point out of the collectives."""
    assert divergence.JAX_RULES.collective_calls == \
        jax_divergence.COLLECTIVE_CALLS
    assert divergence.JAX_RULES.uniform_calls == jax_divergence.UNIFORM_CALLS
    assert divergence.JAX_EXCLUDE_BASENAMES == \
        jax_divergence.EXCLUDE_BASENAMES
    assert divergence.EXCLUDE_BASENAMES == ()
    assert divergence.JAX_RULES.collective_calls < \
        divergence.COLLECTIVE_CALLS
    for name in ("send_stage", "recv_stage", "send", "recv", "isend",
                 "irecv"):
        assert name not in divergence.COLLECTIVE_CALLS
    for name in ("get_rank", "rank", "data_rank", "stage_index"):
        assert name not in divergence.UNIFORM_CALLS
    assert hostsync.JAX_RULES.producer_suffixes == \
        jax_hostsync.DEVICE_PRODUCER_SUFFIXES
    assert hostsync.SCAN_PACKAGES == jax_hostsync.SCAN_PACKAGES + (
        "parallel",)
    # The port's step loops' producers and syncs.
    src = ("def f(eng, xs, ev):\n"
           "    for x in xs:\n"
           "        out = eng.decode(x)\n"
           "        a = bool(out)\n"
           "        b = out.argmax(-1).tolist()\n"
           "        c = out.to('cpu')\n"
           "        d = float(eng.train_step(x))\n"
           "        ev.synchronize()\n"
           "        torch.cuda.synchronize()\n"
           "        e = x.item()\n")
    lines = sorted(int(f.where.rsplit(":", 1)[1])
                   for f in hostsync.scan_source("t.py", src))
    assert lines == [4, 5, 6, 7, 8, 9]  # x.item(): x is not a step's
    assert hostsync.scan_source("t.py", src, hostsync.JAX_RULES) == []
    div = ("def f(t):\n"
           "    if dist.get_rank() == 0:\n"
           "        dist.send_stage(t, 1)\n"
           "    if dist.world_size() > 1:\n"
           "        dist.all_reduce_sum_(t)\n"
           "    if dist.data_rank() == 0:\n"
           "        dist.barrier()\n")
    assert [f.where for f in divergence.scan_source("t.py", div)] == \
        ["t.py:7"]
