"""The bench's modes that need no mesh, on the CPU at tiny sizes: each
record's fields held to ``bench.py``'s (plus ``device`` and
``power_limit_w``), ``attribute_streaming`` and ``bench_trend`` against the
JAX package's and ``tools/``' on the same inputs, ``fleet_load`` against
``python -m ddp_tpu_torch.serve --fleet 2``, ``--sweep`` over gloo ranks,
``--chaos``'s delegation, and the refusals."""
import ast
import importlib.util
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddp_tpu.utils.profiling import attribute_streaming as jax_attribute
from ddp_tpu_torch import bench, bench_trend, fleet_load
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.train.checkpoint import save_checkpoint
from ddp_tpu_torch.train.step import init_train_state
from ddp_tpu_torch.utils.profiling import attribute_streaming

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "deepnn", "--batch_size", "8",
        "--steps", "2", "--warmup", "1", "--repeats", "2"]
PORT_FIELDS = {"device", "power_limit_w"}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The ranks and children this file starts, and the modes it runs in
    # process, share the box's cores with the other test workers.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _line(capsys) -> dict:
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _jax_record(func: str) -> ast.Dict:
    """The dict literal that ``bench.py``'s ``func`` prints with
    ``json.dumps``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return next(n.args[0] for n in ast.walk(fn)
                if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
                == "dumps" and n.args and isinstance(n.args[0], ast.Dict))


def _keys(d: ast.Dict) -> set:
    return {k.value for k in d.keys}


def _nested(d: ast.Dict, key: str) -> ast.Dict:
    return next(v for k, v in zip(d.keys, d.values) if k.value == key)


# -- the records, held to bench.py's -----------------------------------------

@pytest.mark.parametrize("fleet", [1, 2])
def test_serve_record_has_jax_fields(capsys, fleet):
    summary = bench.main(TINY + ["--serve", "--fleet", str(fleet),
                                 "--serve_secs", "0.3",
                                 "--serve_buckets", "1,8"])
    rec = _line(capsys)
    jax_rec = _jax_record("_bench_serve")
    assert set(rec) == _keys(jax_rec) | PORT_FIELDS
    assert set(rec["serve"]) == _keys(_nested(jax_rec, "serve"))
    serve = rec["serve"]
    assert rec["metric"] == (f"deepnn serve latency/throughput vs offered "
                             f"load (fleet of {fleet}, batch buckets [1, 8], "
                             f"1 row(s)/request, fp32, 1 chip(s), max_wait "
                             f"5.0 ms)")
    assert serve["fleet"] == fleet and serve["bucket_set_size"] == 2
    assert serve["compiled_executables"] == 2 * fleet
    assert serve["closed_loop"]["timed_out"] == 0
    assert serve["closed_loop"]["requests"] > 0
    assert len(serve["open_loop"]) == 5  # auto: 0.4/0.7/1.0/1.5/2.25x
    assert all(p["timed_out"] == 0 for p in serve["open_loop"])
    assert (serve["router"] is None) == (fleet == 1)
    if fleet > 1:
        assert serve["router"]["replicas"] == 2
    assert serve["engine"]["compiled_executables"] == 2
    assert rec["value"] > 0
    assert rec["device"] == {"name": "cpu", "count": 1}
    # The CPU runs the plain version: no launch, no eval-form call.
    assert summary["launches"]["gather_batch"] == 0
    assert summary["eval_calls"] == {"float32": 0, "bfloat16": 0}


def test_guard_overhead_record_has_jax_fields(capsys):
    import jax

    from ddp_tpu.models import get_model as jax_model
    summary = bench.main(TINY + ["--guard_overhead"])
    rec = _line(capsys)
    assert set(rec) == _keys(_jax_record("_bench_guard_overhead")) | \
        PORT_FIELDS
    per = rec["guard_overhead"]
    # bench.py:2041-2067: the four configs, each's windows, and the
    # overhead of the three against audit_off.
    assert list(per) == ["audit_off", "audit_k50", "audit_k10", "guard_on"]
    window_keys = {"median_ms_per_step", "best_window_ms_per_step",
                   "window_ms_per_step"}
    assert set(per["audit_off"]) == window_keys
    for k in ("audit_k50", "audit_k10", "guard_on"):
        assert set(per[k]) == window_keys | {"overhead_pct_vs_off"}
        assert len(per[k]["window_ms_per_step"]) == 2
    assert set(rec["derived_audit_overhead_pct"]) == {"k50", "k10"}
    assert rec["value"] == rec["derived_audit_overhead_pct"]["k50"] > 0
    assert rec["derived_audit_overhead_pct"]["k10"] == pytest.approx(
        5 * rec["value"], rel=1e-3)
    # The audit fingerprints the same leaves as JAX's.
    params, _ = jax_model("deepnn").init(jax.random.key(0))
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert rec["audit_n_leaves"] == n_leaves
    assert rec["audit_payload_bytes"] == 2 * n_leaves * 8  # world 1, int64
    # 1 warm-up step, then 4 configs x 2 windows x 2 steps.
    assert summary["steps"] == {"float32": 1 + 4 * 2 * 2, "bfloat16": 0}


def test_batch_sweep_record_has_jax_fields(capsys):
    summary = bench.main(TINY + ["--batch_sweep", "8",
                                 "--batch_sweep_flavors", "fp32_step"])
    rec = _line(capsys)
    # The child's steps (1 warm-up + 2 windows of 2) reach the summary.
    assert summary["steps"] == {"float32": 5, "bfloat16": 0}
    # The keys bench.py's own contract tests assert for this mode.
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "batch_sweep"} | PORT_FIELDS
    assert set(rec["batch_sweep"]) == {"8"}
    cell = rec["batch_sweep"]["8"]["fp32_step"]
    assert set(cell) == {"samples_per_sec_per_chip", "median_ms_per_step",
                         "best_window_ms_per_step", "window_spread_pct",
                         "mfu"}
    assert cell["samples_per_sec_per_chip"] > 0
    assert cell["best_window_ms_per_step"] <= cell["median_ms_per_step"]
    assert rec["value"] == cell["mfu"] > 0
    assert rec["unit"] == "peak mfu over sweep (at batch 8, fp32_step)"


def test_stream_attr_record_has_jax_fields(capsys):
    summary = bench.main(TINY + ["--stream_attr", "--e2e_steps", "4"])
    rec = _line(capsys)
    assert set(rec) == _keys(_jax_record("_bench_stream_attr")) | \
        PORT_FIELDS
    # The keys bench.py's own contract tests assert for this mode.
    attr = rec["attribution_ms_per_step"]
    assert set(attr) == {"host_augment_ms", "h2d_ms", "device_step_ms",
                         "streaming_wall_ms", "bottleneck",
                         "pipeline_floor_ms", "dispatch_gap_ms",
                         "overlap_efficiency"}
    assert attr["pipeline_floor_ms"] == max(
        attr["host_augment_ms"], attr["h2d_ms"], attr["device_step_ms"])
    assert attr["bottleneck"] in ("host_augment_ms", "h2d_ms",
                                  "device_step_ms")
    assert 0 < rec["value"] == attr["overlap_efficiency"] <= 1
    pf = rec["prefetch"]
    assert pf["depth"] == 2 and pf["workers"] == 4
    assert pf["batches"] == 4 * 2  # e2e_steps x timed repeats
    # The streamed --e2e record's phases.
    assert set(rec["phase_ms"]) == {"data_wait", "dispatch", "h2d",
                                    "host_augment", "loss_flush"}
    assert len(rec["window_epoch_s"]) == 2
    # The step alone: 1 warm-up + 2 x 4; the Trainer: (2 + 2) x 4.
    assert summary["steps"]["float32"] == 1 + 2 * 4 + 4 * 4


def test_pipeline_record_matches_jax_run(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "bench.py", "--pipeline",
                          "--batch_size", "8"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_rec = json.loads(out.stdout.strip().splitlines()[-1])
    bench.main(["--device", "cpu", "--pipeline", "--batch_size", "8"])
    rec = _line(capsys)
    assert set(rec) == set(jax_rec) | PORT_FIELDS
    for k in ("metric", "unit", "vs_baseline"):
        assert rec[k] == jax_rec[k]
    assert rec["value"] > 0


def test_sweep_over_gloo_ranks(capsys):
    summary = bench.main(["--device", "cpu", "--model", "deepnn",
                          "--batch_size", "8", "--steps", "1", "--warmup",
                          "1", "--repeats", "1", "--sweep", "1,2",
                          "--sweep_platform", "cpu"])
    rec = _line(capsys)
    # Each child's rank 0 ran 1 warm-up step and 1 timed one.
    assert summary["steps"] == {"float32": 4, "bfloat16": 0}
    jax_rec = _jax_record("_bench_sweep")
    assert set(rec) == _keys(jax_rec) | PORT_FIELDS
    assert rec["metric"] == ("deepnn DP scaling sweep (cpu mesh, batch "
                             "8/chip, devices [1, 2])")
    per = rec["samples_per_sec_per_chip"]
    assert set(per) == {"1", "2"} and all(v > 0 for v in per.values())
    assert rec["value"] == round(per["2"] / per["1"], 4)
    assert rec["device"] == {"name": "cpu", "count": 2}


# -- the port's tools against the JAX package's and tools/' -------------------

ATTR_CASES = {
    "seeded": tuple(np.random.default_rng(0).uniform(0.1, 60.0, 4)),
    "host_bound": (12.5, 0.4, 3.0, 14.0),
    "h2d_bound": (0.2, 9.0, 3.0, 9.5),
    "wall_below_floor": (1.0, 2.0, 57.0, 55.5),
    "wall_zero": (1.0, 2.0, 3.0, 0.0),
}


@pytest.mark.parametrize("case", list(ATTR_CASES))
def test_attribute_streaming_equals_jax(case):
    args = [float(x) for x in ATTR_CASES[case]]
    assert attribute_streaming(*args) == jax_attribute(*args)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trend_case(case: str, tmp_path) -> tuple:
    """(working directory, argv) of one comparison."""
    if case == "repo_history":
        return ROOT, ["--glob", "BENCH_*.json", "--threshold", "10"]
    # tests/test_supervisor.py's chaos-file case: a scorecard beside a
    # record, under a glob that covers both.
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"parsed": {"metric": "train throughput (cpu)",
                    "value": 100.0, "unit": "samples/sec"}}))
    (tmp_path / "CHAOS_r01.json").write_text(json.dumps(
        {"schema": "chaos_campaign/1", "verdict": "PASS",
         "drills": {"sigterm_step": {"pass": True}}}))
    return str(tmp_path), ["--glob", "*_r*.json"]


@pytest.mark.parametrize("case", ["repo_history", "chaos_file"])
@pytest.mark.parametrize("strict", [False, True])
def test_bench_trend_equals_tools(case, strict, tmp_path, monkeypatch,
                                  capsys):
    cwd, argv = _trend_case(case, tmp_path)
    argv += ["--strict"] if strict else []
    monkeypatch.chdir(cwd)
    got = {}
    for name, mod in (("jax", _load_tool("bench_trend")),
                      ("port", bench_trend)):
        out = str(tmp_path / f"trend_{name}.json")
        rc = mod.main(argv + ["--out", out])
        std = capsys.readouterr()
        got[name] = (rc, std.out, std.err.replace(out, "OUT"),
                     json.loads(open(out).read()))
    assert got["port"] == got["jax"]
    if case == "chaos_file":
        assert "ignoring 1 non-bench artifact(s)" in got["port"][2]


def _cli_flags(path):
    """Each ``add_argument`` call of the module at ``path``: its flag and
    its keywords, as source."""
    tree = ast.parse(open(path).read())
    return sorted(
        (call.args[0].value, tuple(sorted(
            (k.arg, ast.unparse(k.value)) for k in call.keywords)))
        for call in ast.walk(tree)
        if isinstance(call, ast.Call)
        and getattr(call.func, "attr", None) == "add_argument")


@pytest.mark.parametrize("tool,port", [("ci_fleet_load", fleet_load),
                                       ("bench_trend", bench_trend)])
def test_tool_copy_keeps_the_tools_flags(tool, port):
    # The port's copies track tools/: the same flags, defaults and help.
    want = _cli_flags(os.path.join(ROOT, "tools", f"{tool}.py"))
    assert want and _cli_flags(port.__file__) == want


def test_fleet_load_against_the_fleet_cli(tmp_path):
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, model, init_train_state(model).momentum, 0, 0)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--model", "deepnn", "--fleet", "2", "--port", "0",
         "--buckets", "1,8", "--snapshot_path", ck, "--trace_spill", ""],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving deepnn fleet of 2 on http://" in line, line
        base = line.split(" on ")[1].split(" ")[0].rstrip("/")
        ledger = tmp_path / "fleet_load.json"
        out = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.fleet_load", "--base",
             base, "--secs", "1.5", "--conc", "2", "--out", str(ledger)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (out.stdout, out.stderr)
        counts = json.loads(ledger.read_text())
        assert counts["failed"] == 0 and counts["ok"] > 0
        assert f"fleet load: {counts}" in out.stdout
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_fleet_load_fails_when_nothing_answers(tmp_path):
    ledger = tmp_path / "fleet_load.json"
    # A port nothing listens on: every request is a transport error.
    assert fleet_load.main(["--base", "http://127.0.0.1:9", "--secs", "0.2",
                            "--conc", "1", "--out", str(ledger)]) == 1
    counts = json.loads(ledger.read_text())
    assert counts["failed"] > 0 and counts["ok"] == 0


# -- --chaos delegates to the campaign ----------------------------------------

@pytest.mark.parametrize("rc", [0, 3])
def test_chaos_runs_the_campaign_and_passes_its_code_on(monkeypatch, rc):
    calls = []

    def call(cmd):
        calls.append(cmd)
        return rc

    monkeypatch.setattr(bench.subprocess, "call", call)
    argv = ["--device", "cpu", "--chaos", "--chaos_out", "C.json",
            "--chaos_drills", "sigterm_step,watchdog_stall"]
    if rc:
        with pytest.raises(SystemExit) as e:
            bench.main(argv)
        assert e.value.code == rc
    else:
        assert bench.main(argv) == {"records": []}
    assert calls == [[sys.executable, "-m", "ddp_tpu_torch.chaos_campaign",
                      "--out", "C.json", "--device", "cpu",
                      "--drills", "sigterm_step,watchdog_stall"]]


def test_chaos_default_scorecard_and_matrix(monkeypatch):
    calls = []
    monkeypatch.setattr(bench.subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    bench.main(["--device", "cpu", "--chaos"])
    assert calls == [[sys.executable, "-m", "ddp_tpu_torch.chaos_campaign",
                      "--out", "CHAOS_r01.json", "--device", "cpu"]]


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("flavor", ["fp32_scan", "bf16_scan"])
def test_scan_flavours_refused(flavor):
    with pytest.raises(SystemExit, match=f"{flavor}: no eager counterpart"):
        bench.main(TINY + ["--batch_sweep", "8",
                           "--batch_sweep_flavors", f"fp32_step,{flavor}"])


@pytest.mark.parametrize("argv", [
    ["--sweep", "1,2", "--sweep_platform", "real"],
    ["--sweep", "1,2"],
    ["--num_devices", "2"],
    ["--e2e", "--num_devices", "3"],
], ids=["sweep_real", "sweep_on_the_card", "num_devices", "e2e_num_devices"])
def test_more_ranks_than_cards_refused(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="more ranks than the 1 visible "
                                         "card"):
        bench.main(argv)


@pytest.mark.parametrize("argv,card", [
    (["--device", "cpu", "--sweep_platform", "real"], False),
    (["--sweep_platform", "cpu"], True),
], ids=["real_on_the_cpu", "cpu_on_the_card"])
def test_sweep_platform_contradicting_device_refused(monkeypatch, argv,
                                                     card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(card))
    with pytest.raises(SystemExit, match="contradicts --device"):
        bench.main(["--sweep", "1,2", *argv])


def test_sweep_children_run_on_the_bench_device(monkeypatch, capsys):
    children = []

    def child(argv, env, what, _bench):
        children.append(argv)
        return {"value": 1.0}

    monkeypatch.setattr(bench, "run_child", child)
    bench.main(TINY + ["--sweep", "1,2"])
    rec = _line(capsys)
    assert [c[c.index("--device") + 1] for c in children] == ["cpu", "cpu"]
    assert rec["metric"].startswith("deepnn DP scaling sweep (cpu mesh,")


@pytest.mark.parametrize("mode", ["--serve", "--stream_attr",
                                  "--inspect_overhead"])
def test_num_devices_refused_for_one_device_modes(mode):
    with pytest.raises(SystemExit, match=f"--num_devices 2 with {mode}"):
        bench.main(TINY + [mode, "--num_devices", "2"])


@pytest.mark.parametrize("argv", [
    ["--guard_overhead"], ["--serve"], ["--serve", "--fleet", "2"],
    ["--batch_sweep", "8"], ["--sweep", "1,2"], ["--pipeline"],
    ["--stream_attr"], ["--chaos"], ["--num_devices", "2"]],
    ids=lambda a: "_".join(x.strip("-") for x in a))
def test_every_mode_needs_a_card_or_device_cpu(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench.subprocess, "call", lambda cmd: 0)
    with pytest.raises(NoCardError, match="--device cpu"):
        bench.main(argv)
