"""The port's live introspection plane (``ddp_tpu_torch/obs/inspect.py``)
against ``ddp_tpu.obs.inspect``: the ``.prom`` rewrite read by JAX's strict
parser and never torn, the profile trigger's captures, SIGUSR1, the HTTP
endpoints mid-run on the CPU, ``--obs_off`` and no port binding nothing,
and the watchdog's stall line naming the last spans."""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from ddp_tpu.obs.inspect import ProfileTrigger as JProfileTrigger
from ddp_tpu.obs.registry import parse_exposition as jparse_exposition
from ddp_tpu.obs.tracer import SpanTracer as JSpanTracer
from ddp_tpu_torch import cli
from ddp_tpu_torch.obs import inspect as inspect_mod
from ddp_tpu_torch.obs.inspect import (InspectServer, ProfileTrigger,
                                       PromFileWriter, install_sigusr1)
from ddp_tpu_torch.obs.registry import MetricsRegistry
from ddp_tpu_torch.obs.tracer import NullTracer, SpanTracer
from ddp_tpu_torch.resilience.watchdog import (WATCHDOG_EXIT_STATUS,
                                               Watchdog)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
_ARGS = ["2", "1", "--batch_size", "8", "--synthetic", "--synthetic_size",
         "64", "--model", "deepnn", "--lr", "0.02", "--device", "cpu",
         "--metrics_path", "m.jsonl", "--log_every", "2"]
HEALTH_KEYS = {"step", "epoch", "guard_last_decision", "guard_restores",
               "drift_last_audit_step", "mirror_lag_epochs",
               "watchdog_last_beat_age_s", "watchdog_timeout_s", "prefetch"}


def _get(port: int, path: str, timeout: float = 5.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_prom_rewrite_never_torn(tmp_path):
    """Readers racing the rewrite: every read parses under JAX's strict
    parser (``os.replace``: the previous complete exposition or the new
    one, never a prefix)."""
    registry = MetricsRegistry()
    n = registry.counter("ddp_test_total", "padded out so the exposition "
                         "spans several write() calls")
    n.inc()
    path = str(tmp_path / "m.prom")
    writer = PromFileWriter(registry, path, every=1)
    writer.write()
    stop = threading.Event()
    torn: list = []

    def _reader():
        while not stop.is_set():
            try:
                text = open(path).read()
            except FileNotFoundError:
                continue
            try:
                assert "ddp_test_total" in jparse_exposition(text)
            except Exception as e:  # noqa: BLE001
                torn.append((repr(e), text[-80:]))
                return

    threads = [threading.Thread(target=_reader) for _ in range(3)]
    for t in threads:
        t.start()
    for step in range(1, 400):
        n.inc()
        writer.step(step)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not torn, torn[:1]
    fams = jparse_exposition(open(path).read())
    assert fams["ddp_test_total"]["samples"][("ddp_test_total", ())] == 400


def test_prom_writer_cadence_and_dead_path(tmp_path, capsys):
    registry = MetricsRegistry()
    registry.counter("ddp_x_total", "")
    path = str(tmp_path / "cadence.prom")
    writer = PromFileWriter(registry, path, every=10)
    writer.step(3)  # the first call always writes
    assert os.path.exists(path)
    mtime = os.path.getmtime(path)
    writer.step(5)  # the same cadence window: no rewrite
    assert os.path.getmtime(path) == mtime
    writer.step(12)
    assert writer._last_written == 12
    bad = PromFileWriter(registry, str(tmp_path / "no_dir" / "x.prom"),
                         every=1)
    bad.step(1)
    bad.step(2)
    assert capsys.readouterr().err.count("WARNING") == 1  # once, then dead


def test_profile_trigger_captures_as_jax(tmp_path):
    """The same request and step sequence give JAX's capture: its window,
    schema and span steps; one capture at a time; the null tracer gives an
    empty one."""
    docs = []
    for name, trig_cls, tr_cls in (("port", ProfileTrigger, SpanTracer),
                                   ("jax", JProfileTrigger, JSpanTracer)):
        d = tmp_path / name
        d.mkdir()
        tracer = tr_cls()
        trig = trig_cls(tracer, str(d), profiler_available=False)
        trig.request(3)
        trig.request(9)  # ignored: a capture is pending
        for step in range(5, 12):
            with tracer.span("dispatch", step=step):
                pass
            trig.step(step)
        assert not trig.armed and len(trig.captures) == 1
        doc = json.load(open(trig.captures[0]))
        docs.append({k: (v if k != "spans" else [s["step"] for s in v])
                     for k, v in doc.items()})
    assert docs[0] == docs[1] == {
        "schema": "profile_capture/1", "start_step": 5, "end_step": 8,
        "trace_dir": None, "spans": [6, 7, 8]}
    trig = ProfileTrigger(NullTracer(), str(tmp_path),
                          profiler_available=False)
    trig.request(1)
    trig.step(0)
    trig.step(1)
    assert json.load(open(trig.captures[0]))["spans"] == []


def test_sigusr1_profile_round_trip(tmp_path):
    tracer = SpanTracer()
    trigger = ProfileTrigger(tracer, str(tmp_path),
                             profiler_available=False)
    dummy_hits: list = []
    outer = signal.signal(signal.SIGUSR1,
                          lambda signum, frame: dummy_hits.append(1))
    try:
        uninstall = install_sigusr1(trigger, steps=2)
        assert uninstall is not None
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not trigger.armed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert trigger.armed
        for step in range(5, 10):
            with tracer.span("dispatch", step=step):
                pass
            trigger.step(step)
        uninstall()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not dummy_hits and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dummy_hits and not trigger.armed
    finally:
        signal.signal(signal.SIGUSR1, outer)
    doc = json.load(open(trigger.captures[0]))
    assert (doc["start_step"], doc["end_step"]) == (5, 7)
    assert [s["step"] for s in doc["spans"]] == [6, 7]
    assert install_sigusr1.__defaults__ == (
        inspect_mod.SIGUSR1_PROFILE_STEPS,) and \
        inspect_mod.SIGUSR1_PROFILE_STEPS == 16


def test_inspect_server_routes(tmp_path):
    """Unknown paths 404 naming the routes; the profile route 503s without
    a trigger and 400s on a bad count; /spans reads the ring; a failing
    health hook is reported, not raised."""
    registry = MetricsRegistry()
    registry.counter("ddp_x_total", "x").inc()
    tracer = SpanTracer()
    with tracer.span("dispatch", step=1):
        pass

    def _health():
        raise RuntimeError("boom")

    for profile in (None, ProfileTrigger(tracer, str(tmp_path),
                                         profiler_available=False)):
        srv = InspectServer(0, registry=registry, tracer=tracer,
                            health=_health, profile=profile)
        try:
            status, ctype, body = _get(srv.port, "/metrics")
            assert status == 200 and "version=0.0.4" in ctype
            assert "ddp_x_total" in jparse_exposition(body.decode())
            assert json.loads(_get(srv.port, "/healthz")[2]) == {
                "ok": False, "error": "RuntimeError('boom')"}
            assert [s["step"] for s in json.loads(
                _get(srv.port, "/spans")[2])["spans"]] == [1]
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.port, "/nope")
            assert e.value.code == 404 and b"/healthz" in e.value.read()
            if profile is None:
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.port, "/debug/profile?steps=2")
                assert e.value.code == 503
            else:
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.port, "/debug/profile?steps=x")
                assert e.value.code == 400
                doc = json.loads(_get(srv.port, "/debug/profile?steps=0")[2])
                assert doc["armed"] is True and doc["steps"] == 1
                assert profile.armed
        finally:
            srv.close()


def test_inspect_endpoints_mid_run(tmp_path, capsys, monkeypatch):
    """``--inspect_port 0`` on a streamed CPU run: /metrics parses under
    JAX's parser mid-run with the prefetch, guard and watchdog counters,
    /healthz carries JAX's keys and a step that advances, /spans holds
    dispatch spans, /debug/profile arms a capture that lands by the end
    (spans only on the CPU), the .prom file exists mid-run; a clean run
    leaves no postmortem."""
    captured: list = []

    class _Capture(InspectServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(cli, "InspectServer", _Capture)
    monkeypatch.chdir(tmp_path)
    scrapes: dict = {}

    def _scraper():
        deadline = time.monotonic() + 120.0
        while not captured and time.monotonic() < deadline:
            time.sleep(0.01)
        if not captured:
            scrapes["error"] = "server never constructed"
            return
        port = captured[0].port
        try:
            steps = []
            while time.monotonic() < deadline:
                health = json.loads(_get(port, "/healthz")[2])
                if health.get("step", 0) >= 1:
                    steps.append(health["step"])
                if len(set(steps)) >= 2:
                    break
                time.sleep(0.01)
            scrapes["steps"] = steps
            scrapes["healthz"] = health
            scrapes["metrics"] = _get(port, "/metrics")
            scrapes["spans"] = json.loads(_get(port, "/spans")[2])["spans"]
            scrapes["profile"] = _get(port, "/debug/profile?steps=2")
            scrapes["prom"] = (open("m.jsonl.prom").read()
                               if os.path.exists("m.jsonl.prom") else None)
        except Exception as e:  # noqa: BLE001
            scrapes["error"] = repr(e)

    t = threading.Thread(target=_scraper, daemon=True)
    t.start()
    # VGG-11 (narrow batches still take ~0.1 s a step on the CPU): the
    # scraper sees the step advance and the capture ends within the run.
    argv = [a for a in _ARGS if a not in ("--model", "deepnn")]
    args = cli.build_parser("t").parse_args(
        argv + ["--inspect_port", "0", "--watchdog_secs", "300",
                "--snapshot_path", str(tmp_path / "ck.pt")])
    cli.run(args)
    t.join(timeout=30)
    err = capsys.readouterr().err
    assert "error" not in scrapes, scrapes
    assert f"127.0.0.1:{captured[0].port}" in err
    status, ctype, body = scrapes["metrics"]
    assert status == 200 and "version=0.0.4" in ctype
    fams = jparse_exposition(body.decode())
    assert {"ddp_prefetch_batches_total", "ddp_guard_decisions_total",
            "ddp_watchdog_beats_total"} <= set(fams)
    assert fams["ddp_prefetch_batches_total"]["samples"][
        ("ddp_prefetch_batches_total", ())] > 0
    assert set(scrapes["healthz"]) == HEALTH_KEYS
    assert scrapes["steps"][-1] > scrapes["steps"][0]
    assert any(s["phase"] == "dispatch" for s in scrapes["spans"])
    assert json.loads(scrapes["profile"][2])["armed"] is True
    assert scrapes["prom"] and "ddp_guard_decisions_total" in \
        jparse_exposition(scrapes["prom"])
    caps = [f for f in os.listdir(tmp_path)
            if f.startswith("profile_capture_step")]
    assert len(caps) == 1
    doc = json.load(open(caps[0]))
    assert doc["trace_dir"] is None  # the CPU: spans only
    assert len({s["step"] for s in doc["spans"]
                if s["phase"] == "dispatch"}) == 2
    assert not os.path.exists("postmortem.json")


def test_obs_off_and_no_port_bind_nothing(tmp_path, capsys, monkeypatch):
    """Without ``--inspect_port`` no server is built; ``--obs_off`` also
    drops the trigger and the flight recorder."""
    def _boom(*a, **kw):
        raise AssertionError("InspectServer built without --inspect_port")

    monkeypatch.setattr(cli, "InspectServer", _boom)
    monkeypatch.chdir(tmp_path)
    args = cli.build_parser("t").parse_args(
        _ARGS + ["--obs_off", "--snapshot_path", str(tmp_path / "ck.pt")])
    cli.run(args)
    capsys.readouterr()
    assert not os.path.exists("postmortem.json")
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith(("profile_capture", "profile_trace",
                                 "trace_spill"))]


def test_taken_port_warns_and_the_run_goes_on(tmp_path, capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        args = cli.build_parser("t").parse_args(
            ["1", "1", "--batch_size", "8", "--synthetic",
             "--synthetic_size", "16", "--model", "deepnn", "--device",
             "cpu", "--inspect_port", str(port), "--snapshot_path",
             str(tmp_path / "ck.pt")])
        out = cli.run(args)
    assert f"cannot bind --inspect_port {port}" in capsys.readouterr().err
    assert len(out["loss_history"]) == 2


def test_watchdog_stall_line_names_the_last_spans(capfd):
    """The stall line prints the context after JAX's words, and the CLI's
    context starts with the tracer's ``describe_last``."""
    tracer = SpanTracer()
    tracer._t0 = 0.0
    tracer.add_span("dispatch", 1.0, 0.5, step=41)
    fired = []
    wd = Watchdog(0.2, tag="unit",
                  context=lambda: tracer.describe_last(lock_timeout=2.0))
    wd._exit = fired.append
    wd.start()
    try:
        time.sleep(0.8)
    finally:
        wd.stop()
    assert fired == [WATCHDOG_EXIT_STATUS]
    assert ("WATCHDOG [unit]: last completed spans on this host: "
            "dispatch[step 41] ended @1.500s (500.00 ms)") in \
        capfd.readouterr().err


def test_planted_stall_prints_the_last_spans(tmp_path):
    """``stall@epoch=0`` through ``DDP_TPU_FAULT`` under ``--watchdog_secs
    3``: exit 124, the stall line names the last spans (the epoch's loss
    read, then its last step), the guard and the mirror, and the spill's
    tail and the postmortem are on disk."""
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.singlegpu", "2", "1",
         "--batch_size", "8", "--synthetic", "--synthetic_size", "16",
         "--model", "deepnn", "--device", "cpu", "--watchdog_secs", "3",
         "--snapshot_path", str(tmp_path / "ck.pt"), "--metrics_path",
         str(tmp_path / "m.jsonl")], cwd=ROOT,
        env=dict(ENV, DDP_TPU_FAULT="stall@epoch=0,secs=600"),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == WATCHDOG_EXIT_STATUS, r.stderr[-3000:]
    line = next(x for x in r.stderr.splitlines()
                if "last completed spans on this host: " in x)
    assert line.index("loss_flush[step 0]") < \
        line.index("dispatch[step 1]"), line  # newest first
    assert "guard: last decision" in r.stderr and "mirror: off" in r.stderr
    spill = [json.loads(x) for x in open(tmp_path / "trace_spill.jsonl")]
    assert {"dispatch", "loss_flush"} <= {s["phase"] for s in spill}
    pm = json.load(open(tmp_path / "postmortem.json"))
    assert pm["reason"] == "watchdog_stall" and pm["spans"]


def test_bench_inspect_overhead_record(capsys):
    """``python -m ddp_tpu_torch.bench --inspect_overhead``: one record of
    JAX's shape (the overhead clamped at 0, each configuration's windows),
    with the device and power limit, and every step it ran counted."""
    from ddp_tpu_torch import bench
    out = bench.main(["--device", "cpu", "--batch_size", "2", "--steps", "2",
                      "--warmup", "1", "--repeats", "2",
                      "--inspect_overhead"])
    rec, = out["records"]
    assert json.loads(capsys.readouterr().out) == rec
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "inspect_overhead", "device", "power_limit_w"}
    per = rec["inspect_overhead"]
    assert set(per) == {"inspect_off", "inspect_on"}
    assert all(len(v["window_ms_per_step"]) == 2 for v in per.values())
    assert rec["value"] == max(per["inspect_on"]["overhead_pct_vs_off"], 0.0)
    assert (rec["device"], rec["power_limit_w"]) == (
        {"name": "cpu", "count": 1}, None)
    assert out["steps"]["float32"] == 1 + 2 + 2 * 2 * 2


def test_bench_profile_dir_writes_a_trace(tmp_path, capsys):
    """``--profile_dir``: one traced, untimed window before the timed ones,
    its Chrome trace on disk; the resident-epoch record is dropped, as
    ``bench.py`` drops its second flavour."""
    from ddp_tpu_torch import bench
    out = bench.main(["--device", "cpu", "--batch_size", "2", "--steps", "1",
                      "--warmup", "1", "--repeats", "1", "--no_bf16",
                      "--profile_dir", str(tmp_path)])
    capsys.readouterr()
    assert len(out["records"]) == 1
    trace = json.load(open(tmp_path / "trace_step.json"))
    assert any(ev.get("name", "").startswith("aten::")
               for ev in trace["traceEvents"])
    assert out["steps"]["float32"] == 1 + 1 + 1
