"""The port's offline observability (``ddp_tpu_torch/obs/``: the tracer's
reading half, ``export``, ``aggregate``, ``ledger`` and ``python -m
ddp_tpu_torch.obs``) held against ``ddp_tpu.obs`` on the same spans, and
the training CLI's traced run on the CPU against the JAX CLI's for the
same flags."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ddp_tpu.obs import aggregate as jaggregate
from ddp_tpu.obs import export as jexport
from ddp_tpu.obs import ledger as jledger
from ddp_tpu.obs.__main__ import main as jobs_main
from ddp_tpu.obs.blackbox import FlightRecorder as JFlightRecorder
from ddp_tpu.obs.tracer import SpanTracer as JSpanTracer
from ddp_tpu_torch import cli
from ddp_tpu_torch.obs import aggregate, export, ledger
from ddp_tpu_torch.obs.__main__ import main as obs_main
from ddp_tpu_torch.obs.tracer import NullTracer, SpanTracer, get_tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
TRAIN_PHASES = ("data_wait", "host_augment", "h2d", "dispatch")


def _train_spans(rng, host: int, steps: int = 24) -> list:
    """A streamed run's spill of one host: the per-step phases (the
    producer's host_augment overlapped), a loss flush an epoch of 12 steps,
    a checkpoint's serial and writer spans, an eval, one replayed step."""
    spans, t = [], 0.0
    for s in range(steps):
        for phase in TRAIN_PHASES:
            dur = float(rng.uniform(1e-4, 5e-2))
            spans.append({"phase": phase, "step": s,
                          "start_s": round(t, 6), "dur_s": round(dur, 6),
                          "overlap": phase == "host_augment", "host": host})
            t += dur if phase != "host_augment" else 0.0
        if s % 12 == 11:
            for phase, overlap in (("loss_flush", False),
                                   ("ckpt_write", False),
                                   ("ckpt_write", True), ("eval", False)):
                dur = float(rng.uniform(1e-3, 1e-1))
                spans.append({"phase": phase, "step": s - 11,
                              "start_s": round(t, 6), "dur_s": round(dur, 6),
                              "overlap": overlap, "host": host})
                t += 0.0 if overlap else dur
    # An --on_nan restore replays step 5: the latest trajectory wins.
    spans.append({"phase": "dispatch", "step": 5, "start_s": round(t, 6),
                  "dur_s": 0.0125, "overlap": False, "host": host})
    return spans


def _serve_spans(rng) -> list:
    """A serving spill: three requests, one retried across hosts, each
    joined to its batch's engine stages."""
    spans, t = [], 0.0
    for q, (host, step) in enumerate(((0, 3), (1, 9), (1, 10))):
        req = f"q{q}"
        spans.append({"phase": "route", "step": None, "start_s": t,
                      "dur_s": 0.3, "overlap": True, "host": 0, "req": req})
        if q == 1:
            spans.append({"phase": "retry", "step": None,
                          "start_s": t + 0.05, "dur_s": 0.001,
                          "overlap": True, "host": 0, "req": req})
        spans.append({"phase": "queue_wait", "step": step,
                      "start_s": t + 0.06, "dur_s": 0.03, "overlap": False,
                      "host": host, "req": req})
        u = t + 0.09
        for phase in export.BATCH_PHASES:
            dur = round(float(rng.uniform(1e-4, 8e-2)), 6)
            spans.append({"phase": phase, "step": step, "start_s": u,
                          "dur_s": dur, "overlap": False, "host": host,
                          "req": None})
            u += dur
        t += 0.5
    return spans


def _spill(path, spans, torn: bool = False) -> str:
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s) + "\n")
        if torn:
            f.write('{"phase": "dispatch", "st')  # a SIGKILL mid-write
    return str(path)


@pytest.fixture(scope="module")
def spills(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("spills")
    train = [_spill(d / "t.jsonl", _train_spans(rng, 0)),
             _spill(d / "t.jsonl.host1", _train_spans(rng, 1), torn=True)]
    serve = [_spill(d / "s.jsonl", _serve_spans(rng))]
    return {"train": train, "serve": serve}


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_export_equals_jax(spills, kind):
    """On one seeded spill (train on two hosts with a torn tail; serving
    with request chains across hosts) every export and report function of
    the port gives JAX's result exactly."""
    spans = export.read_spill(spills[kind])
    jspans = jexport.read_spill(spills[kind])
    assert spans == jspans and spans
    assert export.to_trace_events(spans) == jexport.to_trace_events(jspans)
    assert export.validate_trace_events(export.to_trace_events(spans)) == \
        jexport.validate_trace_events(jexport.to_trace_events(jspans))
    assert export.phase_summary(spans) == jexport.phase_summary(jspans)
    assert export.step_walls(spans) == jexport.step_walls(jspans)
    assert export.slowest_steps(spans, 5) == jexport.slowest_steps(jspans, 5)
    assert export.request_flows(spans) == jexport.request_flows(jspans)
    assert export.slowest_requests(spans, 2) == \
        jexport.slowest_requests(jspans, 2)
    assert export.format_report(spans, top=4, bins=6) == \
        jexport.format_report(jspans, top=4, bins=6)
    assert export.format_requests_report(spans, top=2) == \
        jexport.format_requests_report(jspans, top=2)
    assert export.histogram_lines([1.0, 2.0, 2.5], bins=3) == \
        jexport.histogram_lines([1.0, 2.0, 2.5], bins=3)
    assert export.PHASE_ORDER == jexport.PHASE_ORDER
    assert export.PER_STEP_PHASES == jexport.PER_STEP_PHASES


def test_perfetto_files_equal_jax(spills, tmp_path):
    spans = export.read_spill(spills["train"])
    n = export.write_perfetto(spans, str(tmp_path / "p.json"))
    jn = jexport.write_perfetto(spans, str(tmp_path / "j.json"))
    assert n == jn > 0
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    for bad in ({}, {"traceEvents": []},
                {"traceEvents": [{"name": "x", "ph": "B", "pid": 0,
                                  "tid": 0}]}):
        with pytest.raises(ValueError):
            export.validate_trace_events(bad)


def test_straggler_report_equals_jax():
    rng = np.random.default_rng(1)
    for trial in range(3):
        spans = [{"phase": p, "dur_s": float(rng.uniform(1e-4, 0.1)),
                  "overlap": bool(rng.integers(2))}
                 for p in rng.choice(list(export.PHASE_ORDER), 40)]
        for overlap in (True, False):
            med = aggregate.phase_medians(spans, include_overlap=overlap)
            assert med == jaggregate.phase_medians(
                spans, include_overlap=overlap)
            assert aggregate.straggler_report(med) == \
                jaggregate.straggler_report(med)
    assert aggregate.STRAGGLER_EXCLUDED_PHASES == \
        jaggregate.STRAGGLER_EXCLUDED_PHASES
    for tr, jtr in ((SpanTracer(), JSpanTracer()),):
        for t in (tr, jtr):
            with t.span("dispatch", step=0):
                pass
            with t.span("ckpt_write", step=0):
                pass
        rec = aggregate.epoch_straggler_record(tr, False, 0.0)
        jrec = jaggregate.epoch_straggler_record(jtr, None, 0.0)
        assert set(rec) == set(jrec) == {"dispatch"}
        assert set(rec["dispatch"]) == set(jrec["dispatch"])
    assert aggregate.epoch_straggler_record(NullTracer(), True, 0.0) is None


def test_tracer_reading_half_equals_jax():
    """The same records give JAX's ``last_spans`` and ``describe_last``
    (the watchdog's stall line); the null tracer answers every reader."""
    tr, jtr = SpanTracer(), JSpanTracer()
    assert tr.describe_last() == jtr.describe_last() == "no spans completed"
    for t in (tr, jtr):
        t._t0 = 0.0
        t.add_span("dispatch", 1.0, 0.25, step=3)
        t.add_span("h2d", 1.5, 0.001, step=4)
        t.add_span("dispatch", 2.0, 0.125, step=4)
        t.add_span("eval", 3.0, 0.5)
    assert tr.last_spans() == jtr.last_spans()
    assert tr.describe_last() == jtr.describe_last() == (
        "eval ended @3.500s (500.00 ms); dispatch[step 4] ended @2.125s "
        "(125.00 ms); h2d[step 4] ended @1.501s (1.00 ms)")
    assert tr.spans_since(2.0) == jtr.spans_since(2.0)
    tr._lock.acquire()  # a writer wedged inside the lock
    try:
        assert tr.last_spans(lock_timeout=0.05) == {}
        assert tr.describe_last(lock_timeout=0.05) == "no spans completed"
        tr.flush(fsync=True, lock_timeout=0.05)  # returns, does not wait
    finally:
        tr._lock.release()
    null = NullTracer()
    assert (null.now(), null.spans_since(0.0), null.last_spans(),
            null.describe_last()) == (0.0, [], {}, "")
    null.flush(fsync=True, lock_timeout=1.0)


def test_ledger_equals_jax(spills):
    spans = export.read_spill(spills["train"])
    calib = {"predicted_ms_per_step": {"train_step@dp1": 12.5,
                                       "train_step@zero1": 9.0,
                                       "eval_step@dp1": 40.0},
             "coefficients": {"flop_s": 1e12}}
    for scale in (1.0, 2.0):
        got = ledger.build_ledger(spans, calib, pred_scale=scale)
        assert got == jledger.build_ledger(spans, calib, pred_scale=scale)
        assert ledger.format_ledger(got) == jledger.format_ledger(got)
    assert [r["phase"] for r in got["rows"]] == ["dispatch", "eval"]
    with pytest.raises(ValueError, match="predicted_ms_per_step"):
        ledger.build_ledger(spans, {})


def test_spills_cross_read(tmp_path):
    """The port's tracer writes JAX's records key for key: JAX's
    ``read_spill`` reads it and the port's reads JAX's; both skip a torn
    tail."""
    out = {}
    for name, cls in (("port", SpanTracer), ("jax", JSpanTracer)):
        path = str(tmp_path / f"{name}.jsonl")
        tr = cls(spill_path=path, host=1)
        with tr.span("dispatch", step=7):
            pass
        with tr.span("queue_wait", step=2, overlap=True, req="r1"):
            pass
        tr.close()
        with open(path, "a") as f:
            f.write('{"phase": "h2d", "start_')
        out[name] = path
    for a, b in ((out["port"], out["jax"]), (out["jax"], out["port"])):
        got = export.read_spill([a])
        assert got == jexport.read_spill([a])
        other = jexport.read_spill([b])
        assert [{k: v for k, v in s.items() if k not in ("start_s", "dur_s")}
                for s in got] == \
            [{k: v for k, v in s.items() if k not in ("start_s", "dur_s")}
             for s in other]
        assert [set(s) for s in got] == [set(s) for s in other]


def _both_cli(argv, capsys):
    rc = obs_main(argv)
    port = capsys.readouterr()
    jrc = jobs_main(argv)
    jax = capsys.readouterr()
    return (rc, port.out, port.err), (jrc, jax.out, jax.err)


@pytest.mark.parametrize("case", ["empty", "mixed", "missing", "report",
                                  "requests", "requests_json", "ledger"])
def test_obs_cli_matches_jax(case, spills, tmp_path, capsys):
    """``python -m ddp_tpu_torch.obs`` against ``python -m ddp_tpu.obs``:
    the same exit codes, diagnoses and reports."""
    train = export.read_spill(spills["train"][:1])
    if case == "empty":
        argv = [_spill(tmp_path / "e.jsonl", [])]
    elif case == "mixed":
        argv = [_spill(tmp_path / "m.jsonl",
                       train + export.read_spill(spills["serve"]))]
    elif case == "missing":
        argv = [str(tmp_path / "gone.jsonl")]
    elif case == "report":
        argv = spills["train"] + ["--top", "3", "--bins", "4"]
    elif case.startswith("requests"):
        argv = spills["serve"] + ["--requests", "--top", "2"] + (
            ["--json"] if case == "requests_json" else [])
    else:
        calib = tmp_path / "calib.json"
        calib.write_text(json.dumps(
            {"predicted_ms_per_step": {"train_step@dp1": 10.0}}))
        argv = spills["train"] + ["--ledger", str(calib)]
    port, jax = _both_cli(argv, capsys)
    assert port[0] == jax[0] == (2 if case in ("empty", "mixed", "missing")
                                 else 0)
    assert port[1] == jax[1]
    assert port[2] == jax[2]


def test_obs_cli_perfetto_and_postmortem(spills, tmp_path, capsys):
    """``--perfetto`` writes JAX's file; ``--postmortem`` renders a JAX
    bundle as JAX does, and a torn or invalid bundle exits 2 with JAX's
    diagnosis."""
    assert obs_main(spills["train"] + ["--perfetto",
                                       str(tmp_path / "p.json")]) == 0
    assert jobs_main(spills["train"] + ["--perfetto",
                                        str(tmp_path / "j.json")]) == 0
    capsys.readouterr()
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    tr = JSpanTracer()
    with tr.span("dispatch", step=9):
        pass
    path = str(tmp_path / "postmortem.json")
    rec = JFlightRecorder(path, config={"model": "vgg", "total_epochs": 1},
                          tracer=tr, context=lambda: {"step": 9})
    rec.record({"event": "guard_decision", "decision": "spike_abort",
                "step": 9, "wall_s": 1.0})
    rec.dump("guard_abort", exit_status=1, error="LossSpikeError('9')")
    (tmp_path / "torn.json").write_text('{"schema": "postmor')
    (tmp_path / "bad.json").write_text(json.dumps({"schema": "nope/9"}))
    for name in ("postmortem.json", "torn.json", "bad.json", "gone.json"):
        for extra in ([], ["--json"]):
            argv = ["--postmortem", str(tmp_path / name)] + extra
            port, jax = _both_cli(argv, capsys)
            assert port == jax
            assert port[0] == (0 if name == "postmortem.json" else 2)


# ---------------------------------------------------------------- the CLI

_ARGS = ["2", "1", "--batch_size", "8", "--synthetic", "--synthetic_size",
         "32", "--model", "deepnn", "--lr", "0.02", "--log_every", "2"]


def _port_run(tmp_path, extra, name="p"):
    d = tmp_path / name
    d.mkdir()
    args = cli.build_parser("t").parse_args(
        _ARGS + ["--device", "cpu", "--snapshot_path", str(d / "ck.pt"),
                 "--metrics_path", str(d / "m.jsonl")] + extra)
    out = cli.run(args)
    return d, out


def test_traced_run_records_the_jax_cli_phases(tmp_path, capsys,
                                               monkeypatch):
    """A default streamed run of the port and of the JAX CLI with the same
    flags: the spill lands next to the checkpoint (not in the working
    directory) with the phases JAX's records, the report's serial lanes
    tile the wall, the Perfetto export validates, the metrics stream has
    one ``phase_stragglers`` record an epoch, the end-of-run ``.prom``
    parses with the prefetch counters, and the process tracer is the null
    one again after the run."""
    from ddp_tpu import cli as jcli
    from ddp_tpu.obs.registry import parse_exposition
    monkeypatch.chdir(tmp_path)
    d, _ = _port_run(tmp_path, ["--eval_every", "1"])
    assert not get_tracer().enabled
    assert not (tmp_path / "trace_spill.jsonl").exists()
    jd = tmp_path / "j"
    jd.mkdir()
    jcli.run(jcli.build_parser("t").parse_args(
        _ARGS + ["--eval_every", "1", "--snapshot_path", str(jd / "ck.pt"),
                 "--metrics_path", str(jd / "m.jsonl")]), num_devices=1)
    capsys.readouterr()
    phases = {s["phase"] for s in
              export.read_spill([str(d / "trace_spill.jsonl")])}
    jphases = {s["phase"] for s in
               jexport.read_spill([str(jd / "trace_spill.jsonl")])}
    assert phases == jphases == {"data_wait", "host_augment", "h2d",
                                 "dispatch", "loss_flush", "ckpt_write",
                                 "eval"}
    recs = [json.loads(line) for line in open(d / "m.jsonl")]
    strag = [r for r in recs if r.get("event") == "phase_stragglers"]
    jrecs = [json.loads(line) for line in open(jd / "m.jsonl")]
    jstrag = [r for r in jrecs if r.get("event") == "phase_stragglers"]
    assert [r["epoch"] for r in strag] == [r["epoch"] for r in jstrag] == \
        [0, 1]
    assert set(strag[0]["phases"]) == set(jstrag[0]["phases"])
    assert all(set(v) == {"slowest_host", "slowest_ms", "median_ms",
                          "skew_pct"} and v["slowest_host"] == 0
               for v in strag[0]["phases"].values())
    fams = parse_exposition((d / "m.jsonl.prom").read_text())
    assert fams["ddp_prefetch_batches_total"]["samples"][
        ("ddp_prefetch_batches_total", ())] == 8
    assert "ddp_guard_decisions_total" in fams
    assert obs_main([str(d / "trace_spill.jsonl"), "--perfetto",
                     str(d / "trace.json")]) == 0
    out = capsys.readouterr().out
    assert "phase sum (serial lanes)" in out and "slowest" in out
    assert export.validate_trace_events(
        json.load(open(d / "trace.json"))) > 0


def test_world2_straggler_record_and_host_spill(tmp_path):
    """Two gloo ranks on the CPU: rank 1 spills to ``.host1``, each epoch's
    record has JAX's single-host shape and names rank 0 or 1 for every
    serial phase, and the gather is one ``straggler_gather`` an epoch."""
    d = tmp_path / "w2"
    d.mkdir()
    res = d / "r.json"
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.multigpu", *_ARGS,
         "--device", "cpu", "--spawn", "2", "--snapshot_path",
         str(d / "ck.pt"), "--metrics_path", str(d / "m.jsonl"),
         "--result_json", str(res)], cwd=ROOT, env=dict(ENV,
                                                        OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (d / "trace_spill.jsonl").exists()
    spans1 = export.read_spill([str(d / "trace_spill.jsonl.host1")])
    assert spans1 and {s["host"] for s in spans1} == {1}
    recs = [json.loads(line) for line in open(d / "m.jsonl")]
    strag = [x for x in recs if x.get("event") == "phase_stragglers"]
    assert [x["epoch"] for x in strag] == [0, 1]
    # JAX's single-host record over rank 1's epoch spans (the final eval
    # comes after the last epoch's record).
    jrec = jaggregate.straggler_report(jaggregate.phase_medians(
        [s for s in spans1 if s["phase"] != "eval"], include_overlap=False))
    for x in strag:
        assert set(x["phases"]) == set(jrec)
        assert all(set(v) == set(next(iter(jrec.values())))
                   and v["slowest_host"] in (0, 1)
                   for v in x["phases"].values())
    got = json.loads(res.read_text())
    assert got["collectives"]["straggler_gather"] == 2


def test_obs_off_leaves_no_spill(tmp_path, capsys):
    """``--obs_off``: the null tracer, a stale spill at the path removed,
    no straggler or live records, no flight recorder; the loss stream
    stays."""
    d = tmp_path / "off"
    d.mkdir()
    (d / "trace_spill.jsonl").write_text('{"stale": true}\n')
    args = cli.build_parser("t").parse_args(
        _ARGS + ["--device", "cpu", "--snapshot_path", str(d / "ck.pt"),
                 "--metrics_path", str(d / "m.jsonl"), "--obs_off"])
    cli.run(args)
    capsys.readouterr()
    assert not (d / "trace_spill.jsonl").exists()
    recs = [json.loads(line) for line in open(d / "m.jsonl")]
    assert not any(r.get("event") in ("live", "phase_stragglers")
                   for r in recs)
    assert any("loss" in r for r in recs)
    assert not [f for f in os.listdir(d) if f.startswith(
        ("profile_capture", "postmortem"))]


def test_unwritable_spill_degrades_to_the_ring(tmp_path, capsys):
    """An unwritable ``--trace_spill`` warns and keeps the ring; ``''``
    keeps the ring only; the default lies next to the checkpoint, with
    ``.hostN`` for rank N > 0."""
    args = cli.build_parser("t").parse_args(
        _ARGS + ["--snapshot_path", str(tmp_path / "ck.pt"),
                 "--trace_spill", str(tmp_path / "no_dir" / "s.jsonl")])
    tracer = cli.open_tracer(args, 0, ring=16)
    assert tracer.enabled and tracer.spill_path is None
    assert "tracing continues in-memory only" in capsys.readouterr().err
    args.trace_spill = ""
    assert cli.open_tracer(args, 0, ring=16).spill_path is None
    args.trace_spill = None
    tracer = cli.open_tracer(args, 3, ring=16)
    tracer.close()
    assert tracer.spill_path == str(tmp_path / "trace_spill.jsonl.host3")
