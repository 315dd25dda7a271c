"""The port's flight recorder and exposition parser against ``ddp_tpu``'s.

Tolerances: none.  A bundle dumped by either package's
``FlightRecorder`` passes both packages' ``validate_postmortem`` and
renders to the same text through both ``format_postmortem``; a damaged
bundle fails both with the same diagnosis.  ``MetricsLogger`` taps every
record into the recorder's ring.  The watchdog's expiry dumps a bounded
``watchdog_stall`` bundle before its exit, and the CLI dumps a
``guard_abort`` bundle when the guard aborts.  The port's
``parse_exposition`` reads a registry's exposition as JAX's does.
"""
import json
import os
import time

import pytest

from ddp_tpu.obs import blackbox as jbb
from ddp_tpu.obs import registry as jregistry
from ddp_tpu_torch import cli
from ddp_tpu_torch.obs import blackbox as bb
from ddp_tpu_torch.obs.registry import MetricsRegistry, parse_exposition
from ddp_tpu_torch.obs.tracer import SpanTracer
from ddp_tpu_torch.resilience import faults
from ddp_tpu_torch.resilience.watchdog import Watchdog
from ddp_tpu_torch.utils.metrics import MetricsLogger


def _dump(mod, path, tracer=None):
    rec = mod.FlightRecorder(path, config={"model": "deepnn",
                                           "watchdog_secs": 5.0},
                             tracer=tracer,
                             context=lambda: {"step": 7, "epoch": 1})
    for i in range(3):
        rec.record({"step": i, "loss": 2.0 - i, "wall_s": 0.1 * i})
    rec.record({"event": "guard_decision", "decision": "spike_abort",
                "step": 2, "wall_s": 0.3})
    assert rec.dump("guard_abort", exit_status=1, error="LossSpikeError()")
    assert rec.dumped == "guard_abort"
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_postmortem_round_trips_through_both_packages(writer, tmp_path):
    tracer = SpanTracer() if writer == "port" else None
    if tracer is not None:
        with tracer.span("dispatch", step=3):
            pass
    doc = _dump(bb if writer == "port" else jbb,
                str(tmp_path / bb.POSTMORTEM_BASENAME), tracer)
    assert bb.POSTMORTEM_BASENAME == jbb.POSTMORTEM_BASENAME
    assert doc["schema"] == bb.POSTMORTEM_SCHEMA == jbb.POSTMORTEM_SCHEMA
    assert bb.validate_postmortem(doc) == jbb.validate_postmortem(doc)
    assert bb.format_postmortem(doc) == jbb.format_postmortem(doc)
    assert "spike_abort" in bb.format_postmortem(doc)
    assert len(doc["spans"]) == (1 if tracer is not None else 0)
    for damage in ({"schema": "postmortem/0"}, {"reason": "oops"},
                   {"events": [1]}, {"spans": [{"phase": "x"}]}):
        bad = dict(doc, **damage)
        with pytest.raises(ValueError) as a:
            bb.validate_postmortem(bad)
        with pytest.raises(ValueError) as b:
            jbb.validate_postmortem(bad)
        assert str(a.value) == str(b.value)


def test_metrics_logger_taps_every_record(tmp_path):
    rec = bb.FlightRecorder(str(tmp_path / "pm.json"))
    with MetricsLogger(str(tmp_path / "m.jsonl")) as m:
        m.attach_recorder(rec)
        m.log_step(step=0, epoch=0, loss=2.5, lr=0.1)
        m.log_event("guard_decision", decision="ok", step=0)
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert list(rec._events) == lines


def test_watchdog_expiry_dumps_a_bounded_bundle(tmp_path):
    path = str(tmp_path / "postmortem.json")
    rec = bb.FlightRecorder(path, tracer=SpanTracer())
    codes = []
    wd = Watchdog(0.2, on_expire=lambda: rec.dump(
        "watchdog_stall", exit_status=124, error="stalled", bounded=True))
    wd._exit = codes.append
    wd.start()
    deadline = time.monotonic() + 10
    while not codes and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert codes == [124]
    doc = jbb.validate_postmortem(json.load(open(path)))
    assert (doc["reason"], doc["exit_status"]) == ("watchdog_stall", 124)


def test_cli_guard_abort_leaves_a_postmortem(tmp_path, monkeypatch):
    """``poison@step=3`` under ``--on_nan abort``: the run raises, and the
    bundle next to the metrics stream names the guard abort, its config
    and the trainer's state."""
    monkeypatch.setenv(faults.FAULT_ENV, "poison@step=3")
    metrics = tmp_path / "m.jsonl"
    with pytest.raises(Exception, match="non-finite"):
        cli.main(["1", "1", "--synthetic", "--synthetic_size", "32",
                  "--batch_size", "8", "--device", "cpu", "--model",
                  "deepnn", "--lr", "0.05", "--snapshot_path",
                  str(tmp_path / "ck.pt"), "--metrics_path", str(metrics)])
    doc = jbb.validate_postmortem(json.load(
        open(tmp_path / "postmortem.json")))
    assert (doc["reason"], doc["exit_status"]) == ("guard_abort", 1)
    assert doc["config"]["model"] == "deepnn"
    assert doc["health"]["step"] == 4 and doc["health"][
        "mirror_lag_epochs"] is None
    assert any(e.get("event") == "guard_decision" for e in doc["events"])


def test_parse_exposition_equals_jax():
    reg = MetricsRegistry()
    reg.counter("a_total", "a help", ("reason",)).labels(
        reason='x"y\n').inc(3)
    reg.gauge("g", "gauge").set_function(lambda: 1.5)
    reg.histogram("h_seconds", "h", buckets=(0.5, 1.0)).observe(0.7)
    text = reg.exposition()
    assert parse_exposition(text) == jregistry.parse_exposition(text)
    for bad in ("x 1\n", "# TYPE h histogram\nh_bucket{le=\"1\"} 2\n"
                "h_bucket{le=\"+Inf\"} 1\nh_sum 1\nh_count 1\n"):
        with pytest.raises(ValueError) as a:
            parse_exposition(bad)
        with pytest.raises(ValueError) as b:
            jregistry.parse_exposition(bad)
        assert str(a.value) == str(b.value)
