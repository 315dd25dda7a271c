"""Serving of the port (``ddp_tpu_torch/serve/``) on the CPU: against the JAX
package's ``ServeEngine`` on one checkpoint, and the port's own contracts
after ``tests/test_serve.py``.

Tolerances: port against JAX, rtol/atol 1e-5 on logits of a narrow VGG
(XLA and PyTorch sum the convolutions in other orders; measured 3.4e-7 on
logits of ~0.2) and equal predictions.  Within the port, bit for bit: served
logits against the eval forward at the same bucket shape run the same
PyTorch ops on the same inputs.  Across buckets the JAX tests' 1e-6 holds
(another batch shape may take another kernel).
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.obs.export import read_spill, to_trace_events, \
    validate_trace_events
from ddp_tpu.obs.registry import MetricsRegistry as JRegistry
from ddp_tpu.obs.registry import parse_exposition
from ddp_tpu.obs.tracer import SpanTracer as JSpanTracer
from ddp_tpu.parallel import make_mesh
from ddp_tpu.serve import ServeEngine as JServeEngine
from ddp_tpu.train import save_checkpoint as jsave_checkpoint
from ddp_tpu.train.step import init_train_state as jinit_train_state
import ddp_tpu_torch.models.vgg as tvgg
from ddp_tpu_torch.data import EvalLoader, ResidentData, synthetic
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.obs.registry import MetricsRegistry
from ddp_tpu_torch.obs.tracer import NullTracer, SpanTracer
from ddp_tpu_torch.ops.gather import gather_batch
from ddp_tpu_torch.resilience.preemption import PreemptionGuard
from ddp_tpu_torch.serve import (Draining, DynamicBatcher, NotPorted,
                                 QueueFull, RequestTooLarge, ServeEngine,
                                 ServeHTTPServer, resolve_buckets)
from ddp_tpu_torch.serve import __main__ as serve_main
from ddp_tpu_torch.train.checkpoint import (CheckpointError,
                                            save_checkpoint)
from ddp_tpu_torch.train.evaluate import evaluate_resident
from ddp_tpu_torch.train.step import init_train_state, make_eval_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 16, "M", 512, "M"]
FULL = list(tvgg.ARCH)  # read before the module fixture narrows ARCH
BUCKETS = (1, 8, 32)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def narrow_ckpt(tmp_path_factory):
    """A v1 checkpoint of a narrow VGG written by the JAX package, with
    BatchNorm running statistics drawn from a seed (not the init's 0/1);
    both packages' ARCH narrowed while the module's tests run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvgg, "ARCH", NARROW)
        mp.setattr(tvgg, "ARCH", NARROW)
        params, stats = jvgg.init(jax.random.key(7))
        rng = np.random.default_rng(7)
        stats = {k: {"mean": rng.normal(0, 0.2, v["mean"].shape)
                     .astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, v["var"].shape)
                     .astype(np.float32)} for k, v in stats.items()}
        state = jinit_train_state(params, stats)
        path = str(tmp_path_factory.mktemp("serve") / "ck.pt")
        jsave_checkpoint(path, state.params, state.batch_stats,
                         state.opt_state, step=11, epoch=2)
        yield path


@pytest.fixture(scope="module")
def engine(narrow_ckpt):
    eng = ServeEngine.from_checkpoint(narrow_ckpt, "vgg", device="cpu",
                                      buckets=BUCKETS)
    eng.warm()
    return eng


# -- against the JAX package -----------------------------------------------

def test_port_engine_matches_jax_engine(narrow_ckpt, engine):
    jengine = JServeEngine.from_checkpoint(narrow_ckpt, "vgg",
                                           mesh=make_mesh(1),
                                           buckets=BUCKETS)
    assert jengine.warm() == engine.trace_count == len(BUCKETS)
    for n in (1, 5, 32):
        imgs = _images(n, seed=n)
        want, got = jengine.forward(imgs), engine.forward(imgs)
        assert got.shape == want.shape == (n, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(engine.predict(imgs),
                                      jengine.predict(imgs))
    assert (engine.checkpoint_file, engine.checkpoint_epoch,
            engine.checkpoint_step) == (narrow_ckpt, 2, 11)
    js, ts = jengine.stats(), engine.stats()
    assert set(js) <= set(ts)
    assert ts["checkpoint"] == js["checkpoint"]


# -- bucket resolution and parity within the port --------------------------

def test_bucket_resolution():
    assert resolve_buckets((1, 8, 32, 128)) == (1, 8, 32, 128)
    assert resolve_buckets((32, 8, 8, 1)) == (1, 8, 32)
    assert resolve_buckets((5,)) == (5,)
    with pytest.raises(ValueError):
        resolve_buckets(())
    with pytest.raises(ValueError):
        resolve_buckets((0,))


def test_served_logits_bit_identical_to_eval_forward(engine):
    """At a matched bucket shape the engine's logits are the eval forward's,
    byte for byte: from gather_batch's eval form, and from a uint8 batch
    through ``_as_input``."""
    imgs = _images(32, seed=3)
    table = torch.from_numpy(imgs)
    x, _ = gather_batch(table, torch.zeros(32, dtype=torch.int64),
                        torch.arange(32, dtype=torch.int32))
    apply_fn = make_eval_apply(engine.model)
    served = engine.forward(imgs)
    np.testing.assert_array_equal(served, apply_fn(x).numpy())
    np.testing.assert_array_equal(served, apply_fn(table).numpy())


def test_served_accuracy_matches_evaluate_resident(engine):
    _, test_ds = synthetic(n_train=64, n_test=96, seed=3)
    acc_eval = evaluate_resident(engine.model,
                                 ResidentData(test_ds, torch.device("cpu")),
                                 EvalLoader(test_ds, 32))
    correct = 0
    for start in range(0, len(test_ds), 32):
        pred = engine.predict(test_ds.images[start:start + 32])
        correct += int((pred == test_ds.labels[start:start + 32]).sum())
    assert correct / len(test_ds) * 100.0 == pytest.approx(acc_eval,
                                                           abs=1e-9)


def test_padding_rows_do_not_leak_into_results(engine):
    """A 5-row request after a full batch of other rows: the staging rows
    past the request are zeroed, and the valid rows agree with the same
    rows in a full 32-row batch (bit for bit at the same bucket)."""
    imgs = _images(32, seed=1)
    full = engine.forward(imgs)
    engine.forward(np.full((8, 32, 32, 3), 255, np.uint8))
    small = engine.forward(imgs[:5])
    assert not engine._programs[8].input[5:].any()
    np.testing.assert_allclose(small, full[:5], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(small.argmax(-1), full[:5].argmax(-1))
    np.testing.assert_array_equal(small, engine.forward(imgs[:5]))


def test_warm_count_bounded_at_bucket_set_size(engine):
    assert engine.trace_count == len(engine.buckets)
    assert engine.warm() == len(engine.buckets)  # a second warm adds none
    batcher = DynamicBatcher(engine, max_wait_ms=1.0).start()
    try:
        for n in (1, 2, 3, 5, 7, 8, 9, 13, 17, 25, 31, 32):
            batcher.submit(_images(n, seed=n), timeout=30)
    finally:
        assert batcher.drain(timeout=10)
    assert engine.trace_count == len(engine.buckets)
    assert engine.stats()["compiled_executables"] == len(engine.buckets)
    fams = parse_exposition(engine.registry.exposition())
    assert fams["ddp_engine_compiled_executables"]["samples"][
        ("ddp_engine_compiled_executables", ())] == len(engine.buckets)


def test_engine_rejects_bad_input_shapes(engine):
    with pytest.raises(ValueError, match="expected images"):
        engine.forward(np.zeros((2, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        engine.forward(np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(RequestTooLarge):
        engine.forward(_images(33))
    assert engine.forward(np.zeros((0, 32, 32, 3), np.uint8)).shape == (0, 0)


def test_forward_before_warm_raises(narrow_ckpt):
    eng = ServeEngine.from_checkpoint(narrow_ckpt, "vgg", device="cpu",
                                      buckets=(8,))
    with pytest.raises(RuntimeError, match="warm"):
        eng.forward(_images(2))


def test_from_checkpoint_refuses_directory_v2_and_missing(tmp_path):
    # A directory resolves through the lineage (its manifest's head, or
    # checkpoint.pt); this one holds neither.
    with pytest.raises(CheckpointError, match="no checkpoint found"):
        ServeEngine.from_checkpoint(str(tmp_path), "vgg", device="cpu")
    v2 = str(tmp_path / "index.pt")
    with open(v2, "wb") as f:
        np.savez(f, **{"meta/format_version": np.asarray(2, np.int64)})
    with pytest.raises(CheckpointError, match="format_version 2"):
        ServeEngine.from_checkpoint(v2, "vgg", device="cpu")
    with pytest.raises(CheckpointError, match="no checkpoint found"):
        ServeEngine.from_checkpoint(str(tmp_path / "none.pt"), "vgg",
                                    device="cpu")


# -- batcher admission and edge cases ---------------------------------------

class _StubEngine:
    """Engine-shaped double for batcher edge cases: no model, controllable
    forward latency, the engine's admission surface."""
    input_shape = (32, 32, 3)

    def __init__(self, max_rows=32, delay_s=0.0):
        self.buckets = (8, max_rows)
        self.max_rows = max_rows
        self.delay_s = delay_s
        self.trace_count = len(self.buckets)
        self.checkpoint_step = None
        self.calls = []

    def stats(self):
        return {"buckets": list(self.buckets),
                "compiled_executables": self.trace_count,
                "checkpoint": {"file": None, "epoch": None, "step": None}}

    def forward(self, images, seq=None):
        self.calls.append(images.shape[0])
        if self.delay_s:
            time.sleep(self.delay_s)
        n = images.shape[0]
        return np.repeat(np.arange(n, dtype=np.float32)[:, None], 10, 1) \
            + images.reshape(n, -1)[:, :1].astype(np.float32)


def test_empty_queue_timeout_is_not_an_event():
    b = DynamicBatcher(_StubEngine(), max_wait_ms=1.0).start()
    try:
        time.sleep(0.3)  # several empty poll cycles
        assert b.submit(_images(2), timeout=5).shape == (2, 10)
        assert b.stats()["served_requests"] == 1
    finally:
        b.drain(timeout=5)


def test_oversized_request_rejected_with_clear_error():
    b = DynamicBatcher(_StubEngine(max_rows=16)).start()
    try:
        with pytest.raises(RequestTooLarge, match="largest padded batch"):
            b.submit(_images(17))
        assert b.stats()["rejected_oversize"] == 1
        assert b.stats()["served_requests"] == 0
    finally:
        b.drain(timeout=5)


def test_queue_full_sheds_with_backpressure_error():
    b = DynamicBatcher(_StubEngine(delay_s=0.05), max_batch=1,
                       max_wait_ms=0.0, queue_depth=2).start()
    outcomes = []
    lock = threading.Lock()

    def client(i):
        try:
            b.submit(_images(1, seed=i), timeout=30)
            with lock:
                outcomes.append("served")
        except QueueFull:
            with lock:
                outcomes.append("shed")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(12)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert outcomes.count("shed") >= 1 and outcomes.count("served") >= 3
        s = b.stats()
        assert s["shed_queue_full"] == outcomes.count("shed")
        assert s["served_requests"] == outcomes.count("served")
    finally:
        b.drain(timeout=10)


def test_drain_serves_inflight_then_refuses_new_work():
    b = DynamicBatcher(_StubEngine(delay_s=0.02), max_batch=2,
                       max_wait_ms=1.0, queue_depth=64).start()
    results = []
    lock = threading.Lock()

    def client(i):
        out = b.submit(_images(1, seed=i), timeout=30)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(10)]
    for t in threads:
        t.start()
    time.sleep(0.01)  # let them enqueue
    assert b.drain(timeout=30) is True
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 10 and b.stats()["served_requests"] == 10
    with pytest.raises(Draining):
        b.submit(_images(1))


def test_malformed_request_fails_alone_at_admission():
    b = DynamicBatcher(_StubEngine()).start()
    try:
        with pytest.raises(ValueError, match="expected images"):
            b.submit(np.zeros((2, 16, 16, 3), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            b.submit(np.zeros((2, 32, 32, 3), np.float32))
        with pytest.raises(ValueError, match="empty"):
            b.submit(np.zeros((0, 32, 32, 3), np.uint8))
    finally:
        b.drain(timeout=5)


def test_holdover_request_is_never_split():
    eng = _StubEngine(max_rows=8)
    b = DynamicBatcher(eng, max_batch=8, max_wait_ms=30.0).start()
    try:
        outs = {}

        def client(key, n, seed):
            outs[key] = b.submit(_images(n, seed=seed), timeout=30)

        threads = [threading.Thread(target=client, args=("a", 6, 1)),
                   threading.Thread(target=client, args=("b", 5, 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert outs["a"].shape == (6, 10) and outs["b"].shape == (5, 10)
        assert sorted(eng.calls) in ([5, 6], [5, 8], [6, 8], [8, 8])
    finally:
        b.drain(timeout=5)


# -- HTTP front end ---------------------------------------------------------

@pytest.fixture()
def http_server():
    eng = _StubEngine()
    batcher = DynamicBatcher(eng, max_wait_ms=1.0).start()
    httpd = ServeHTTPServer(("127.0.0.1", 0), eng, batcher)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", batcher
    batcher.drain(timeout=5)
    httpd.close()
    httpd.close()  # idempotent
    t.join(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def test_http_healthz_predict_stats_metrics(http_server):
    base, _ = http_server
    status, body = _get(base + "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["compiled_executables"] == 2
    status, out = _post(base + "/predict", {"instances": _images(2).tolist()})
    assert status == 200
    assert len(out["predictions"]) == 2 and len(out["logits"][0]) == 10
    status, body = _get(base + "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["swaps"] == []
    assert stats["batcher"]["served_requests"] == 1
    assert stats["engine"]["buckets"] == [8, 32]
    status, body = _get(base + "/metrics")
    fams = parse_exposition(body.decode())  # the JAX package's strict parser
    assert status == 200
    assert fams["ddp_batcher_served_total"]["samples"][
        ("ddp_batcher_served_total", ())] == 1
    assert fams["ddp_batcher_request_latency_ms"]["type"] == "histogram"


def test_http_error_mapping(http_server):
    base, batcher = http_server
    with pytest.raises(urllib.error.HTTPError) as e:  # oversized
        _post(base + "/predict", {"instances": _images(33).tolist()})
    assert e.value.code == 413
    with pytest.raises(urllib.error.HTTPError) as e:  # malformed pixels
        _post(base + "/predict", {"instances": [[[[1.5] * 3] * 32] * 32]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:  # not ported: A12
        _post(base + "/generate", {"prompt": [1, 2]})
    assert e.value.code == 501 and "A12" in json.loads(e.value.read())[
        "error"]
    batcher.drain(timeout=5)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/healthz")
    assert e.value.code == 503
    assert json.loads(e.value.read())["status"] == "draining"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/predict", {"instances": _images(1).tolist()})
    assert e.value.code == 503 and e.value.headers["Retry-After"] == "1"


def test_http_server_refuses_a_fleet():
    with pytest.raises(NotPorted, match="A9"):
        ServeHTTPServer(("127.0.0.1", 0), None, None, fleet=object())


# -- telemetry, registry and the preemption guard ---------------------------

def test_serve_spans_spill_and_read_by_the_jax_tooling(tmp_path, engine):
    """A traced serve run spills queue_wait/batch_form/pad/h2d/forward/d2h
    records key for key like the JAX tracer's, which its reader and
    Perfetto export take unchanged."""
    spill = str(tmp_path / "serve_spill.jsonl")
    tracer = SpanTracer(spill_path=spill)
    old_tracer, engine.tracer = engine.tracer, tracer
    try:
        b = DynamicBatcher(engine, max_wait_ms=1.0, tracer=tracer).start()
        for n in (1, 8, 20):
            b.submit(_images(n, seed=n), timeout=30, req_id=f"r{n}")
        b.drain(timeout=10)
    finally:
        engine.tracer = old_tracer
        tracer.close()
    spans = read_spill([spill])
    assert {"queue_wait", "batch_form", "pad", "h2d", "forward",
            "d2h"} <= {s["phase"] for s in spans}
    assert all(s["overlap"] and s["req"] for s in spans
               if s["phase"] == "queue_wait")
    assert validate_trace_events(to_trace_events(spans)) > len(spans)
    jspill = str(tmp_path / "jax_spill.jsonl")
    with JSpanTracer(spill_path=jspill) as jt:
        jt.add_span("queue_wait", time.monotonic(), 0.001, step=0,
                    overlap=True, req="r")
        jt.add_span("pad", time.monotonic(), 0.001, step=0)
    with open(jspill) as f:
        jkeys = [sorted(json.loads(line)) for line in f]
    with open(spill) as f:
        ports = [json.loads(line) for line in f]
    assert sorted(next(r for r in ports if "req" in r)) == jkeys[0]
    assert sorted(next(r for r in ports if "req" not in r)) == jkeys[1]
    with NullTracer().span("pad"):
        pass


def test_registry_exposition_equals_the_jax_registry():
    """The same operations on both registries give the same text."""
    texts = []
    for reg in (MetricsRegistry(), JRegistry()):
        c = reg.counter("ddp_x_total", "a counter", ("bucket",))
        c.labels(bucket='8"\\\n').inc(3)
        c.labels(bucket="1").inc()
        reg.gauge("ddp_g", "a gauge").labels().inc(2.5)
        h = reg.histogram("ddp_lat_ms", "latency").labels()
        for v in (0.5, 3.0, 7.0, 12000.0):
            h.observe(v)
        with pytest.raises(ValueError):
            c.labels(bucket="1").inc(-1)
        with pytest.raises(ValueError):
            reg.gauge("ddp_x_total")
        texts.append(reg.exposition())
    assert texts[0] == texts[1]
    parse_exposition(texts[0])


def test_preemption_guard_notices_then_rearms():
    prev = signal.getsignal(signal.SIGUSR1)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        assert not guard.noticed()
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert guard.noticed()
        assert signal.getsignal(signal.SIGUSR1) == prev  # re-armed
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == prev


# -- the entry point --------------------------------------------------------

def test_serve_cli_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError, match="--device cpu"):
        serve_main.main(["--snapshot_path", str(tmp_path / "ck.pt")])


def test_serve_cli_end_to_end_with_sigterm_drain(tmp_path):
    """``python -m ddp_tpu_torch.serve --device cpu`` on a full-width
    checkpoint: /healthz and one /predict over HTTP, SIGTERM, a graceful
    drain and exit 0, the span spill on disk."""
    model = VGG(FULL, generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, model, init_train_state(model).momentum, 0, 0)
    spill = str(tmp_path / "serve_spill.jsonl")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--port", "0", "--buckets", "1,8", "--snapshot_path", ck,
         "--trace_spill", spill], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving vgg on http://" in line, line
        base = line.split("on ")[1].split(" ")[0].rstrip("/")
        status, body = _get(base + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["checkpoint"]["file"] == ck
        assert health["compiled_executables"] == 2
        imgs = _images(3)
        status, out = _post(base + "/predict", {"instances": imgs.tolist()})
        assert status == 200 and len(out["predictions"]) == 3
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "drained=clean" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = make_eval_apply(model)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(np.asarray(out["logits"]), want, rtol=1e-6,
                               atol=1e-6)
    assert {"forward", "h2d"} <= {s["phase"] for s in read_spill([spill])}
