"""The port's serving fleet (``ddp_tpu_torch/serve/{router,fleet}.py``, the
serve faults and ``python -m ddp_tpu_torch.serve --fleet N``) against
``ddp_tpu.serve`` on the CPU.

- Router and breaker: each scenario of ``tests/test_fleet.py`` runs on both
  packages' routers over the same stub replicas with the same seed.  Each
  run must satisfy the JAX test's assertions, and the two runs must agree
  exactly on the replicas each attempt went to (in order), the exception
  classes raised, ``stats()`` and the ``Retry-After`` an HTTP front end
  would send (``max(1, round(retry_after_s))``).  Scenarios whose counts
  depend on wall time (the deadline budget) compare what does not.
- Replicas: ``LocalReplica``'s swap under concurrent load never mixes two
  snapshots in one response; ``HTTPReplica`` maps every status the same
  way in three pairings (the port's client against the port's server and
  against JAX's, JAX's client against the port's server).
- The fleet: one JAX-published DeepNN lineage served by both packages'
  ``ServeFleet`` (the port's with ``device="cpu"``); logits within rtol/atol
  1e-5 (XLA and PyTorch sum the layers in other orders) before and after a
  hot swap, the swap history's events and fields equal, a torn publish
  skipped alike.  The chaos drill on the port: zero failed requests across
  a replica kill and a mid-load swap, its spans a valid Perfetto trace with
  one connected retried flow, and the registry's totals equal ``stats()``.
- The entry point in a subprocess: a fleet of 2 on a DeepNN file, a
  crash fault installed, ``/healthz`` ok with 2 healthy replicas, every
  request answered, the victim ejected, SIGTERM exit 0.
"""
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.serve as jserve
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim import SGDState
from ddp_tpu.parallel import make_mesh
from ddp_tpu.resilience import faults as jfaults
from ddp_tpu.resilience.lineage import CheckpointLineage
from ddp_tpu.train import save_checkpoint as jsave_checkpoint
import ddp_tpu_torch.serve as tserve
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.obs.export import (BATCH_PHASES, format_requests_report,
                                      read_spill, request_flows,
                                      to_trace_events, validate_trace_events)
from ddp_tpu_torch.obs.registry import parse_exposition
from ddp_tpu_torch.obs.tracer import SpanTracer
from ddp_tpu_torch.resilience import faults
from ddp_tpu_torch.train.checkpoint import CheckpointError, save_checkpoint
from ddp_tpu_torch.train.step import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jserve, "torch": tserve}
FAULTS = {"jax": jfaults, "torch": faults}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


def _retry_after(e) -> int:
    """The Retry-After header both HTTP front ends send for ``e``."""
    return max(1, round(getattr(e, "retry_after_s", 1)))


# -- stub replicas (either package's exception classes) ----------------------

class _Stub:
    """The replica protocol with scriptable failure modes; every attempt
    appends its id to the shared ``log`` (the pick sequence)."""

    def __init__(self, ns, replica_id, depth=0, log=None):
        self.ns = ns
        self.replica_id = replica_id
        self.mode = "ok"  # ok|crash|queue_full|draining|client_error
        self.healthy = True
        self.crashed = False  # the crash fault's latch (LocalReplica's)
        self.depth = depth
        self.calls = 0
        self.served = 0
        self.log = log if log is not None else []

    def _attempt(self):
        self.calls += 1
        self.log.append(self.replica_id)
        if self.crashed or self.mode == "crash":
            raise self.ns.ReplicaCrashed(f"{self.replica_id} is down")
        if self.mode == "queue_full":
            raise self.ns.QueueFull(f"{self.replica_id} admission queue full")
        if self.mode == "draining":
            raise self.ns.Draining(f"{self.replica_id} draining for swap")
        if self.mode == "client_error":
            raise ValueError("pixel values must be integers")
        self.served += 1

    def submit(self, images, timeout=None, req=None):
        self._attempt()
        return np.full((images.shape[0], 10), float(self.replica_id[-1]),
                       np.float32)

    def generate(self, prompt, max_new_tokens=None, timeout=None, req=None,
                 session=None):
        self._attempt()
        return {"tokens": [int(self.replica_id[-1])] * (max_new_tokens or 1),
                "prompt_len": len(prompt)}

    def health(self):
        if self.crashed or not self.healthy:
            raise self.ns.ReplicaCrashed(f"{self.replica_id} probe refused")
        return {"status": "ok", "replica_id": self.replica_id,
                "queue_depth": self.depth}

    def queue_depth(self):
        return self.depth

    def stats(self):
        return {"replica_id": self.replica_id, "served": self.served}


class _FullOnce(_Stub):
    """Answers QueueFull to its first attempt, then serves."""

    def submit(self, images, timeout=None, req=None):
        if self.calls == 0:
            self.calls += 1
            self.log.append(self.replica_id)
            raise self.ns.QueueFull(f"{self.replica_id} momentarily full")
        return super().submit(images, timeout, req)


def _stubs(ns, log, *specs):
    return [(_FullOnce if full else _Stub)(ns, rid, depth, log)
            for rid, depth, full in specs]


def _per(router):
    return {p["replica_id"]: p for p in router.stats()["per_replica"]}


# -- breaker and router scenarios, each run on both packages -----------------
# A scenario takes the package and returns its record; it asserts what the
# JAX test asserts.  The two packages' records must be equal.

def sc_breaker_trips(ns):
    br = ns.CircuitBreaker(trip_after=3, cooldown_s=60.0)
    rec = [br.allow()]
    br.record_failure()
    br.record_failure()
    rec.append(br.snapshot())
    assert br.snapshot()["state"] == "closed"  # streak not yet at 3
    br.record_failure()
    assert br.snapshot()["state"] == "open"
    assert not br.allow()  # cooldown still running
    assert br.snapshot()["trips"] == 1
    return rec + [br.snapshot()]


def sc_breaker_success_resets(ns):
    br = ns.CircuitBreaker(trip_after=2, cooldown_s=60.0)
    br.record_failure()
    br.record_success()
    br.record_failure()  # 1 again, not 2
    assert br.snapshot()["state"] == "closed"
    assert br.allow()
    return [br.snapshot()]


def sc_breaker_half_open_one_probe(ns):
    br = ns.CircuitBreaker(trip_after=1, cooldown_s=0.02)
    br.record_failure()
    assert not br.allow()
    time.sleep(0.03)  # cooldown expired
    grants, lock = [], threading.Lock()

    def racer():
        ok = br.allow()
        with lock:
            grants.append(ok)

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert grants.count(True) == 1  # the single half-open probe
    assert br.snapshot()["state"] == "half-open"
    rec = [sorted(grants), br.snapshot()]
    br.record_success()
    assert br.snapshot()["state"] == "closed"
    assert br.allow() and br.allow()  # closed: unlimited again
    return rec + [br.snapshot()]


def sc_breaker_release_probe(ns):
    br = ns.CircuitBreaker(trip_after=1, cooldown_s=0.01)
    br.record_failure()
    time.sleep(0.02)
    assert br.allow()  # the probe, claimed
    assert not br.allow()  # slot taken
    br.release_probe()
    assert br.snapshot()["state"] == "half-open"  # no outcome recorded
    assert br.allow()  # slot re-grantable
    return [br.snapshot()]


def sc_breaker_cooldown_doubles_capped(ns):
    br = ns.CircuitBreaker(trip_after=1, cooldown_s=1.0, cooldown_max_s=3.0)
    br.record_failure()
    assert br.snapshot()["cooldown_s"] == 2.0  # next cooldown, doubled
    br._open_until = 0.0  # force the cooldown over
    assert br.allow()  # the half-open probe
    br.record_failure()  # probe failed: re-open
    assert br.snapshot()["state"] == "open"
    assert br.snapshot()["cooldown_s"] == 3.0  # capped, not 4.0
    rec = [br.snapshot()]
    br.record_success()
    assert br.snapshot()["cooldown_s"] == 1.0  # success resets backoff
    return rec + [br.snapshot()]


def sc_rejects_empty_and_duplicates(ns):
    rec = []
    for reps in ([], [_Stub(ns, "r0"), _Stub(ns, "r0")]):
        with pytest.raises(ValueError) as e:
            ns.Router(reps)
        rec.append(str(e.value))
    assert "at least one" in rec[0] and "duplicate" in rec[1]
    return rec


def sc_retry_after_crash(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 1, False))
    r0.mode = "crash"  # least-loaded: r0 is picked first
    router = ns.Router([r0, r1], max_retries=2, backoff_ms=1.0, seed=3)
    out = router.submit(_images(2), timeout=5)
    assert float(out[0, 0]) == 1.0  # r1 answered
    assert r1.served == 1 and router.stats()["retries"] >= 1
    assert r0.calls == 1  # failed_on keeps the retry OFF the victim
    per = _per(router)
    assert per["r0"]["failed"] == 1 and per["r0"]["breaker"]["failures"] == 1
    return [log, router.stats()]


def sc_client_errors_not_retried(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 1, False))
    r0.mode = "client_error"
    router = ns.Router([r0, r1], max_retries=5, seed=3)
    with pytest.raises(ValueError, match="pixel values"):
        router.submit(_images(2), timeout=5)
    assert r0.calls == 1 and r1.calls == 0  # nobody retried it
    assert _per(router)["r0"]["breaker"]["failures"] == 0
    assert router.stats()["retries"] == 0
    return [log, router.stats()]


def sc_draining_reroutes(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 0, False))
    r0.mode = "draining"
    router = ns.Router([r0, r1], max_retries=0, seed=3)  # not a retry
    for _ in range(4):
        assert float(router.submit(_images(1), timeout=5)[0, 0]) == 1.0
    per = _per(router)
    assert per["r0"]["breaker"]["state"] == "closed"
    assert per["r0"]["breaker"]["failures"] == 0 and per["r0"]["failed"] == 0
    return [log, router.stats()]


def sc_half_open_probe_not_leaked(ns):
    rec = []
    for mode, shed in [("queue_full", ns.RouterOverloaded),
                       ("draining", ns.RouterDraining),
                       ("client_error", ValueError)]:
        log = []
        (r0,) = _stubs(ns, log, ("r0", 0, False))
        router = ns.Router([r0], breaker_trip_after=1,
                           breaker_cooldown_s=0.01, seed=3)
        breaker = router._states["r0"].breaker
        breaker.record_failure()  # trip OPEN
        time.sleep(0.02)  # cooldown over: the next allow() is the probe
        r0.mode = mode
        with pytest.raises(shed) as e:
            router.submit(_images(1), timeout=5)
        assert breaker.snapshot()["state"] == "half-open"
        r0.mode = "ok"  # the replica recovers
        assert float(router.submit(_images(1), timeout=5)[0, 0]) == 0.0
        assert breaker.snapshot()["state"] == "closed"
        rec.append([type(e.value).__name__, _retry_after(e.value), log,
                    router.stats()])
    return rec


def sc_all_draining_sheds(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 0, False))
    r0.mode = r1.mode = "draining"
    router = ns.Router([r0, r1], seed=3)
    t0 = time.monotonic()
    with pytest.raises(ns.RouterDraining) as e:
        router.submit(_images(1), timeout=30)
    assert time.monotonic() - t0 < 1.0  # shed, not deadline-spun
    assert e.value.retry_after_s >= 1.0
    assert isinstance(e.value, ns.QueueFull)  # the 503 shed mapping
    assert isinstance(e.value, ns.Draining)  # single-engine parity
    assert router.stats()["shed_draining"] == 1
    assert r0.calls <= 2 and r1.calls <= 2
    return [type(e.value).__name__, _retry_after(e.value), log,
            router.stats()]


def sc_momentarily_full_readmitted(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, True), ("r1", 1, False))
    r1.mode = "crash"
    router = ns.Router([r0, r1], max_retries=2, backoff_ms=1.0, seed=3)
    assert float(router.submit(_images(1), timeout=5)[0, 0]) == 0.0
    assert r0.calls == 2 and r1.calls == 1  # r1 not hammered
    return [log, router.stats()]


def sc_queue_full_then_overloaded(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 1, False))
    r0.mode = "queue_full"
    router = ns.Router([r0, r1], seed=3)
    assert float(router.submit(_images(1), timeout=5)[0, 0]) == 1.0
    r1.mode = "queue_full"  # now everyone is full
    with pytest.raises(ns.RouterOverloaded) as e:
        router.submit(_images(1), timeout=5)
    assert 1.0 <= e.value.retry_after_s <= 60.0
    assert router.stats()["shed_overloaded"] == 1
    assert isinstance(e.value, ns.QueueFull)
    return [type(e.value).__name__, _retry_after(e.value), log,
            router.stats()]


def sc_deadline_budget(ns):
    log = []
    (r0,) = _stubs(ns, log, ("r0", 0, False))
    r0.mode = "crash"
    router = ns.Router([r0], max_retries=10_000, backoff_ms=5.0,
                       breaker_trip_after=10_000, seed=3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline budget") as e:
        router.submit(_images(1), timeout=0.3)
    assert time.monotonic() - t0 < 1.5  # the budget ruled, not max_retries
    assert r0.calls < 30  # exponential backoff: no hot spin
    # The attempts a budget holds depend on the clock: compare the rest.
    return [type(e.value).__name__, set(log),
            {k: v for k, v in router.stats().items()
             if k not in ("routed", "retries", "per_replica")}]


def sc_eject_backoff_readmit(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 0, False))
    router = ns.Router([r0, r1], eject_after=2, readmit_base_s=0.05,
                       readmit_max_s=10.0, seed=3)
    r0.healthy = False
    router.health_tick()  # failure 1: still in rotation
    assert not router._states["r0"].ejected
    router.health_tick()  # failure 2: ejected
    st = router._states["r0"]
    assert st.ejected and router.stats()["ejections"] == 1
    assert st.readmit_backoff_s == 0.05
    rec = [router.stats()]
    time.sleep(0.06)
    router.health_tick()  # still down: backoff doubles
    assert st.ejected and st.readmit_backoff_s == 0.1
    time.sleep(0.12)
    r0.healthy = True
    router.health_tick()  # healed: back in rotation
    assert not st.ejected and router.stats()["readmissions"] == 1
    health = {h["replica_id"]: h for h in router.replica_health()}
    assert health["r0"]["ejected"] is False
    return rec + [router.stats(), health]


def sc_all_ejected_sheds(ns):
    log = []
    reps = _stubs(ns, log, ("r0", 0, False), ("r1", 0, False))
    for r in reps:
        r.healthy = False
    router = ns.Router(reps, eject_after=1, readmit_base_s=5.0, seed=3)
    router.health_tick()  # eject_after=1: both gone at once
    with pytest.raises(ns.NoHealthyReplicas) as e:
        router.submit(_images(1), timeout=5)
    assert 1.0 <= e.value.retry_after_s <= 60.0
    assert router.stats()["shed_no_replicas"] == 1
    health = {h["replica_id"]: h for h in router.replica_health()}
    assert health["r0"]["status"] == "dead" and health["r0"]["ejected"]
    # The re-admission ETA counts down from 5 s: its ceiling is the same
    # whatever the scheduler did between the tick and the submit.
    return [type(e.value).__name__, math.ceil(e.value.retry_after_s),
            str(e.value), log, router.stats(),
            {k: {f: v for f, v in h.items() if f != "error"}
             for k, h in health.items()}]


def sc_open_breaker_out_of_rotation(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 9, False))
    router = ns.Router([r0, r1], seed=3)
    for _ in range(3):  # trip r0's breaker by hand
        router._states["r0"].breaker.record_failure()
    assert float(router.submit(_images(1), timeout=5)[0, 0]) == 1.0
    assert r0.calls == 0  # r1 despite its deeper queue
    return [log, router.stats()]


def sc_round_robin_picks(ns):
    """Least queue first, ties in round-robin order, over a run of submits
    while the depths change: the pick sequence both routers make."""
    log = []
    reps = _stubs(ns, log, ("r0", 1, False), ("r1", 0, False),
                  ("r2", 0, False))
    router = ns.Router(reps, seed=3)
    for k in range(9):
        reps[k % 3].depth = k % 2
        router.submit(_images(1), timeout=5)
    return [log, router.stats()]


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def sc_http_all_ejected_503(ns):
    reps = _stubs(ns, [], ("r0", 0, False), ("r1", 0, False))
    for r in reps:
        r.healthy = False
    router = ns.Router(reps, eject_after=1, readmit_base_s=5.0, seed=3)
    router.health_tick()

    class _Facade:  # the ServeFleet front-door surface
        def submit(self, images, timeout=None, req=None):
            return router.submit(images, timeout=timeout)

        def health(self):
            return {"status": "unavailable",
                    "replicas": router.replica_health()}

        def stats(self):
            return {"router": router.stats(), "replicas": [], "swaps": []}

    httpd = ns.ServeHTTPServer(("127.0.0.1", 0), fleet=_Facade())
    base = _serve(httpd)
    try:
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"instances": _images(1).tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 503
        retry_after = int(e.value.headers["Retry-After"])
        assert 1 <= retry_after <= 60
        error = json.load(e.value)["error"]
        assert "no healthy replicas" in error
        with pytest.raises(urllib.error.HTTPError) as h:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert h.value.code == 503
        assert json.load(h.value)["status"] == "unavailable"
    finally:
        httpd.close()
    return [e.value.code, retry_after, error, h.value.code]


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_same_on_both_packages(name):
    records = {pkg: SCENARIOS[name](ns) for pkg, ns in PKGS.items()}
    assert records["torch"] == records["jax"]


# -- sticky sessions ---------------------------------------------------------

def _sticky(ns):
    log = []
    r0, r1 = _stubs(ns, log, ("r0", 0, False), ("r1", 0, False))
    router = ns.Router([r0, r1], max_retries=2, backoff_ms=1.0, seed=3)
    out = router.generate([1, 2, 3], max_new_tokens=2, timeout=5,
                          session="s1")
    pinned = router.session_replica("s1")
    assert out["tokens"] == [int(pinned[-1])] * 2
    # The pin beats least-queue routing while the pinned replica answers.
    by_id = {"r0": r0, "r1": r1}
    by_id[pinned].depth = 5
    for _ in range(3):
        router.generate([1], timeout=5, session="s1")
    assert router.session_replica("s1") == pinned
    assert router.stats()["session_migrations"] == 0
    # A second session pins where least-queue routing sends it.
    router.generate([1], timeout=5, session="s2")
    other = router.session_replica("s2")
    assert other != pinned
    # The pinned replica fails mid-stream: the stream re-routes and the
    # session migrates, counted once.
    by_id[pinned].mode = "crash"
    router.generate([1, 2], timeout=5, session="s1")
    assert router.session_replica("s1") == other
    assert router.stats()["session_migrations"] == 1
    fams = parse_exposition(router.registry.exposition())
    migrations = fams["ddp_router_session_migrations_total"]["samples"]
    assert sum(migrations.values()) == 1
    assert fams["ddp_router_sessions"]["samples"][
        ("ddp_router_sessions", ())] == 2
    return [log, router.stats()]


def test_sticky_sessions_pin_and_migrate_alike():
    assert _sticky(tserve) == _sticky(jserve)


def test_local_replica_generate_on_a_classifier_is_a_type_error():
    eng = _Engine()
    rep = tserve.LocalReplica("r0", eng,
                              tserve.DynamicBatcher(eng).start())
    router = tserve.Router([rep])
    try:
        with pytest.raises(TypeError, match="classifier"):
            router.generate([1, 2], timeout=5)
        assert router.stats()["retries"] == 0  # the client's own error
    finally:
        rep.close()


# -- LocalReplica hot swap ---------------------------------------------------

class _Engine:
    """Versioned engine double: every logit equals the engine version, so
    a response mixing snapshots is detectable in one np.unique call."""
    input_shape = (32, 32, 3)

    def __init__(self, version=1.0, delay_s=0.0, step=7):
        self.version = float(version)
        self.buckets = (8, 32)
        self.max_rows = 32
        self.delay_s = delay_s
        self.trace_count = len(self.buckets)
        self.checkpoint_file = "stub.pt"
        self.checkpoint_epoch = 0
        self.checkpoint_step = step

    def forward(self, images, seq=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.full((images.shape[0], 10), self.version, np.float32)

    def stats(self):
        return {"buckets": list(self.buckets),
                "compiled_executables": self.trace_count,
                "checkpoint": {"file": self.checkpoint_file,
                               "epoch": self.checkpoint_epoch,
                               "step": self.checkpoint_step}}


def test_local_replica_swap_is_consistent_under_concurrent_load():
    """Every response under a mid-load swap comes from ONE snapshot, no
    client sees an error besides the re-routable Draining hand-off, and
    once swap() returns every new request is v2."""
    e1 = _Engine(version=1.0, delay_s=0.002, step=1)
    rep = tserve.LocalReplica(
        "r0", e1, tserve.DynamicBatcher(e1, max_wait_ms=2.0).start())
    stop = threading.Event()
    versions, errors = [], []
    lock = threading.Lock()

    def client(seed):
        while not stop.is_set():
            try:
                out = rep.submit(_images(4, seed=seed), timeout=10)
            except tserve.Draining:
                continue  # a fleet's router re-routes this
            except Exception as e:
                with lock:
                    errors.append(e)
                return
            vals = np.unique(out)
            with lock:
                versions.append((len(vals), float(vals[0])))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    e2 = _Engine(version=2.0, delay_s=0.002, step=2)
    assert rep.swap(e2, tserve.DynamicBatcher(e2, max_wait_ms=2.0).start())
    assert float(np.unique(rep.submit(_images(4), timeout=10))[0]) == 2.0
    time.sleep(0.15)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert all(n == 1 for n, _ in versions)  # never a mixed-snapshot row
    assert {v for _, v in versions} == {1.0, 2.0}
    assert rep.swaps == 1 and rep.health()["checkpoint_step"] == 2
    assert rep.stats()["swaps"] == 1
    assert rep.close() is True
    rep.crashed = True
    with pytest.raises(tserve.ReplicaCrashed):
        rep.health()


# -- HTTPReplica both ways ---------------------------------------------------

class _Scripted:
    """A fleet front door whose submit raises the scripted error of its
    package (the server maps it to a status)."""

    def __init__(self, ns):
        self.ns = ns
        self.error = None

    def submit(self, images, timeout=None, req=None):
        if self.error is not None:
            raise self.error
        if images.shape[0] > 32:
            raise self.ns.RequestTooLarge("33 rows exceed 32")
        return np.full((images.shape[0], 10), 5.0, np.float32)

    def health(self):
        return {"status": "ok", "replica_id": "f0", "queue_depth": 3}

    def stats(self):
        return {"router": {}, "replicas": [], "swaps": []}


def _statuses(client, server):
    """Every status ``server``'s front end sends, through ``client``'s
    HTTPReplica: the exception class name each maps to."""
    cns, sns = PKGS[client], PKGS[server]
    front = _Scripted(sns)
    httpd = sns.ServeHTTPServer(("127.0.0.1", 0), fleet=front)
    rep = cns.HTTPReplica("h0", _serve(httpd))
    seen = {}
    try:
        out = rep.submit(_images(2), req="q7")
        assert out.shape == (2, 10) and float(out[0, 0]) == 5.0
        assert rep.health()["status"] == "ok" and rep.queue_depth() == 3
        for what, err in [
                ("too_large", None),
                ("malformed", None),
                ("queue_full", sns.QueueFull("admission queue at capacity")),
                ("draining", sns.Draining(
                    "server is draining; no new requests accepted")),
                ("router_draining", sns.RouterDraining(
                    "all 2 candidate replica(s) draining", 1.0)),
                ("no_replicas", sns.NoHealthyReplicas(
                    "no healthy replicas", 7.4)),
                ("overloaded", sns.RouterOverloaded("all full", 2.0)),
                ("timeout", TimeoutError("not served in time")),
                ("engine", RuntimeError("kernel launch failed"))]:
            front.error = err
            imgs = _images(33) if what == "too_large" else _images(1)
            if what == "malformed":
                imgs = np.zeros((1, 32, 32, 3), np.float32)
            try:
                rep.submit(imgs, timeout=10)
                seen[what] = None
            except Exception as e:
                seen[what] = type(e).__name__
                assert isinstance(e, {
                    "too_large": cns.RequestTooLarge,
                    "malformed": ValueError, "queue_full": cns.QueueFull,
                    "draining": cns.Draining,
                    "router_draining": cns.Draining,
                    "no_replicas": cns.QueueFull,
                    "overloaded": cns.QueueFull, "timeout": TimeoutError,
                    "engine": cns.ReplicaCrashed}[what]), (what, e)
    finally:
        httpd.close()
    with pytest.raises(cns.ReplicaCrashed):  # listener gone
        rep.submit(_images(1))
    with pytest.raises(Exception):  # the probe fails loudly too
        rep.health()
    assert "error" in rep.stats()
    return seen


@pytest.mark.parametrize("client,server", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_http_replica_maps_every_status_alike(client, server):
    assert _statuses(client, server) == _statuses("jax", "jax")


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_http_replica_on_a_draining_pair_and_a_slow_one(server):
    """A single pair's drain: /healthz's 503 body is surfaced and a submit
    is Draining; a transport timeout is TimeoutError, not a crash."""
    sns = PKGS[server]
    eng = _Engine(version=5.0)
    batcher = sns.DynamicBatcher(eng, max_wait_ms=1.0).start()
    httpd = sns.ServeHTTPServer(("127.0.0.1", 0), eng, batcher)
    rep = tserve.HTTPReplica("h0", _serve(httpd))
    slow = _Engine(delay_s=0.5)
    slow_batcher = sns.DynamicBatcher(slow, max_wait_ms=1.0).start()
    slow_httpd = sns.ServeHTTPServer(("127.0.0.1", 0), slow, slow_batcher)
    slow_rep = tserve.HTTPReplica("h1", _serve(slow_httpd))
    try:
        h = rep.health()
        assert h["status"] == "ok" and h["replica_id"] == "r0"
        assert "batcher" in rep.stats()
        batcher.drain(timeout=5)
        assert rep.health()["status"] == "draining"
        with pytest.raises(tserve.Draining):
            rep.submit(_images(1))
        with pytest.raises(TimeoutError):
            slow_rep.submit(_images(1), timeout=0.05)
    finally:
        for s, b in ((httpd, batcher), (slow_httpd, slow_batcher)):
            s.close()
            b.drain(timeout=5)


def test_http_replica_threads_the_request_id_into_the_spans():
    tracer = SpanTracer()
    eng = _Engine()
    batcher = tserve.DynamicBatcher(eng, max_wait_ms=1.0, tracer=tracer,
                                    metric_labels={"replica": "r0"}).start()
    httpd = tserve.ServeHTTPServer(("127.0.0.1", 0), eng, batcher,
                                   replica_id="r3")
    base = _serve(httpd)
    try:
        assert jserve.HTTPReplica("h0", base).submit(
            _images(2), req="q99").shape == (2, 10)
        qw = [s for s in tracer.spans_since(0.0)
              if s["phase"] == "queue_wait"]
        assert qw and qw[0]["req"] == "q99"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.load(r)["replica_id"] == "r3"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            fams = parse_exposition(r.read().decode())
        key = (("replica", "r0"),)
        assert fams["ddp_batcher_served_total"]["samples"][
            ("ddp_batcher_served_total", key)] == 1
    finally:
        httpd.close()
        batcher.drain(timeout=5)
        tracer.close()


def test_http_server_needs_a_backend_and_a_registry_for_metrics():
    with pytest.raises(ValueError, match="needs either"):
        tserve.ServeHTTPServer(("127.0.0.1", 0))
    httpd = tserve.ServeHTTPServer(("127.0.0.1", 0),
                                   fleet=_Scripted(tserve))
    base = _serve(httpd)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/metrics", timeout=10)
        assert e.value.code == 404
    finally:
        httpd.close()


def test_install_serve_faults_parses_env_specs(monkeypatch):
    class _DummyFleet:
        def __init__(self):
            self.replicas = [_Stub(tserve, "r0"), _Stub(tserve, "r1")]
            self.snapshot_path = "nowhere"

        def _load_snapshot(self):
            raise AssertionError("not reached")

    fleet = _DummyFleet()
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)
    faults.install_serve_faults(fleet)  # unset: nothing
    monkeypatch.setenv(faults.FAULT_ENV, "crash_replica@requests=2,"
                       "replica=1;slow_forward@ms=1,replica=0")
    faults.install_serve_faults(fleet)
    fleet.replicas[1].submit(_images(1))  # request 1: still fine
    assert not fleet.replicas[1].crashed
    with pytest.raises(tserve.ReplicaCrashed):
        fleet.replicas[1].submit(_images(1))  # request 2: latched
    assert fleet.replicas[1].crashed
    with pytest.raises(tserve.ReplicaCrashed):
        fleet.replicas[1].health()  # probes fail too
    fleet.replicas[0].submit(_images(1))  # slow but serving
    assert fleet.replicas[0].served == 1
    for spec in ("sigterm@epoch=1", "explode@"):  # not the serve vocabulary
        monkeypatch.setenv(faults.FAULT_ENV, spec)
        with pytest.raises(ValueError, match="serve fault kind"):
            faults.install_serve_faults(_DummyFleet())


# -- the same lineage served by both fleets ----------------------------------

def _publish(path, params, stats, *, step, epoch, keep=3):
    """One training-side publish with the JAX package: preserve the old
    head, atomically write the new one, commit it to the manifest."""
    opt = SGDState(jax.tree_util.tree_map(jnp.zeros_like, params))
    lin = CheckpointLineage(path, keep=keep)
    lin.preserve_head()
    sha = jsave_checkpoint(path, params, stats, opt, step=step, epoch=epoch)
    lin.commit(epoch=epoch, step=step, sha256=sha)
    return sha


@pytest.fixture(scope="module")
def deepnn():
    params, stats = jget_model("deepnn").init(jax.random.key(0))
    return params, stats


def _fleets(ck, n_replicas=2, **kw):
    return {"jax": jserve.ServeFleet(ck, "deepnn", mesh=make_mesh(1),
                                     n_replicas=n_replicas, buckets=(8,),
                                     max_wait_ms=1.0, **kw),
            "torch": tserve.ServeFleet(ck, "deepnn", device="cpu",
                                       n_replicas=n_replicas, buckets=(8,),
                                       max_wait_ms=1.0, **kw)}


def _history(fleet):
    return [{k: v for k, v in e.items() if k not in ("t", "warm_s")}
            for e in fleet.stats()["swaps"]]


def test_same_lineage_served_alike_before_and_after_a_hot_swap(tmp_path,
                                                               deepnn):
    params, stats = deepnn
    ck = str(tmp_path / "ck.pt")
    _publish(ck, params, stats, step=1, epoch=0)
    fleets = _fleets(ck)
    imgs = _images(5, seed=3)
    try:
        before = {k: f.submit(imgs, timeout=30) for k, f in fleets.items()}
        np.testing.assert_allclose(before["torch"], before["jax"],
                                   rtol=1e-5, atol=1e-5)
        for f in fleets.values():
            assert f.poll_once() is None  # nothing new published
            h = f.health()
            assert h["status"] == "ok" and h["healthy_replicas"] == 2
            assert h["checkpoint_step"] == 1
        p2 = jax.tree_util.tree_map(lambda p: p * 1.5, params)
        _publish(ck, p2, stats, step=2, epoch=1)
        assert [f.poll_once() for f in fleets.values()] == \
            ["swap_commit"] * 2
        after = {k: f.submit(imgs, timeout=30) for k, f in fleets.items()}
        np.testing.assert_allclose(after["torch"], after["jax"],
                                   rtol=1e-5, atol=1e-5)
        assert not np.array_equal(after["torch"], before["torch"])
        assert _history(fleets["torch"]) == _history(fleets["jax"])
        last = _history(fleets["torch"])[-1]
        assert last["event"] == "swap_commit" and last["from_step"] == 1
        assert last["old_drained_clean"] is True
        for f in fleets.values():
            assert f.health()["checkpoint_step"] == 2
            assert all(r["swaps"] == 1 for r in f.stats()["replicas"])
        # Both fleets' health bodies and router stats carry the same keys.
        th, jh = fleets["torch"].health(), fleets["jax"].health()
        assert set(th) == set(jh)
        assert set(th["replicas"][0]) == set(jh["replicas"][0])
        assert fleets["torch"].router.stats() == fleets["jax"].router.stats()
    finally:
        for f in fleets.values():
            assert f.close() is True
            f.close()  # idempotent


def test_torn_publish_skipped_alike_then_next_publish_commits(tmp_path,
                                                               deepnn):
    params, stats = deepnn
    ck = str(tmp_path / "ck.pt")
    _publish(ck, params, stats, step=1, epoch=0)
    fleets = _fleets(ck, n_replicas=1)
    try:
        for pkg, f in fleets.items():
            FAULTS[pkg].torn_publish(f)  # tears the NEXT load, once
        _publish(ck, params, stats, step=3, epoch=1)
        assert [f.poll_once() for f in fleets.values()] == \
            ["swap_skipped"] * 2
        assert _history(fleets["torch"]) == _history(fleets["jax"])
        ev = _history(fleets["torch"])[-1]
        assert "torn" in ev["reason"] or "verifiable" in ev["reason"]
        for f in fleets.values():
            assert f.health()["checkpoint_step"] == 1  # old snapshot live
            assert f.submit(_images(3), timeout=30).shape == (3, 10)
            assert f.poll_once() is None  # the bad publish is not retried
        p4 = jax.tree_util.tree_map(lambda p: p * 0.5, params)
        _publish(ck, p4, stats, step=4, epoch=2)
        assert [f.poll_once() for f in fleets.values()] == \
            ["swap_commit"] * 2
        assert _history(fleets["torch"]) == _history(fleets["jax"])
        imgs = _images(4, seed=9)
        np.testing.assert_allclose(fleets["torch"].submit(imgs, timeout=30),
                                   fleets["jax"].submit(imgs, timeout=30),
                                   rtol=1e-5, atol=1e-5)
    finally:
        for f in fleets.values():
            f.close()


def test_fleet_refuses_bad_construction(tmp_path):
    with pytest.raises(ValueError, match="n_replicas"):
        tserve.ServeFleet(str(tmp_path / "missing.pt"), "deepnn",
                          device="cpu", n_replicas=0)
    with pytest.raises(CheckpointError, match="no checkpoint"):
        tserve.ServeFleet(str(tmp_path / "missing.pt"), "deepnn",
                          device="cpu", n_replicas=1, buckets=(8,))
    with pytest.raises(ValueError, match="'tinylm' decoder"):
        tserve.ServeFleet(str(tmp_path / "missing.pt"), "deepnn",
                          device="cpu", generate=True)
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, model, init_train_state(model).momentum, 0, 0)
    with pytest.raises(CheckpointError, match="ck.pt"):
        tserve.ServeFleet(ck, "vgg", device="cpu", n_replicas=1,
                          buckets=(8,))


# -- the chaos drill on the port ----------------------------------------------

def test_fleet_chaos_drill_replica_kill_and_swap_under_load(tmp_path,
                                                            deepnn):
    """Two replicas under concurrent load, one killed by fault injection,
    a new checkpoint hot-swapped in mid-load: zero failed requests, the
    victim ejected, the survivor serving, and the spans a valid trace."""
    params, stats = deepnn
    ck = str(tmp_path / "ck.pt")
    _publish(ck, params, stats, step=1, epoch=0)
    spill = str(tmp_path / "fleet_spill.jsonl")
    tracer = SpanTracer(spill_path=spill)
    fleet = tserve.ServeFleet(
        ck, "deepnn", device="cpu", n_replicas=2, buckets=(8,),
        max_wait_ms=1.0, tracer=tracer,
        router_kwargs=dict(health_interval_s=0.05, eject_after=2,
                           readmit_base_s=0.2, backoff_ms=5.0))
    fleet.start(poll_s=0)  # the prober on; the watcher driven by hand
    faults.crash_replica_at_request_n(fleet.replicas[0], 8)
    stop = threading.Event()
    counts = {"ok": 0, "shed": 0, "failed": 0}
    lock = threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                out = fleet.submit(_images(int(rng.integers(1, 5)),
                                           seed=seed), timeout=10)
                assert out.shape[1] == 10
                with lock:
                    counts["ok"] += 1
            except tserve.QueueFull:  # RouterShed included: backpressure
                with lock:
                    counts["shed"] += 1
                time.sleep(0.01)
            except Exception:
                with lock:
                    counts["failed"] += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.6)  # the crash fires and the victim is ejected
        p2 = jax.tree_util.tree_map(lambda p: p * 1.25, params)
        _publish(ck, p2, stats, step=5, epoch=1)
        assert fleet.poll_once() == "swap_commit"  # mid-load hot swap
        time.sleep(0.6)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert counts["failed"] == 0, counts
        assert counts["ok"] >= 20, counts
        rs = fleet.router.stats()
        assert rs["ejections"] >= 1
        per = {p["replica_id"]: p for p in rs["per_replica"]}
        assert per["r1"]["served"] > 0  # the survivor carried the load
        assert fleet.health()["checkpoint_step"] == 5
        assert fleet.stats()["swaps"][-1]["event"] == "swap_commit"
    finally:
        stop.set()
        fleet.close()
        tracer.close()
    spans = read_spill([spill])
    phases = {s["phase"] for s in spans}
    assert {"route", "eject", "swap_warm", "swap_commit"} <= phases
    assert {"forward", "queue_wait"} <= phases  # the engines traced too
    trace = to_trace_events(spans)
    assert validate_trace_events(trace) > len(spans)
    # The request that met the crash is ONE connected flow: route -> retry
    # -> queue_wait -> the joined batch's engine stages, one flow id.
    flows = request_flows(spans)
    retried = {req: f for req, f in flows.items() if f["retries"] >= 1}
    assert retried, "no request observed the injected crash"
    req, flow = next(iter(sorted(retried.items())))
    hops = [h["phase"] for h in flow["hops"]]
    assert "route" in hops and "retry" in hops and "queue_wait" in hops
    assert set(hops) & set(BATCH_PHASES) and flow["batch_steps"], flow
    chain = [e for e in trace["traceEvents"]
             if e.get("ph") in ("s", "t", "f") and e["name"] == f"req {req}"]
    assert len(chain) == len(flow["hops"])
    assert len({e["id"] for e in chain}) == 1
    assert chain[0]["ph"] == "s" and chain[-1]["ph"] == "f"
    report = format_requests_report(spans, top=len(flows))
    assert req in report and "retry" in report
    # The registry's totals are the stats() surface.
    fams = parse_exposition(fleet.registry.exposition())

    def total(name):
        return sum(fams[name]["samples"].values())

    assert total("ddp_router_ejections_total") == rs["ejections"] >= 1
    assert total("ddp_router_retries_total") == rs["retries"] >= 1
    assert total("ddp_engine_rows_served_total") > 0
    assert total("ddp_fleet_swap_commits_total") == 1
    served = fams["ddp_engine_rows_served_total"]["samples"]
    assert {dict(k[1])["replica"] for k in served} == {"r0", "r1"}


def test_engine_metric_labels_keep_the_single_engine_exposition():
    """An engine without labels registers the same unlabelled series as
    before; two labelled engines on one registry stay apart."""
    from ddp_tpu_torch.obs.registry import MetricsRegistry
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    plain = MetricsRegistry()
    eng = tserve.ServeEngine(model, device="cpu", buckets=(1, 8),
                             registry=plain)
    eng.warm()
    eng.forward(_images(3))
    text = plain.exposition()
    assert 'ddp_engine_forwards_total{bucket="8"} 1' in text
    assert "ddp_engine_rows_served_total 3" in text
    assert "ddp_engine_compiled_executables 2" in text
    shared = MetricsRegistry()
    for rid in ("r0", "r1"):
        e = tserve.ServeEngine(model, device="cpu", buckets=(1,),
                               registry=shared,
                               metric_labels={"replica": rid})
        e.warm()
        e.forward(_images(1))
    fams = parse_exposition(shared.exposition())
    assert fams["ddp_engine_forwards_total"]["samples"] == {
        ("ddp_engine_forwards_total",
         (("replica", rid), ("bucket", "1"))): 1.0 for rid in ("r0", "r1")}


# -- the entry point ----------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def test_serve_cli_fleet_with_a_crash_fault_and_sigterm(tmp_path):
    """``python -m ddp_tpu_torch.serve --fleet 2 --device cpu`` on a DeepNN
    file, with ``DDP_TPU_FAULT=crash_replica@requests=3,replica=0``: the
    fleet banner, /healthz ok with 2 healthy replicas, every request
    answered across the kill, the victim ejected in /stats and /metrics,
    and SIGTERM a clean drain with exit 0."""
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, model, init_train_state(model).momentum, 0, 0)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(OMP_NUM_THREADS="1",
               **{faults.FAULT_ENV: "crash_replica@requests=3,replica=0"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--model", "deepnn", "--fleet", "2", "--swap_poll_s", "0.5",
         "--port", "0", "--buckets", "1,8", "--snapshot_path", ck,
         "--trace_spill", ""], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving deepnn fleet of 2 on http://" in line, line
        base = line.split(" on ")[1].split(" ")[0].rstrip("/")
        health = _get(base + "/healthz")
        assert health["status"] == "ok" and health["healthy_replicas"] == 2
        assert [r["replica_id"] for r in health["replicas"]] == ["r0", "r1"]
        for k in range(8):
            req = urllib.request.Request(
                base + "/predict",
                data=json.dumps({"instances": _images(2, k).tolist()})
                .encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert len(json.load(r)["predictions"]) == 2
        deadline = time.monotonic() + 20
        while _get(base + "/stats")["router"]["ejections"] < 1:
            assert time.monotonic() < deadline, "the victim was not ejected"
            time.sleep(0.2)
        stats = _get(base + "/stats")
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            fams = parse_exposition(r.read().decode())
        assert sum(fams["ddp_router_ejections_total"]["samples"].values()) \
            == stats["router"]["ejections"]
        assert sum(fams["ddp_router_retries_total"]["samples"].values()) \
            == stats["router"]["retries"]
        assert _get(base + "/healthz")["healthy_replicas"] == 1
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "drained=clean" in err and "crashing at request 3" in err
        assert "warmed 2 replica(s)" in err and "every 0.5s" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
