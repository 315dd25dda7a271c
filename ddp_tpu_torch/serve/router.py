"""Front-end request router: the fleet's fault-tolerance layer
(counterpart of ``ddp_tpu/serve/router.py``, copied in full: the same
classes, rules, counters, spans and messages).

One :class:`Router` load-balances N *replica handles* (in-process
:class:`~ddp_tpu_torch.serve.fleet.LocalReplica` pairs and/or
:class:`~ddp_tpu_torch.serve.fleet.HTTPReplica` backends — anything with
the small protocol documented on :class:`Router`).  A single
``ServeEngine`` behind one HTTP listener turns every replica-level
incident into shed traffic: one crashed replica, one stalled forward, or
one checkpoint reload and clients see errors.  The router absorbs those
incidents with three mechanisms, each bounded and observable:

- **Health-driven ejection.**  A background probe thread polls every
  replica's health; ``eject_after`` consecutive failures eject it from
  rotation (an ``eject`` span + stderr event), and an ejected replica is
  re-probed on an exponential backoff until it answers again
  (``readmit`` span).  Routing never waits on a dead replica's TCP
  timeout — the probe thread pays that cost off the request path.

- **Retry with a deadline budget.**  Every request carries one deadline;
  a replica failure consumes one of ``max_retries`` bounded retries with
  jittered exponential backoff (a ``retry`` span), the breaker below is
  informed, and no attempt — first or retried — ever waits past the
  request's remaining budget.  There is no retry storm: the budget is
  per-request and spent attempts never revive.

- **Per-replica circuit breaker.**  ``breaker_trip_after`` consecutive
  failures trip the replica's breaker OPEN; after a cooldown it goes
  HALF-OPEN and admits *exactly one* probe request — success closes it,
  failure re-opens with a doubled (capped) cooldown.  The breaker
  reacts at request latency; the health prober at probe latency — a
  replica that fails requests but still answers health probes is
  contained by the breaker alone.

Graceful degradation: when nothing can take the request the router
sheds it *immediately* with a machine-actionable hint instead of letting
it time out — :class:`NoHealthyReplicas` (everything ejected/open, retry
after the soonest re-admission probe), :class:`RouterOverloaded`
(every healthy replica's admission queue full, retry after the live
backlog drains at the measured service rate), or
:class:`RouterDraining` (every candidate answered ``Draining`` twice —
a fleet mid-shutdown, not mid-swap — shed now like the single-engine
503, never spin to the deadline).  All carry ``retry_after_s`` and
subclass :class:`~ddp_tpu_torch.serve.batcher.QueueFull` so the HTTP
layer's 503 + ``Retry-After`` mapping and a load loop's shed accounting
apply unchanged.

Telemetry: ``route`` (replica selection, per routed attempt) and
``retry`` (the backoff wait) are ``overlap=True`` handler-thread spans;
``eject``/``readmit`` mark rotation changes — all visible in
``python -m ddp_tpu_torch.obs`` and the Perfetto export next to the
engine's pad/h2d/forward/d2h pipeline.  The router additionally MINTS a
request id at admission (``q<N>``) and threads it through every span and
the replica ``submit`` call, so one request — across retries, replicas
and a mid-request hot-swap — reconstructs as a single connected flow
(obs/export.py ``request_chains``; ``python -m ddp_tpu_torch.obs
--requests``).

Counters live in the shared :class:`~ddp_tpu_torch.obs.registry
.MetricsRegistry` (``ddp_router_*`` families; the legacy ``stats()``
field names are read-only views of the same children), scrapeable at
``/metrics`` when the fleet passes its registry down.
"""
from __future__ import annotations

import random
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from .batcher import Draining, QueueFull
from .engine import RequestTooLarge, ServeError

_BREAKER_STATE_CODE = {"closed": 0.0, "half-open": 1.0, "open": 2.0}


class ReplicaCrashed(ServeError):
    """A replica died mid-request (process gone, engine wedged, fault
    injection) — retryable on another replica, breaker-countable."""


class RouterShed(QueueFull):
    """Shed at the ROUTER with a derived ``Retry-After`` — subclasses
    :class:`QueueFull` so every existing 503-with-backpressure mapping
    (http.py, load loops) treats it as a shed, never a failure."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = max(float(retry_after_s), 1.0)


class NoHealthyReplicas(RouterShed):
    """Every replica is ejected or breaker-open; ``retry_after_s`` is the
    soonest re-admission probe."""


class RouterOverloaded(RouterShed):
    """Every healthy replica's admission queue is full; ``retry_after_s``
    is the live backlog divided by the measured service rate."""


class RouterDraining(RouterShed, Draining):
    """Every candidate replica answered ``Draining`` repeatedly — the
    fleet is shutting down, not mid-swap.  Subclasses both
    :class:`RouterShed` (503 + ``Retry-After``, shed accounting) and
    :class:`~ddp_tpu_torch.serve.batcher.Draining` (single-engine parity for
    callers that catch the drain specifically)."""


class CircuitBreaker:
    """Consecutive-failure circuit: CLOSED -> OPEN -> HALF-OPEN -> CLOSED.

    ``allow()`` is the gate the router consults per attempt: always True
    when CLOSED; False while OPEN (until the cooldown expires); in
    HALF-OPEN it returns True exactly once (the single probe) and False
    until that probe's outcome is recorded.  A failure while HALF-OPEN
    (or ``trip_after`` consecutive failures while CLOSED) re-opens with
    an exponentially doubled cooldown, capped at ``cooldown_max_s``;
    any success snaps back to CLOSED and resets the backoff.
    """

    def __init__(self, trip_after: int = 3, cooldown_s: float = 1.0,
                 cooldown_max_s: float = 30.0):
        if trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got {trip_after}")
        self._lock = threading.Lock()
        self._base_cooldown_s = float(cooldown_s)
        self._cooldown_max_s = float(cooldown_max_s)
        self.trip_after = int(trip_after)
        self.state = "closed"
        self.failures = 0
        self.trips = 0

        self._cooldown_s = float(cooldown_s)
        self._open_until = 0.0
        self._probe_out = False

    def allow(self) -> bool:
        """May a request go to this replica NOW?  Claims the single
        half-open probe slot when it grants one."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.monotonic() < self._open_until:
                    return False
                self.state = "half-open"
                self._probe_out = False
            # half-open: exactly one in-flight probe.
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self._probe_out = False
            self._cooldown_s = self._base_cooldown_s

    def release_probe(self) -> None:
        """Release the half-open probe slot WITHOUT recording an outcome.

        The router calls this when an attempt exits through a path that
        says nothing about replica health — QueueFull, Draining, or the
        client's own bad request.  Without it a granted probe whose
        attempt never reached the replica's forward would leave
        ``_probe_out`` latched True and ``allow()`` False forever: the
        replica would be silently removed from rotation with no breaker
        trip and no ejection to recover from."""
        with self._lock:
            self._probe_out = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half-open" or (
                    self.state == "closed"
                    and self.failures >= self.trip_after):
                self.state = "open"
                self._open_until = time.monotonic() + self._cooldown_s
                self._cooldown_s = min(self._cooldown_s * 2.0,
                                       self._cooldown_max_s)
                self._probe_out = False
                self.trips += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "trips": self.trips,
                    "cooldown_s": round(self._cooldown_s, 3)}


class _ReplicaState:
    """Router-side bookkeeping for one replica handle (no thread of its
    own; every field is touched under the owning Router's ``_lock``)."""

    def __init__(self, replica, breaker: CircuitBreaker):
        self.replica = replica
        self.breaker = breaker
        self.ejected = False
        self.health_failures = 0
        self.ejections = 0
        self.readmit_at = 0.0           # monotonic; next probe time
        self.readmit_backoff_s = 0.0
        self.served = 0
        self.failed = 0


class Router:
    """Load balancer + failure absorber over a fixed replica set.

    Replica protocol (duck-typed; LocalReplica/HTTPReplica implement it):

    - ``replica_id``            stable string id
    - ``submit(images, timeout=...)``  -> logits (raises ServeError/...)
    - ``health()``              -> dict with ``status`` (raises when dead)
    - ``queue_depth()``         -> int (requests waiting at admission)
    - ``stats()``               -> dict (for /stats aggregation)

    ``submit`` is the one request entry point, thread-safe; the health
    prober runs on an internal daemon thread between :meth:`start` and
    :meth:`close` (tests may instead call :meth:`health_tick` directly
    for determinism).
    """

    def __init__(self, replicas, *, max_retries: int = 2,
                 backoff_ms: float = 25.0,
                 default_timeout_s: float = 30.0,
                 health_interval_s: float = 0.5,
                 eject_after: int = 2,
                 readmit_base_s: float = 0.5,
                 readmit_max_s: float = 30.0,
                 breaker_trip_after: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 tracer=None, seed: int = 0, registry=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a router needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.max_retries = max(int(max_retries), 0)
        self.backoff_s = max(float(backoff_ms), 0.0) / 1e3
        self.default_timeout_s = float(default_timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.eject_after = max(int(eject_after), 1)
        self.readmit_base_s = float(readmit_base_s)
        self.readmit_max_s = float(readmit_max_s)
        self.tracer = tracer if tracer is not None else get_tracer()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._states: Dict[str, _ReplicaState] = {
            rid: _ReplicaState(r, CircuitBreaker(
                trip_after=breaker_trip_after,
                cooldown_s=breaker_cooldown_s))
            for rid, r in zip(ids, replicas)}
        self._order = ids                 # fixed rotation order
        self._rr = 0
        self._seq = 0
        self._req_seq = 0
        # Counters live in the metrics registry (internally locked); a
        # private registry by default keeps instances isolated — the
        # fleet passes its shared one so /metrics sees the router.
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self._c_routed = self.registry.counter(
            "ddp_router_routed_total",
            "Routing decisions (one per pick round)").labels()
        self._c_retries = self.registry.counter(
            "ddp_router_retries_total",
            "Retry/re-route waits taken inside request budgets").labels()
        self._c_ejections = self.registry.counter(
            "ddp_router_ejections_total",
            "Replicas ejected from rotation by the health prober").labels()
        self._c_readmissions = self.registry.counter(
            "ddp_router_readmissions_total",
            "Ejected replicas re-admitted after a healthy probe").labels()
        shed = self.registry.counter(
            "ddp_router_shed_total",
            "Requests shed at the router, by RouterShed class",
            labelnames=("reason",))
        self._c_shed_no_replicas = shed.labels(reason="no_replicas")
        self._c_shed_overloaded = shed.labels(reason="overloaded")
        self._c_shed_draining = shed.labels(reason="draining")
        self._c_migrations = self.registry.counter(
            "ddp_router_session_migrations_total",
            "Sticky generative sessions re-pinned to a different replica "
            "(KV cache recomputed by full-history prefill)").labels()
        # session id -> replica id, insertion-ordered for LRU eviction.

        self._sessions: Dict[str, str] = {}
        self._max_sessions = 4096
        self.registry.gauge(
            "ddp_router_sessions",
            "Sticky generative sessions currently pinned").labels(
        ).set_function(lambda: float(len(self._sessions)))
        breaker_g = self.registry.gauge(
            "ddp_router_breaker_state",
            "Per-replica circuit state (0 closed, 1 half-open, 2 open)",
            labelnames=("replica",))
        served_c = self.registry.counter(
            "ddp_router_replica_served_total",
            "Requests served, per replica", labelnames=("replica",))
        failed_c = self.registry.counter(
            "ddp_router_replica_failed_total",
            "Requests failed, per replica", labelnames=("replica",))
        for rid in self._order:
            st = self._states[rid]
            breaker_g.labels(replica=rid).set_function(
                lambda b=st.breaker:
                _BREAKER_STATE_CODE[b.snapshot()["state"]])
            served_c.labels(replica=rid).set_function(
                lambda s=st: float(s.served))
            failed_c.labels(replica=rid).set_function(
                lambda s=st: float(s.failed))
        # Completion timestamps (monotonic) of recently served requests —
        # the live service-rate estimate Retry-After is derived from.

        self._served_t: List[float] = []
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    # Legacy counter names: read-only views of the registry children, so
    # stats() consumers and tests keep their field names while /metrics
    # and /stats can never disagree (one storage).
    @property
    def routed(self) -> int:
        return int(self._c_routed.value)

    @property
    def retries(self) -> int:
        return int(self._c_retries.value)

    @property
    def ejections(self) -> int:
        return int(self._c_ejections.value)

    @property
    def readmissions(self) -> int:
        return int(self._c_readmissions.value)

    @property
    def shed_no_replicas(self) -> int:
        return int(self._c_shed_no_replicas.value)

    @property
    def shed_overloaded(self) -> int:
        return int(self._c_shed_overloaded.value)

    @property
    def shed_draining(self) -> int:
        return int(self._c_shed_draining.value)

    # -- request path ------------------------------------------------------

    def submit(self, images, timeout: Optional[float] = None):
        """Route ``images`` to a healthy replica inside one deadline
        budget; bounded jittered retries on replica failure; immediate
        re-route (no budget charge) when a replica is draining mid-swap;
        shed with a derived ``Retry-After`` when nothing can take it.

        Mints the request id at admission; every span this request emits
        (here and downstream in the batcher) carries it."""
        out, _ = self._route(
            lambda st, remaining, req: st.replica.submit(
                images, timeout=remaining, req=req), timeout)
        return out

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None,
                 session: Optional[str] = None):
        """Route one generative stream — same deadline/retry/shed
        machinery as :meth:`submit`, plus STICKY sessions: a ``session``
        id pins to the replica that served it last, so a multi-turn
        conversation keeps hitting the replica holding its KV-cache
        slots warm.  The pin is a PREFERENCE, not a guarantee: when the
        pinned replica is ejected, breaker-open, full, or fails
        mid-stream, the request re-routes like any other and the session
        re-pins to whichever replica served it — a MIGRATION (counted,
        logged).  Correctness never depends on the pin because every
        request carries its full token history and a migrated stream
        simply re-prefills on the new replica (recompute-on-migrate;
        the mid-stream replica-crash chaos drill pins zero failed
        streams on exactly this path)."""
        prefer = None
        if session is not None:
            with self._lock:
                prefer = self._sessions.get(session)

        def send(st, remaining, req):
            return st.replica.generate(
                prompt, max_new_tokens=max_new_tokens, timeout=remaining,
                req=req, session=session)

        out, rid = self._route(send, timeout, prefer=prefer)
        if session is not None:
            with self._lock:
                prev = self._sessions.pop(session, None)
                self._sessions[session] = rid  # re-insert: LRU order
                if len(self._sessions) > self._max_sessions:
                    self._sessions.pop(next(iter(self._sessions)))
            if prev is not None and prev != rid:
                self._c_migrations.inc()
                _log(f"router: session {session!r} migrated {prev} -> "
                     f"{rid} (KV cache recomputed by full-history "
                     "prefill)")
        return out

    def session_replica(self, session: str) -> Optional[str]:
        """The replica id ``session`` is currently pinned to (None when
        unknown) — the /stats sticky-routing assertion surface."""
        with self._lock:
            return self._sessions.get(session)

    def _route(self, send, timeout: Optional[float],
               prefer: Optional[str] = None):
        """The shared routing loop: returns ``(result, replica_id)``.
        ``send(state, remaining_s, req_id)`` performs one attempt on one
        replica; ``prefer`` (a replica id) is tried first when healthy
        and claimable — the sticky-session hint."""
        deadline = time.monotonic() + (self.default_timeout_s
                                       if timeout is None else
                                       max(float(timeout), 0.0))
        with self._lock:
            self._req_seq += 1
            req = f"q{self._req_seq}"
        failures = 0
        full: set = set()   # replicas that answered QueueFull this request
        failed_on: set = set()  # replicas that FAILED this request already
        drained: set = set()    # replicas that answered Draining TWICE
        drain_hits: Dict[str, int] = {}
        last_err: Optional[BaseException] = None
        tried_prefer = prefer is None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"deadline budget exhausted after {failures} "
                    f"failure(s); last error: {last_err!r}")
            st = seq = None
            if not tried_prefer:
                # Sticky hint: ONE shot at the pinned replica, claimed
                # through the same breaker gate as any pick; every
                # subsequent round falls through to normal routing.
                tried_prefer = True
                st, seq = self._pick_preferred(
                    prefer, exclude=full | failed_on | drained, req=req)
            if st is None:
                st, seq = self._pick(exclude=full | failed_on | drained,
                                     req=req)
            if st is None and failed_on:
                # Every untried replica is out; retrying the one that
                # already failed this request beats shedding it (a
                # crashed replica has an empty queue and would otherwise
                # keep winning least-loaded until its breaker trips).
                st, seq = self._pick(exclude=full | drained, req=req)
            if st is None:
                if full:
                    # Healthy replicas exist but every one of them is at
                    # admission capacity: shed NOW with the backlog-drain
                    # estimate, not a timeout 30 s from now.
                    self._c_shed_overloaded.inc()
                    raise RouterOverloaded(
                        f"all {len(full)} healthy replica(s) at admission "
                        "capacity; retry after backoff",
                        self._overload_retry_after())
                if drained:
                    # Every candidate answered Draining twice: the fleet
                    # is shutting down (a mid-swap replica serves again
                    # on its FIRST re-route).  Shed NOW like the
                    # single-engine 503 instead of busy-spinning retry
                    # spans until the deadline turns this into a 500.
                    self._c_shed_draining.inc()
                    raise RouterDraining(
                        f"all {len(drained)} candidate replica(s) "
                        "draining (fleet shutting down); retry shortly",
                        1.0)
                self._c_shed_no_replicas.inc()
                raise NoHealthyReplicas(
                    "no healthy replicas (all ejected or circuit-open); "
                    "retry after the next re-admission probe",
                    self._readmit_retry_after())
            try:
                out = send(st, remaining, req)
            except (ValueError, TypeError, RequestTooLarge):
                # The CLIENT's error: no retry, no breaker hit — but a
                # granted half-open probe slot must not stay latched.
                st.breaker.release_probe()
                raise
            except QueueFull:
                # Backpressure, not failure: try the other replicas with
                # no budget charge; all-full is handled above.
                st.breaker.release_probe()
                full.add(st.replica.replica_id)
                continue
            except Draining:
                # The replica is mid-hot-swap or shutting down — its old
                # batcher flushed this request un-served.  Not a fault of
                # the replica: re-route at once (a tiny jittered pause
                # keeps a swap transition from becoming a hot spin).  A
                # SECOND Draining from the same replica means it is
                # retiring, not swapping (a swap re-admits on the new
                # pair immediately): exclude it; all-excluded sheds
                # RouterDraining above.
                st.breaker.release_probe()
                rid = st.replica.replica_id
                drain_hits[rid] = drain_hits.get(rid, 0) + 1
                if drain_hits[rid] >= 2:
                    drained.add(rid)
                self._c_retries.inc()
                with self._lock:
                    pause = self._rng.uniform(0.0, 0.005)
                with self.tracer.span("retry", overlap=True, req=req):
                    time.sleep(min(pause, max(remaining, 0.0)))
                continue
            except TimeoutError as e:
                # The budget died inside the replica; record the failure
                # for the breaker but there is nothing left to retry with.
                st.breaker.record_failure()
                with self._lock:
                    st.failed += 1
                raise TimeoutError(
                    f"replica {st.replica.replica_id} exceeded the "
                    f"deadline budget: {e}") from e
            except Exception as e:
                # Replica-side failure (crash, wedged engine, transport):
                # breaker-countable, retryable within the budget.
                st.breaker.record_failure()
                last_err = e
                failures += 1
                failed_on.add(st.replica.replica_id)
                with self._lock:
                    st.failed += 1
                if failures > self.max_retries:
                    raise
                self._c_retries.inc()
                with self._lock:
                    # Jittered exponential backoff, never past deadline.
                    pause = (self.backoff_s * (2 ** (failures - 1))
                             * self._rng.uniform(0.5, 1.5))
                with self.tracer.span("retry", step=seq, overlap=True,
                                      req=req):
                    time.sleep(min(pause,
                                   max(deadline - time.monotonic(), 0.0)))
                # Queues drain during the backoff: re-admit replicas that
                # were merely full so the post-backoff pick can prefer a
                # momentarily-full replica over the one that just FAILED.
                full.clear()
                continue
            st.breaker.record_success()
            with self._lock:
                st.served += 1
                self._served_t.append(time.monotonic())
                if len(self._served_t) > 512:
                    del self._served_t[:256]
            return out, st.replica.replica_id

    def _pick_preferred(self, rid: str, exclude: set,
                        req: Optional[str] = None
                        ) -> Tuple[Optional["_ReplicaState"], Optional[int]]:
        """The sticky-session pick: the pinned replica or nothing.  Same
        gates as :meth:`_pick` — ejection, per-request exclusion, and the
        breaker's ``allow()`` claim — so a pin can never resurrect a
        replica routing would refuse."""
        with self.tracer.span("route", overlap=True, req=req):
            self._c_routed.inc()
            with self._lock:
                self._seq += 1
                seq = self._seq
                st = self._states.get(rid)
            if (st is not None and not st.ejected and rid not in exclude
                    and st.breaker.allow()):
                return st, seq
            return None, seq

    def _pick(self, exclude: set, req: Optional[str] = None
              ) -> Tuple[Optional[_ReplicaState], Optional[int]]:
        """Least-loaded healthy replica (round-robin tie-break), CLOSED
        breakers first; a replica whose breaker is OPEN-past-cooldown or
        HALF-OPEN is only picked when no CLOSED one exists, and claiming
        its single probe slot happens HERE (``allow()``), so probing N
        candidates never leaks N probes.  Recorded as a ``route`` span."""
        with self.tracer.span("route", overlap=True, req=req):
            self._c_routed.inc()
            with self._lock:
                self._seq += 1
                seq = self._seq
                rr = self._rr
                self._rr += 1
                live = [self._states[rid]
                        for rid in (self._order[rr % len(self._order):]
                                    + self._order[:rr % len(self._order)])
                        if not self._states[rid].ejected
                        and rid not in exclude]
            closed = [st for st in live
                      if st.breaker.snapshot()["state"] == "closed"]
            for st in sorted(closed, key=lambda s: s.replica.queue_depth()):
                if st.breaker.allow():
                    return st, seq
            for st in live:     # open/half-open: first claimable probe
                if st.breaker.allow():
                    return st, seq
            return None, seq

    # -- shed math ---------------------------------------------------------

    def _overload_retry_after(self) -> float:
        """Live backlog / measured service rate: how long until the
        queues now standing have drained, clamped to [1, 60] s."""
        depth = 0
        with self._lock:
            states = list(self._states.values())
            now = time.monotonic()
            recent = [t for t in self._served_t if now - t <= 5.0]
        for st in states:
            if not st.ejected:
                try:
                    depth += st.replica.queue_depth()
                except Exception:
                    pass
        rate = len(recent) / 5.0 if recent else 0.0
        if rate <= 0:
            return 1.0
        return min(max(depth / rate, 1.0), 60.0)

    def _readmit_retry_after(self) -> float:
        with self._lock:
            etas = [st.readmit_at for st in self._states.values()
                    if st.ejected]
        if not etas:
            return 1.0
        return min(max(min(etas) - time.monotonic(), 1.0), 60.0)

    # -- health prober -----------------------------------------------------

    def start(self) -> "Router":
        """Start the background health prober (idempotent)."""
        if self._health_thread is None:
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="router-health")
            self._health_thread.start()
        return self

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self.health_tick()
            except Exception as e:    # the prober must never die silently
                print(f"WARNING: router health tick failed "
                      f"({type(e).__name__}: {e}); next tick continues",
                      file=sys.stderr)

    def health_tick(self) -> None:
        """One probe round over every replica — the health loop's body,
        callable directly (tests, single-threaded embedders)."""
        now = time.monotonic()
        with self._lock:
            states = [self._states[rid] for rid in self._order]
        for st in states:
            with self._lock:
                if st.ejected and now < st.readmit_at:
                    continue
                ejected = st.ejected
            ok = self._probe(st)
            if ejected and ok:
                with self.tracer.span("readmit"):
                    with self._lock:
                        st.ejected = False
                        st.health_failures = 0
                        st.readmit_backoff_s = 0.0
                    self._c_readmissions.inc()
                st.breaker.record_success()   # give it requests again
                _log(f"router: replica {st.replica.replica_id} healthy "
                     "again; READMITTED to rotation")
            elif ejected and not ok:
                with self._lock:
                    st.readmit_backoff_s = min(
                        max(st.readmit_backoff_s * 2.0,
                            self.readmit_base_s),
                        self.readmit_max_s)
                    st.readmit_at = time.monotonic() + st.readmit_backoff_s
            elif not ejected and not ok:
                with self._lock:
                    st.health_failures += 1
                    trip = st.health_failures >= self.eject_after
                if trip:
                    with self.tracer.span("eject"):
                        with self._lock:
                            st.ejected = True
                            st.ejections += 1
                            st.readmit_backoff_s = self.readmit_base_s
                            st.readmit_at = (time.monotonic()
                                             + st.readmit_backoff_s)
                    self._c_ejections.inc()
                    _log(f"router: replica {st.replica.replica_id} failed "
                         f"{self.eject_after} consecutive health probes; "
                         "EJECTED from rotation (re-admission probes "
                         "backing off exponentially)")
            else:
                with self._lock:
                    st.health_failures = 0

    @staticmethod
    def _probe(st: _ReplicaState) -> bool:
        try:
            h = st.replica.health()
        except Exception:
            return False
        return isinstance(h, dict) and h.get("status") == "ok"

    # -- introspection / lifecycle ----------------------------------------

    def healthy_count(self) -> int:
        """Replicas currently routable (not ejected, breaker not open),
        from the router's own state — no probe round trips, so the
        fleet's rollup gauge can read it on every scrape."""
        with self._lock:
            states = [self._states[rid] for rid in self._order]
            ejected = {id(st) for st in states if st.ejected}
        return sum(1 for st in states
                   if id(st) not in ejected
                   and st.breaker.snapshot()["state"] != "open")

    def replica_health(self) -> List[dict]:
        """Best-effort health of every replica (dead ones reported, not
        raised) — the fleet /healthz body."""
        out = []
        with self._lock:
            states = [self._states[rid] for rid in self._order]
        for st in states:
            try:
                h = dict(st.replica.health())
            except Exception as e:
                h = {"status": "dead", "replica_id": st.replica.replica_id,
                     "error": f"{type(e).__name__}: {e}"}
            with self._lock:
                h["ejected"] = st.ejected
            h["breaker"] = st.breaker.snapshot()["state"]
            out.append(h)
        return out

    def stats(self) -> dict:
        with self._lock:
            base = {
                "replicas": len(self._order),
                "routed": self.routed,
                "retries": self.retries,
                "ejections": self.ejections,
                "readmissions": self.readmissions,
                "shed_no_replicas": self.shed_no_replicas,
                "shed_overloaded": self.shed_overloaded,
                "shed_draining": self.shed_draining,
                "sessions": dict(self._sessions),
                "session_migrations": int(self._c_migrations.value),
            }
            per = [(st, st.ejected, st.served, st.failed, st.ejections)
                   for st in (self._states[rid] for rid in self._order)]
        base["per_replica"] = [{
            "replica_id": st.replica.replica_id,
            "ejected": ejected,
            "served": served,
            "failed": failed,
            "ejections": ejections,
            "breaker": st.breaker.snapshot(),
            "queue_depth": _safe_depth(st.replica),
        } for st, ejected, served, failed, ejections in per]
        return base

    def close(self) -> None:
        """Stop the health prober (idempotent; replicas are owned and
        closed by the fleet, not the router)."""
        self._stop.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout=10.0)
            self._health_thread = None


def _safe_depth(replica) -> Optional[int]:
    try:
        return int(replica.queue_depth())
    except Exception:
        return None


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.stderr.flush()
