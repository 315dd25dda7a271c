"""Stdlib-only threaded HTTP front end for the serving stack
(counterpart of ``ddp_tpu/serve/http.py``).

One ``ThreadingHTTPServer``: a thread per connection, parked in the
backend's blocking ``submit()`` while the engine threads do the work.
The same listener fronts either backend: one (engine, batcher) pair, or a
:class:`~ddp_tpu_torch.serve.fleet.ServeFleet` (``fleet=``), through the
server's ``submit``/``healthz_payload``/``stats_payload`` indirection.

- ``POST /predict``  body ``{"instances": [[...32x32x3 uint8...], ...]}``
  (one image's nested list is accepted bare) -> ``{"predictions": [...],
  "logits": [[...]]}``.  400 malformed, 413 larger than the largest bucket,
  503 shed or draining with ``Retry-After`` (a router's shed carries its
  derived ``retry_after_s``; the batcher's backpressure 1 s), 504 not
  served in time, 500 an engine failure.  A draining 503's message says
  "draining", which is how either package's ``HTTPReplica`` tells it from
  a full queue.  On a single pair an ``X-Request-Id`` header rides into
  the spans; a fleet's router mints its own id at admission.
- ``POST /generate`` body ``{"prompt": [token ids], "max_new_tokens": N?,
  "session": "id"?}`` -> ``{"tokens": [generated ids], "prompt_len": n,
  "ttft_ms": float}``: the ``tinylm`` decoder behind a KV-cache engine and
  a token batcher (``serve/kvcache.py``, ``serve/token_batcher.py``), the
  same status codes as ``/predict``; ``session`` is a fleet router's
  sticky-routing key.  A server fronting a classifier answers 400.
- ``GET /healthz``   liveness, the live checkpoint and the identity fields
  (``replica_id``, ``checkpoint_step``, ``uptime_s``, ``queue_depth``);
  503 ``"draining"`` during a graceful shutdown.  On a fleet the fleet's
  health: 503 unless ``"ok"`` (``"unavailable"`` or ``"draining"``).
- ``GET /stats``     engine and batcher counters (``swaps`` is an empty list:
  a single pair has no hot-swap); on a fleet the router's, each
  replica's and the swap history.
- ``GET /metrics``   the same counters as Prometheus text exposition: the
  pair's registry, or the fleet's shared one (replica-labelled series).

:class:`NotPorted` is the error of a serving feature the port does not
have yet, named with its ROADMAP item (the fleet's serving model axis,
A12b).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..obs.registry import CONTENT_TYPE as METRICS_CONTENT_TYPE
from .batcher import Draining, DynamicBatcher, QueueFull
from .engine import RequestTooLarge, ServeEngine, ServeError

# Request-body bound: the largest sane request is max_rows * 32*32*3 bytes
# of pixels, JSON-inflated ~4x; 64 MiB covers a 1024-row bucket.
MAX_BODY_BYTES = 64 << 20

# submit() never waits forever: a lost completion would park the handler
# thread and the client indefinitely.
REQUEST_TIMEOUT_S = 60.0


class NotPorted(ServeError):
    """A serving feature of the JAX package that the port does not have
    yet; the message names its ROADMAP queue item."""


class ServeHTTPServer(ThreadingHTTPServer):
    """The listener; carries the serving stack for handler access."""

    daemon_threads = True

    def __init__(self, addr, engine: Optional[ServeEngine] = None,
                 batcher: Optional[DynamicBatcher] = None, *, fleet=None,
                 replica_id: str = "r0"):
        if fleet is None and (engine is None or batcher is None):
            raise ValueError(
                "ServeHTTPServer needs either (engine, batcher) or fleet=")
        self.engine = engine
        self.batcher = batcher
        self.fleet = fleet
        self.replica_id = replica_id
        self._t0 = time.monotonic()
        # close() latch: signal handlers and drain paths both call it; a
        # shutdown() of a listener whose serve_forever never ran would
        # block forever, hence _started.
        self._closed = threading.Event()
        self._started = threading.Event()
        super().__init__(addr, _Handler)

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._started.set()
        super().serve_forever(poll_interval)

    def close(self) -> None:
        """Idempotent listener teardown, safe to call twice: the first call
        stops ``serve_forever`` (if it ran) and closes the socket.  Draining
        the batcher or the fleet stays the caller's step."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._started.is_set():
            try:
                self.shutdown()
            except Exception:
                pass  # already stopping; teardown must not raise
        try:
            self.server_close()
        except OSError:
            pass  # socket already closed

    # -- backend indirection (single pair vs fleet) ------------------------

    def submit(self, images: np.ndarray, timeout: float,
               req_id: Optional[str] = None) -> np.ndarray:
        if self.fleet is not None:
            # The router mints the canonical request id at admission.
            return self.fleet.submit(images, timeout=timeout)
        return self.batcher.submit(images, timeout=timeout, req_id=req_id)

    def generate(self, prompt, max_new_tokens: Optional[int],
                 timeout: float, session: Optional[str] = None,
                 req_id: Optional[str] = None) -> dict:
        if self.fleet is not None:
            return self.fleet.generate(prompt,
                                       max_new_tokens=max_new_tokens,
                                       timeout=timeout, session=session)
        if not hasattr(self.batcher, "generate"):
            raise TypeError(
                "this server fronts a classifier; start it with "
                "--generate (models/transformer.py decoder) for "
                "/generate")
        return self.batcher.generate(prompt,
                                     max_new_tokens=max_new_tokens,
                                     timeout=timeout, req_id=req_id,
                                     session=session)

    def metrics_exposition(self) -> Optional[str]:
        """Prometheus text for ``/metrics``: the fleet's shared registry
        when fronting a fleet, else the pair's; None when the backend
        carries none (a hand-made stand-in)."""
        backend = self.fleet if self.fleet is not None else self.batcher
        reg = getattr(backend, "registry", None)
        return reg.exposition() if reg is not None else None

    def healthz_payload(self) -> Tuple[int, dict]:
        if self.fleet is not None:
            h = self.fleet.health()
            return (200 if h["status"] == "ok" else 503), h
        draining = self.batcher.draining
        return 503 if draining else 200, {
            "status": "draining" if draining else "ok",
            "replica_id": self.replica_id,
            "checkpoint_step": getattr(self.engine, "checkpoint_step",
                                       None),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queue_depth": self.batcher.queue_depth(),
            "buckets": list(self.engine.buckets),
            "compiled_executables": self.engine.trace_count,
            "checkpoint": self.engine.stats()["checkpoint"],
        }

    def stats_payload(self) -> dict:
        if self.fleet is not None:
            return self.fleet.stats()
        return {"engine": self.engine.stats(),
                "batcher": self.batcher.stats(),
                "swaps": []}


class _Handler(BaseHTTPRequestHandler):
    server: ServeHTTPServer

    # A client that sends headers and then stalls the body must not park a
    # handler thread forever in rfile.read().
    timeout = 60

    def log_message(self, fmt, *args):  # noqa: D102 — stdlib signature
        pass  # no access log: the spans and /metrics record each request

    def _send(self, status: int, body: bytes, content_type: str,
              retry_after: Optional[int] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client gave up

    def _reply(self, status: int, payload: dict,
               retry_after: Optional[int] = None) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json",
                   retry_after)

    def do_GET(self) -> None:  # noqa: N802 — stdlib naming
        if self.path == "/healthz":
            self._reply(*self.server.healthz_payload())
        elif self.path == "/stats":
            self._reply(200, self.server.stats_payload())
        elif self.path == "/metrics":
            text = self.server.metrics_exposition()
            if text is None:
                self._reply(404, {"error": "no metrics registry on this "
                                           "server's backend"})
                return
            self._send(200, text.encode("utf-8"), METRICS_CONTENT_TYPE)
        else:
            self._reply(404, {"error": f"no route {self.path!r}; try "
                                       "/predict, /generate, /healthz, "
                                       "/stats, /metrics"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib naming
        if self.path not in ("/predict", "/generate"):
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length <= 0 or length > MAX_BODY_BYTES:
            self._reply(400, {"error": f"Content-Length must be in "
                                       f"(0, {MAX_BODY_BYTES}]"})
            return
        try:
            payload = json.loads(self.rfile.read(length))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._reply(400, {"error": f"body is not valid JSON: {e}"})
            return
        try:
            if self.path == "/generate":
                out = self._run_generate(payload)
            else:
                out = self._run_predict(payload)
        except RequestTooLarge as e:
            self._reply(413, {"error": str(e)})
            return
        except (QueueFull, Draining) as e:
            # A router's shed carries a retry_after_s derived from live
            # queue depth or the re-admission ETA; the batcher's
            # backpressure keeps the fixed 1 s hint.
            self._reply(503, {"error": str(e)}, retry_after=max(
                1, round(getattr(e, "retry_after_s", 1))))
            return
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:
            # An engine failure reaches every co-batched caller through
            # req.error: answer it as a 5xx, never a reset socket.
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, out)

    def _run_predict(self, payload) -> dict:
        instances = (payload.get("instances")
                     if isinstance(payload, dict) else payload)
        images = np.asarray(instances)
        if images.ndim == 3:  # one bare image
            images = images[None]
        if not np.issubdtype(images.dtype, np.integer) or \
                images.min() < 0 or images.max() > 255:
            raise ValueError(
                "pixel values must be integers in [0, 255] (uint8 — "
                "the training loaders' wire format)")
        images = images.astype(np.uint8)
        logits = self.server.submit(
            images, timeout=REQUEST_TIMEOUT_S,
            req_id=self.headers.get("X-Request-Id") or None)
        return {
            "predictions": np.argmax(logits, axis=-1).astype(int).tolist(),
            "logits": [[float(v) for v in row] for row in logits],
        }

    def _run_generate(self, payload) -> dict:
        """Body ``{"prompt": [ids], "max_new_tokens": N?, "session":
        id?}`` -> ``{"tokens": [...], "prompt_len": n, "ttft_ms":
        float}``.  The session key is the router's sticky-routing handle;
        a single pair accepts and records it."""
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ValueError(
                'body must be {"prompt": [token ids], "max_new_tokens"?, '
                '"session"?}')
        max_new = payload.get("max_new_tokens")
        if max_new is not None:
            max_new = int(max_new)
        session = payload.get("session")
        if session is not None and not isinstance(session, str):
            raise ValueError("session must be a string id")
        return self.server.generate(
            payload["prompt"], max_new, timeout=REQUEST_TIMEOUT_S,
            session=session,
            req_id=self.headers.get("X-Request-Id") or None)
