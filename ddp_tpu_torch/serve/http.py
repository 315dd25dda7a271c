"""Stdlib-only threaded HTTP front end for one (engine, batcher) pair
(counterpart of ``ddp_tpu/serve/http.py`` without its fleet and generative
branches).

One ``ThreadingHTTPServer``: a thread per connection, parked in the
batcher's blocking ``submit()`` while the engine thread does the work.

- ``POST /predict``  body ``{"instances": [[...32x32x3 uint8...], ...]}``
  (one image's nested list is accepted bare) -> ``{"predictions": [...],
  "logits": [[...]]}``.  400 malformed, 413 larger than the largest bucket,
  503 shed or draining with ``Retry-After``, 504 not served in time, 500 an
  engine failure.  An ``X-Request-Id`` header rides into the spans.
- ``GET /healthz``   liveness, the live checkpoint and the identity fields
  (``replica_id``, ``checkpoint_step``, ``uptime_s``, ``queue_depth``);
  503 ``"draining"`` during a graceful shutdown.
- ``GET /stats``     engine and batcher counters (``swaps`` is an empty list:
  a single pair has no hot-swap).
- ``GET /metrics``   the same counters as Prometheus text exposition.

``POST /generate`` and ``fleet=`` are refused with :class:`NotPorted`,
which names the queue item that ports them (ROADMAP queue A12 and A9).
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

# A single pair is one replica; the fleet (ROADMAP queue A9) names them.
REPLICA_ID = "r0"

# submit() never waits forever: a lost completion would park the handler
# thread and the client indefinitely.
REQUEST_TIMEOUT_S = 60.0


class NotPorted(ServeError):
    """A serving feature of the JAX package that the port does not have
    yet; the message names its ROADMAP queue item."""


class ServeHTTPServer(ThreadingHTTPServer):
    """The listener; carries the serving pair for handler access."""

    daemon_threads = True

    def __init__(self, addr, engine: ServeEngine, batcher: DynamicBatcher,
                 *, fleet=None):
        if fleet is not None:
            raise NotPorted(
                "ServeHTTPServer(fleet=...): the serving fleet (router, "
                "replicas, hot-swap) is not ported yet (ROADMAP queue A9); "
                "front one (engine, batcher) pair")
        self.engine = engine
        self.batcher = batcher
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
        the batcher stays the caller's step."""
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

    def healthz_payload(self) -> Tuple[int, dict]:
        draining = self.batcher.draining
        return 503 if draining else 200, {
            "status": "draining" if draining else "ok",
            "replica_id": REPLICA_ID,
            "checkpoint_step": self.engine.checkpoint_step,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queue_depth": self.batcher.queue_depth(),
            "buckets": list(self.engine.buckets),
            "compiled_executables": self.engine.trace_count,
            "checkpoint": self.engine.stats()["checkpoint"],
        }

    def stats_payload(self) -> dict:
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
            self._send(200, self.server.batcher.registry.exposition()
                       .encode("utf-8"), METRICS_CONTENT_TYPE)
        else:
            self._reply(404, {"error": f"no route {self.path!r}; try "
                                       "/predict, /healthz, /stats, "
                                       "/metrics"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib naming
        if self.path == "/generate":
            self._reply(501, {"error": str(NotPorted(
                "POST /generate: generative serving (KV-cache engine, token "
                "batcher) is not ported yet (ROADMAP queue A12)"))})
            return
        if self.path != "/predict":
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
            out = self._run_predict(payload)
        except RequestTooLarge as e:
            self._reply(413, {"error": str(e)})
            return
        except (QueueFull, Draining) as e:
            self._reply(503, {"error": str(e)}, retry_after=1)
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
        logits = self.server.batcher.submit(
            images, timeout=REQUEST_TIMEOUT_S,
            req_id=self.headers.get("X-Request-Id") or None)
        return {
            "predictions": np.argmax(logits, axis=-1).astype(int).tolist(),
            "logits": [[float(v) for v in row] for row in logits],
        }
