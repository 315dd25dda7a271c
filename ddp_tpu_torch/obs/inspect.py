"""Live run introspection (counterpart of ``ddp_tpu/obs/inspect.py``): the
rank-0 HTTP endpoints, the periodic ``.prom`` file and the on-demand
profile trigger.  None of it is built unless a flag asks for it, and with
``--inspect_port`` unset the run binds no socket.

- :class:`InspectServer`, a ``ThreadingHTTPServer`` on ``--inspect_port``
  (rank 0, loopback), serving ``GET /metrics`` (the registry's exposition,
  which ``obs.registry.parse_exposition`` reads back), ``GET /healthz``
  (the run's state: step, epoch, the guard's last decision, the mirror's
  lag, the watchdog's last beat, prefetch occupancy; the snapshot the
  flight recorder bundles), ``GET /spans`` (the tracer's ring) and ``GET
  /debug/profile?steps=N`` (arms the trigger);
- :class:`ProfileTrigger`, which captures the next N optimizer steps' spans
  into ``profile_capture_step<S>.json`` and, where the card is there and
  ``--profile_dir`` does not own the profiler already, a
  ``torch.profiler`` session of CPU and CUDA activity over the same steps,
  exported as a Chrome trace into ``profile_trace_step<S>/``; armed over
  HTTP or by SIGUSR1 (:func:`install_sigusr1`);
- :class:`PromFileWriter`, which rewrites ``<metrics_path>.prom`` every
  ``--log_every`` optimizer steps through
  :func:`~ddp_tpu_torch.obs.blackbox.atomic_write_text`, so a concurrent
  reader sees the previous complete exposition or the new one, never a
  torn file.

The training loop sees one bounded call an optimizer step (the trainer's
``step_probe``).
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional
from urllib.parse import parse_qs, urlsplit

from .blackbox import atomic_write_text
from .registry import CONTENT_TYPE, MetricsRegistry

# SIGUSR1 carries no step count: it captures a fixed window.
SIGUSR1_PROFILE_STEPS = 16
TRACE_FILE = "trace.json"


class PromFileWriter:
    """The periodic crash-atomic ``<metrics_path>.prom`` rewrite.

    ``step(n)`` is a step probe: it rewrites when ``n`` crosses the
    ``every`` cadence (the first call always writes).  ``write()`` forces
    one, as the end of the run does.  A failure warns once and disables
    the writer: an unwritable disk must not fail a step, nor warn every
    step."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 every: int) -> None:
        self._registry = registry
        self.path = path
        self._every = max(int(every), 1)
        self._last_written = -1
        self._dead = False

    def step(self, step: int) -> None:
        if self._dead or step < 0:
            return
        if step // self._every != self._last_written // self._every:
            self._last_written = step
            self.write()

    def write(self) -> None:
        if self._dead:
            return
        try:
            atomic_write_text(self.path, self._registry.exposition())
        except OSError as e:
            print(f"WARNING: cannot write metrics scrape file "
                  f"{self.path!r} ({e}); periodic .prom rewrite disabled",
                  file=sys.stderr)
            self._dead = True


def start_profiler(cuda: bool):
    """A started ``torch.profiler`` session of CPU activity and, with
    ``cuda``, the card's: the card's queue is drained first, so the session
    holds only the work enqueued after it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, path: str, cuda: bool) -> str:
    """Stop ``prof`` once the card has run what was enqueued, and export
    its Chrome trace to ``path`` (its directory made); returns ``path``."""
    import torch
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def trace_kernel_launches(path: str, fragment: str) -> int:
    """The kernels in an exported Chrome trace whose name holds
    ``fragment`` (each ``"kernel"`` event is one launch on the card)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for ev in events if ev.get("cat") == "kernel"
               and fragment in ev.get("name", ""))


class ProfileTrigger:
    """Arm-and-capture profiler for the next N optimizer steps.

    ``request(n)`` (an HTTP handler thread or the SIGUSR1 handler) only
    sets an integer under a lock; the capture starts and ends on the
    training thread inside ``step()``, where the work is enqueued.
    ``profiler_available=False`` (the CLI passes it on the CPU, and when
    ``--profile_dir`` owns the profiler for the whole run) keeps the span
    capture and skips the trace.  Where a card is visible the trace holds
    its activity too."""

    def __init__(self, tracer, out_dir: str, *,
                 profiler_available: bool = True) -> None:
        self._tracer = tracer
        self._out_dir = out_dir or os.getcwd()
        self._profiler_available = profiler_available
        self._cuda = False
        self._lock = threading.Lock()
        self._pending = 0      # requested steps, under _lock
        self._remaining = 0    # the active capture's steps left
        self._t0 = 0.0
        self._start_step = 0
        self._prof = None
        self._trace_dir: Optional[str] = None
        self.captures: List[str] = []  # artifact paths, oldest first

    def request(self, steps: int) -> None:
        steps = max(int(steps), 1)
        with self._lock:
            if self._pending == 0 and self._remaining == 0:
                self._pending = steps

    @property
    def armed(self) -> bool:
        """True while a capture is requested or in flight."""
        with self._lock:
            return self._pending > 0 or self._remaining > 0

    def step(self, step: int) -> None:
        start, finish = 0, False
        with self._lock:
            if self._remaining > 0:
                self._remaining -= 1
                finish = self._remaining == 0
            elif self._pending > 0:
                start = self._pending
                self._pending = 0
                self._remaining = start
        if start:
            self._start(step, start)  # counts down from the NEXT step
        elif finish:
            self._finish(step)

    def _start(self, step: int, steps: int) -> None:
        self._start_step = step
        self._t0 = self._tracer.now() if getattr(
            self._tracer, "enabled", False) else 0.0
        self._prof = None
        self._trace_dir = None
        if self._profiler_available:
            try:
                import torch
                self._cuda = torch.cuda.is_available()
                self._prof = start_profiler(self._cuda)
                self._trace_dir = os.path.join(
                    self._out_dir, f"profile_trace_step{step}")
            except Exception as e:  # a build without the profiler
                print(f"note: torch.profiler trace unavailable ({e}); "
                      "capturing spans only", file=sys.stderr)
        print(f"profile trigger: capturing the next {steps} step(s) "
              f"from step {step}", file=sys.stderr)

    def _finish(self, step: int) -> None:
        if self._prof is not None:
            try:
                stop_profiler(self._prof, os.path.join(
                    self._trace_dir, TRACE_FILE), self._cuda)
            except Exception as e:
                print(f"WARNING: profile trace export failed: {e}",
                      file=sys.stderr)
                self._trace_dir = None
            self._prof = None
        spans = (self._tracer.spans_since(self._t0)
                 if getattr(self._tracer, "enabled", False) else [])
        doc = {"schema": "profile_capture/1",
               "start_step": self._start_step, "end_step": step,
               "trace_dir": self._trace_dir, "spans": spans}
        path = os.path.join(self._out_dir,
                            f"profile_capture_step{self._start_step}.json")
        try:
            atomic_write_text(path, json.dumps(doc, indent=1) + "\n")
            self.captures.append(path)
            print(f"profile trigger: wrote {path}"
                  + (f" (trace: {self._trace_dir})" if self._trace_dir
                     else ""), file=sys.stderr)
        except OSError as e:
            print(f"WARNING: profile capture write failed: {e}",
                  file=sys.stderr)


def install_sigusr1(trigger: ProfileTrigger,
                    steps: int = SIGUSR1_PROFILE_STEPS
                    ) -> Optional[Callable[[], None]]:
    """SIGUSR1 arms the profile trigger (a box with no port to curl).
    Returns an uninstaller that restores the previous handler, or None off
    the main thread (only the main thread may set handlers)."""
    if threading.current_thread() is not threading.main_thread():
        return None
    prev = signal.signal(signal.SIGUSR1,
                         lambda signum, frame: trigger.request(steps))

    def _uninstall() -> None:
        signal.signal(signal.SIGUSR1, prev)

    return _uninstall


class _Handler(BaseHTTPRequestHandler):
    # Request logging would interleave with the training prints.
    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def _send(self, code: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper went away mid-write

    def _send_json(self, doc, code: int = 200) -> None:
        self._send(code, json.dumps(doc, sort_keys=True) + "\n",
                   "application/json; charset=utf-8")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        srv: "InspectServer" = self.server.inspect  # type: ignore[attr-defined]
        url = urlsplit(self.path)
        try:
            if url.path == "/metrics":
                self._send(200, srv.registry.exposition(), CONTENT_TYPE)
            elif url.path == "/healthz":
                self._send_json(srv.health_snapshot())
            elif url.path == "/spans":
                self._send_json({"spans": srv.tracer.spans_since(0.0)})
            elif url.path == "/debug/profile":
                if srv.profile is None:
                    self._send_json({"error": "profile trigger off "
                                     "(--obs_off run?)"}, code=503)
                    return
                q = parse_qs(url.query)
                try:
                    steps = int(q.get("steps", ["8"])[0])
                except ValueError:
                    self._send_json({"error": "steps must be an int"},
                                    code=400)
                    return
                srv.profile.request(steps)
                self._send_json({"armed": True, "steps": max(steps, 1),
                                 "out_dir": srv.profile._out_dir})
            else:
                self._send_json({"error": f"no route {url.path}",
                                 "routes": ["/metrics", "/healthz",
                                            "/spans", "/debug/profile"]},
                                code=404)
        except Exception as e:
            # An endpoint's bug is reported to the caller; it must not end
            # the scrape loop, let alone the run.
            self._send_json({"error": repr(e)}, code=500)


class InspectServer:
    """The rank-0 in-run HTTP server, built only for ``--inspect_port``; it
    serves on loopback from a daemon thread, so a wedged run's endpoints
    stay readable up to the watchdog's exit."""

    def __init__(self, port: int, *, registry: MetricsRegistry, tracer,
                 health: Callable[[], dict],
                 profile: Optional[ProfileTrigger] = None,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry
        self.tracer = tracer
        self._health = health
        self.profile = profile
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.inspect = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True, name="obs-inspect")
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound port (``--inspect_port 0`` asks for a free one)."""
        return int(self._httpd.server_address[1])

    def health_snapshot(self) -> dict:
        try:
            return dict(self._health())
        except Exception as e:
            return {"ok": False, "error": repr(e)}

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=3.0)
