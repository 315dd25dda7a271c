"""Watchdog: bound a stall's wall time instead of hanging with the peers
(counterpart of ``ddp_tpu/resilience/watchdog.py``).

The failure it is for: one rank stalls (a hung collective, a wedged data
source, a peer that died without leaving the group) and every other rank
blocks in a collective waiting for it, up to the process group's timeout
(3 minutes, ``parallel/dist.py::TIMEOUT``).  The watchdog is a daemon
thread fed heartbeats by the trainer's epoch and step loops and its loss
flush; when no beat arrives within ``timeout_s`` it prints a diagnostic,
calls the non-blocking ``dist.abort()`` and hard-exits with
:data:`WATCHDOG_EXIT_STATUS`.  ``os._exit`` rather than an exception: the
main thread is typically blocked inside a collective and would never see
one, and process death closes the sockets its peers wait on.

The timeout must exceed the worst stretch between beats, the first step
included: that step builds the CUDA kernels (``_build.py`` runs ``nvcc``
at the first launch when the build directory is cold).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

# 124, the conventional "timed out" status (GNU timeout(1)); apart from
# the preemption path's 75, so a restart wrapper can tell "resume me" from
# "something is wedged".
WATCHDOG_EXIT_STATUS = 124


class Watchdog:
    def __init__(self, timeout_s: float, *, tag: str = "train",
                 context: Optional[Callable[[], str]] = None,
                 registry=None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.tag = tag
        # context() -> str is printed with the stall diagnostic.
        self.context = context
        # One writer each: beat() on the trainer's thread, the expiry on
        # the watchdog's; a float store is atomic, and a stale read only
        # delays the expiry by one poll.
        self._last = time.monotonic()
        self.beats = 0
        self.expirations = 0
        if registry is not None:
            registry.counter(
                "ddp_watchdog_beats_total",
                "Progress heartbeats received").set_function(
                    lambda: float(self.beats))
            registry.counter(
                "ddp_watchdog_expirations_total",
                "Watchdog expiries (stall -> hard exit)").set_function(
                    lambda: float(self.expirations))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exit = os._exit  # replaced by in-process tests

    def beat(self) -> None:
        """Record progress; cheap enough for every step."""
        self._last = time.monotonic()
        self.beats += 1

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self.beat()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"watchdog-{self.tag}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        poll = min(1.0, self.timeout_s / 4.0)
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                self._expire(idle)
                return

    def _expire(self, idle: float) -> None:
        self.expirations += 1
        print(f"WATCHDOG [{self.tag}]: no progress for {idle:.1f}s "
              f"(limit {self.timeout_s:.1f}s); aborting the process group "
              f"and hard-exiting {WATCHDOG_EXIT_STATUS} so peers fail fast "
              "instead of riding the collective timeout",
              file=sys.stderr)
        if self.context is not None:
            try:
                detail = self.context()
            except Exception as e:  # the exit must happen regardless
                detail = f"<context hook failed: {e!r}>"
            if detail:
                print(f"WATCHDOG [{self.tag}]: {detail}", file=sys.stderr)
        sys.stderr.flush()
        try:
            from ..parallel import dist
            dist.abort()  # never blocks
        finally:
            self._exit(WATCHDOG_EXIT_STATUS)
