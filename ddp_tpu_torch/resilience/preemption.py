"""SIGTERM/SIGINT handling (counterpart of the signal half of
``ddp_tpu/resilience/preemption.py``).

:class:`PreemptionGuard` turns the first signal into a flag the owner polls
(``noticed()``), and then restores the handler that was there before, so a
second signal acts at once: an operator's Ctrl-C Ctrl-C still kills.  The
serve entry point drains on the flag.  The multi-process stop decisions of
the JAX guard (``should_stop``, ``should_stop_step``) need a collective
and come with the multi-card port.
"""
from __future__ import annotations

import signal
import sys
import threading


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._noticed = threading.Event()
        self._prev: dict = {}
        self._installed = False

    def install(self) -> "PreemptionGuard":
        """Install the handlers (main thread only: ``signal.signal`` raises
        on any other)."""
        if self._installed:
            return self
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                # None means "installed from C" (signal.getsignal): it cannot
                # be re-installed from Python; the default is the closest.
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def _handler(self, signum, frame) -> None:
        self._noticed.set()
        print(f"preemption notice ({signal.Signals(signum).name}): stopping "
              "at the next safe point; signal again to die immediately",
              file=sys.stderr)
        sys.stderr.flush()
        # Re-arm the previous behaviour so a second signal is immediate.
        prev = self._prev.get(signum)
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError):
            pass

    def noticed(self) -> bool:
        """Whether a signal arrived."""
        return self._noticed.is_set()
