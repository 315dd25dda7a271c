"""SIGTERM/SIGINT handling (counterpart of
``ddp_tpu/resilience/preemption.py``).

:class:`PreemptionGuard` turns the first signal into a flag, and then
restores the handler that was there before, so a second signal acts at
once: an operator's Ctrl-C Ctrl-C still kills.  The serve entry point
drains on the flag (``noticed()``); training asks the stop decisions.

Training stops at the next step boundary of the streaming loop
(:meth:`PreemptionGuard.should_stop_step`, checked before each dispatch)
and takes an emergency checkpoint whose ``data_state`` names the first
batch not consumed; ``--resume`` fast-forwards to it, and the resumed run
is the uninterrupted one (batch content is a function of ``(seed, epoch,
k)``, each step's draws of the restored step count).  The resident path
dispatches whole epochs, so it stops at the epoch boundary
(:meth:`~PreemptionGuard.should_stop`).  The trainer then raises
:class:`PreemptionInterrupt`, which the CLI turns into exit status
:data:`EMERGENCY_CHECKPOINT_EXIT_STATUS`.

At world > 1 the decision is collective: every rank calls the stop
decision at every boundary, signal or not, and the local flags are OR-ed
(``parallel/dist.py::any_rank``, a CPU vote over a gloo side group), so a
notice on any rank stops every rank at the same step.  At world 1 it is
the flag alone.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Optional

# EX_TEMPFAIL, "temporary failure, retry": the restart wrapper's cue that an
# emergency checkpoint is on disk and a ``--resume`` relaunch continues the
# run.  Apart from 0 (done), 1 (a real failure) and the watchdog's 124.
EMERGENCY_CHECKPOINT_EXIT_STATUS = 75


class PreemptionInterrupt(BaseException):
    """Raised by ``Trainer.train`` after the emergency checkpoint landed.

    A ``BaseException`` (like ``KeyboardInterrupt``): not a program error,
    and not to be swallowed by ``except Exception`` recovery.  ``cli.run``
    turns it into ``SystemExit(EMERGENCY_CHECKPOINT_EXIT_STATUS)``."""

    def __init__(self, epoch: int, path: Optional[str]):
        self.epoch = epoch
        self.path = path
        super().__init__(
            f"preempted: emergency checkpoint at epoch {epoch}"
            + (f" in {path!r}" if path else " (checkpointing disabled)"))


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
              "at the next safe point (training: an emergency checkpoint at "
              f"the next step boundary, then exit status "
              f"{EMERGENCY_CHECKPOINT_EXIT_STATUS}); signal again to die "
              "immediately", file=sys.stderr)
        sys.stderr.flush()
        # Re-arm the previous behaviour so a second signal is immediate.
        prev = self._prev.get(signum)
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError):
            pass

    def noticed(self) -> bool:
        """Whether a signal arrived here (not yet agreed with the peers)."""
        return self._noticed.is_set()

    def should_stop(self, epoch: int) -> bool:
        """The stop decision at the boundary after ``epoch`` (the resident
        path's, whose dispatch unit is the epoch).  At world > 1 a
        collective: every rank calls it at every epoch boundary, in the
        same order relative to the trainer's other collectives."""
        return self._decide()

    def should_stop_step(self, step: int) -> bool:
        """The stop decision before global step ``step`` (the streaming
        loop's, checked before each dispatch).  At world > 1 one stop vote
        a step on every rank, unconditionally: decide together, then
        branch."""
        return self._decide()

    def _decide(self) -> bool:
        from ..parallel import dist
        local = self._noticed.is_set()
        if dist.world_size() == 1:
            return local
        if dist.any_rank(local):
            self._noticed.set()  # a peer was preempted: this rank stops too
            return True
        return False
