"""Step health guard: the loss-stream anomaly policy, ``--on_nan``
included (counterpart of ``ddp_tpu/resilience/guard.py``: the same
decisions, messages and metrics events, in numpy).

Detection rides the trainer's loss flush: each epoch's per-step losses
already come to the host as one read (``Trainer._flush_losses``), so
checking them costs no extra device read.  It is post-hoc: the update that
produced a bad loss has already been applied.

Two detectors share one decision path.

**Non-finite** (``--on_nan {abort,skip,restore}``):

``abort``   (default) raise :class:`NonFiniteLossError`.  The trainer
            checks an epoch's losses before it checkpoints the epoch, so
            the newest checkpoint on disk always has finite losses.
``skip``    log and keep training; NaNs may persist in the parameters.
``restore`` reload the newest verifiable checkpoint (lineage fall-back
            included) and continue from there with the step's random
            draws re-keyed (the trainer folds :attr:`restores` into them),
            so a divergence does not replay.  Bounded by
            ``max_restores``; exhausting it raises.

**Spike** (``--guard_spike_factor``; 0 = off, the default): a rolling
median/MAD window over the finite losses; a step whose loss exceeds
``median * spike_factor + 3 * MAD`` (with at least ``_MIN_WINDOW`` history)
is anomalous.  Actions (``--guard_action``):

``skip``        log the spike and keep training (the spike stays out of
                the window).
``lr_backoff``  halve the learning rate from here on (the trainer's
                ``on_lr_backoff`` hook scales its schedule).
``rollback``    restore the last verified snapshot, re-key the draws, and
                skip the poisoned batches on replay (the raised
                :class:`RestoreFromLastGood` names their steps); shares the
                non-finite restore budget.
``abort``       raise :class:`LossSpikeError`.

:meth:`StepHealthGuard.check_series` applies the same window to any named
per-step series; the loss is the one wired.  Every decision lands as a
``guard_decision`` metrics event and in the ``ddp_guard_decisions_total``
counter, and ``last_decision`` holds a one-line summary.
"""
from __future__ import annotations

import sys
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np

POLICIES = ("abort", "skip", "restore")
SPIKE_ACTIONS = ("abort", "skip", "lr_backoff", "rollback")

_MIN_WINDOW = 8  # spike verdicts need this much history to be robust
_LR_BACKOFF_FACTOR = 0.5


class NonFiniteLossError(RuntimeError):
    """Training produced a non-finite loss and the policy said stop."""


class LossSpikeError(RuntimeError):
    """The loss spiked past the guard's threshold and the action said
    stop."""


class RestoreFromLastGood(Exception):
    """Internal control-flow signal: ``Trainer.train`` catches this and
    reloads the newest verifiable checkpoint (``on_nan=restore``, the
    guard's ``rollback`` action, and ``--drift_action restore``).

    ``skip_steps``/``skip_epoch`` (spike-rollback only): the global steps
    whose batches poisoned the run — the trainer maps them to epoch-local
    batch positions and skips them on replay.
    """

    def __init__(self, msg: str, *, skip_steps: Optional[List[int]] = None,
                 skip_epoch: Optional[int] = None):
        super().__init__(msg)
        self.skip_steps = skip_steps or []
        self.skip_epoch = skip_epoch


class StepHealthGuard:
    def __init__(self, policy: str = "abort", max_restores: int = 8, *,
                 window: int = 64, spike_factor: float = 0.0,
                 spike_action: str = "rollback", metrics=None,
                 registry=None):
        if policy not in POLICIES:
            raise ValueError(
                f"on_nan policy must be one of {POLICIES}, got {policy!r}")
        if spike_action not in SPIKE_ACTIONS:
            raise ValueError(
                f"guard_action must be one of {SPIKE_ACTIONS}, got "
                f"{spike_action!r}")
        if spike_factor < 0:
            raise ValueError(
                f"guard_spike_factor must be >= 0 (0 disables spike "
                f"detection), got {spike_factor}")
        self.policy = policy
        self.max_restores = int(max_restores)
        self.restores = 0  # also the RNG re-seed counter (trainer folds it)
        self.spike_factor = float(spike_factor)
        self.spike_action = spike_action
        self.metrics = metrics
        self.last_decision = "none"  # watchdog stall-context surface
        self.decisions: Counter = Counter()
        # Mirror every decision into the run's metrics registry as a
        # labelled family; ``decisions`` stays the in-process truth, the
        # registry is the scrape surface.
        self._reg_decisions = (
            registry.counter("ddp_guard_decisions_total",
                             "Step-health guard decisions by kind",
                             ("decision",))
            if registry is not None else None)
        self.lr_scale = 1.0
        # Trainer hook: called with the new cumulative LR scale when the
        # lr_backoff action fires (the trainer scales the schedule its
        # step reads).  None = action degrades to a logged
        # skip (embedders without the hook must not crash).
        self.on_lr_backoff = None
        self._windows: Dict[str, deque] = {}
        self._maxlen = max(int(window), _MIN_WINDOW)

    # -- decision bookkeeping ---------------------------------------------

    def _decide(self, decision: str, *, step: int, **fields) -> None:
        self.decisions[decision] += 1
        if self._reg_decisions is not None:
            self._reg_decisions.labels(decision=decision).inc()
        self.last_decision = f"{decision}@step={int(step)}"
        if self.metrics is not None:
            self.metrics.log_event("guard_decision", decision=decision,
                                   step=int(step), **fields)

    # -- non-finite policy (the original --on_nan path) -------------------

    def check(self, losses: np.ndarray, *, epoch: int,
              start_step: int) -> None:
        """Apply the policy to one flushed epoch's loss vector.  Raises
        per policy; returns normally when all losses are healthy (or
        under ``skip``).  Non-finite first (it dominates: a NaN is also
        an outlier), then the spike detector over the finite entries."""
        losses = np.asarray(losses)
        finite = np.isfinite(losses)
        if not finite.all():
            self._check_nonfinite(losses, finite, epoch=epoch,
                                  start_step=start_step)
        if self.spike_factor > 0:
            self.check_series("loss", losses[finite],
                              np.flatnonzero(finite) + start_step,
                              epoch=epoch)

    def _check_nonfinite(self, losses, finite, *, epoch: int,
                         start_step: int) -> None:
        bad = np.flatnonzero(~finite)
        steps = [int(start_step + i) for i in bad[:8]]
        msg = (f"non-finite loss at epoch {epoch}, global step(s) {steps}"
               f"{' (+more)' if len(bad) > 8 else ''} "
               f"[{len(bad)}/{losses.size} steps affected]")
        if self.policy == "skip":
            self._decide("nonfinite_skip", step=steps[0], epoch=epoch)
            print(f"WARNING: {msg}; --on_nan skip: continuing (parameters "
                  "may carry NaNs)", file=sys.stderr)
            sys.stderr.flush()
            return
        if self.policy == "restore":
            if self.restores >= self.max_restores:
                self._decide("nonfinite_abort", step=steps[0], epoch=epoch,
                             reason="restore budget exhausted")
                raise NonFiniteLossError(
                    f"{msg}; restore budget exhausted "
                    f"({self.restores}/{self.max_restores} restores used)")
            self.restores += 1
            self._decide("nonfinite_restore", step=steps[0], epoch=epoch,
                         restores=self.restores)
            print(f"WARNING: {msg}; --on_nan restore: reloading the last "
                  f"good checkpoint (restore {self.restores}/"
                  f"{self.max_restores})", file=sys.stderr)
            sys.stderr.flush()
            raise RestoreFromLastGood(msg)
        self._decide("nonfinite_abort", step=steps[0], epoch=epoch)
        raise NonFiniteLossError(
            f"{msg}; --on_nan abort (pass --on_nan skip|restore to "
            "continue instead)")

    # -- spike detector (any per-step series; the loss is wired) ----------

    def check_series(self, name: str, values, steps, *,
                     epoch: int) -> None:
        """Feed one flushed stretch of a named per-step statistic through
        the rolling median/MAD spike detector.  ``values[i]`` was
        observed at global step ``steps[i]``.  May raise per the spike
        action; healthy values extend the window."""
        if self.spike_factor <= 0:
            return
        win = self._windows.setdefault(name, deque(maxlen=self._maxlen))
        spike_steps: List[int] = []
        spike_vals: List[float] = []
        for v, s in zip(np.asarray(values, np.float64),
                        np.asarray(steps)):
            v = float(v)
            if len(win) >= _MIN_WINDOW:
                med = float(np.median(win))
                mad = float(np.median(np.abs(np.asarray(win) - med)))
                if v > med * self.spike_factor + 3.0 * mad:
                    # Anomalous: record, keep it OUT of the window (one
                    # outlier must not inflate the baseline).
                    spike_steps.append(int(s))
                    spike_vals.append(v)
                    continue
            win.append(v)
        if spike_steps:
            self._on_spike(name, spike_steps, spike_vals, epoch=epoch)

    def _on_spike(self, name: str, steps: List[int], values: List[float],
                  *, epoch: int) -> None:
        msg = (f"{name} spike at epoch {epoch}, global step(s) "
               f"{steps[:8]}{' (+more)' if len(steps) > 8 else ''}: "
               f"value(s) {[round(v, 4) for v in values[:4]]} exceed "
               f"median * {self.spike_factor} + 3*MAD over the last "
               f"{self._maxlen}-step window")
        action = self.spike_action
        if action == "lr_backoff" and self.on_lr_backoff is None:
            action = "skip"  # no trainer hook: degrade loudly below
        if action == "skip":
            self._decide("spike_skip", step=steps[0], epoch=epoch,
                         series=name, n=len(steps))
            print(f"WARNING: {msg}; --guard_action skip: continuing",
                  file=sys.stderr)
            sys.stderr.flush()
            return
        if action == "lr_backoff":
            self.lr_scale *= _LR_BACKOFF_FACTOR
            self._decide("spike_lr_backoff", step=steps[0], epoch=epoch,
                         series=name, lr_scale=self.lr_scale)
            print(f"WARNING: {msg}; --guard_action lr_backoff: scaling "
                  f"the LR schedule by {_LR_BACKOFF_FACTOR} (cumulative "
                  f"scale {self.lr_scale})", file=sys.stderr)
            sys.stderr.flush()
            self.on_lr_backoff(self.lr_scale)
            return
        if action == "rollback":
            if self.restores >= self.max_restores:
                self._decide("spike_abort", step=steps[0], epoch=epoch,
                             series=name,
                             reason="restore budget exhausted")
                raise LossSpikeError(
                    f"{msg}; restore budget exhausted "
                    f"({self.restores}/{self.max_restores} restores used)")
            self.restores += 1
            self._decide("spike_rollback", step=steps[0], epoch=epoch,
                         series=name, restores=self.restores,
                         skip_steps=steps[:32])
            print(f"WARNING: {msg}; --guard_action rollback: reloading "
                  "the last verified checkpoint and skipping the "
                  f"poisoned batch window (restore {self.restores}/"
                  f"{self.max_restores})", file=sys.stderr)
            sys.stderr.flush()
            raise RestoreFromLastGood(msg, skip_steps=steps,
                                      skip_epoch=epoch)
        self._decide("spike_abort", step=steps[0], epoch=epoch,
                     series=name)
        raise LossSpikeError(
            f"{msg}; --guard_action abort (pass --guard_action "
            "skip|lr_backoff|rollback to continue instead)")
