"""Run metrics logging (counterpart of ``ddp_tpu/utils/metrics.py``): one
sink for scalar curves and discrete events.

:class:`MetricsLogger` appends one JSON line a record to ``path`` and, with
``tensorboard_dir``, mirrors the numeric curves as TensorBoard scalars.
Every record (per-step scalars ``log_step``, lifecycle events
``log_event``, live telemetry ``log_live`` from ``obs/live.py``, and eval
accuracy ``log_eval``) goes through one ``_emit``, so the lines are the JAX
package's, key for key, and each carries ``wall_s``: seconds on
``time.monotonic()`` since the logger was made, a clock that no NTP slew
moves.

Rank 0 writes (the checkpoint's gate, multigpu.py:118): the values are the
same on every rank.  The JSONL handle is line-buffered; :meth:`fsync`
forces its tail to disk.

The TensorBoard mirror needs a writer already installed on the box
(``torch.utils.tensorboard``, which needs the ``tensorboard`` package);
without one, ``tensorboard_dir`` is refused by name.  The JAX logger's
flight-recorder tap (``attach_recorder``) belongs to the black box of the
observability slice (ROADMAP A8) and is not here.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


def require_tensorboard():
    """``torch.utils.tensorboard.SummaryWriter``, or SystemExit naming
    ``--tensorboard_dir`` where the box has no TensorBoard writer."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise SystemExit(
            f"--tensorboard_dir needs a TensorBoard writer "
            f"(torch.utils.tensorboard and the tensorboard package), "
            f"which this box lacks: {e}") from None
    return SummaryWriter


class MetricsLogger:
    def __init__(self, path: Optional[str], enabled: bool = True,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self._f: Optional[IO[str]] = None
        self._tb = None
        self._t0 = time.monotonic()
        if not enabled:
            return
        if tensorboard_dir:
            self._tb = require_tensorboard()(tensorboard_dir)
        if path:
            self._f = open(path, "a", buffering=1)  # line-buffered

    @property
    def active(self) -> bool:
        """True when a sink (JSONL or TensorBoard) is open: callers skip
        building telemetry that no sink would receive."""
        return self._f is not None or self._tb is not None

    def _emit(self, rec: dict, scalars: Optional[dict] = None,
              step: Optional[int] = None) -> None:
        """The one sink: the JSONL line, stamped ``wall_s``, and the
        TensorBoard scalars."""
        stamped = {**rec, "wall_s": round(time.monotonic() - self._t0, 3)}
        if self._f is not None:
            self._f.write(json.dumps(stamped) + "\n")
        if self._tb is not None and scalars:
            for tag, val in scalars.items():
                self._tb.add_scalar(tag, val, global_step=step)

    def log_step(self, *, step: int, epoch: int, loss: float,
                 lr: float) -> None:
        self._emit({"step": step, "epoch": epoch, "loss": round(loss, 6),
                    "lr": round(lr, 8)},
                   scalars={"train/loss": loss, "train/lr": lr}, step=step)

    def log_event(self, kind: str, **fields) -> None:
        """A discrete event, JSONL only:
        ``{"event": kind, ...fields, "wall_s": t}``."""
        self._emit({"event": kind, **fields})

    def log_live(self, *, step: int, **fields) -> None:
        """A live telemetry record (``obs/live.py``), and a ``live/<field>``
        scalar for each numeric field."""
        self._emit({"event": "live", "step": step, **fields},
                   scalars={f"live/{k}": v for k, v in fields.items()
                            if isinstance(v, (int, float))}, step=step)

    def log_eval(self, *, epoch: int, accuracy: float,
                 final: bool = False) -> None:
        """An eval accuracy: periodic (``--eval_every``) or, with
        ``final``, the end-of-run accuracy the reference prints
        (multigpu.py:247-248), the stream's last record."""
        rec = {"epoch": epoch, "eval_accuracy": round(accuracy, 4)}
        if final:
            rec["final"] = True
        self._emit(rec, scalars={"eval/accuracy": accuracy}, step=epoch)

    def fsync(self) -> None:
        """Force the JSONL tail to disk."""
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
