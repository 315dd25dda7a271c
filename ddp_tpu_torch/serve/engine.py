"""The serving forward engine: bucketed, warmed at startup, one CUDA graph
per bucket (counterpart of ``ddp_tpu/serve/engine.py`` at one device).

Requests are padded up to the smallest *bucket* of a fixed set, and every
bucket's program is made at startup (``warm()``), so no request waits on a
build.  A bucket's program is :class:`~ddp_tpu_torch.train.step.EvalProgram`:
the ``gather_batch`` kernel's eval form (u8/255 into channels-first float32)
and then ``make_eval_apply``, the eval forward ``evaluate_resident`` runs, so
served logits cannot drift from the training-side evaluation of the same
checkpoint at the same batch shape and compute dtype (``--bf16``: bfloat16,
as the JAX engine's ``compute_dtype``).  On the card each program is one CUDA
graph, captured at warm-up and replayed per batch; ``trace_count`` counts the
captured graphs and must equal the bucket set.  On the CPU the programs run
eagerly and ``trace_count`` counts warmed buckets.  A request larger than the
largest bucket is refused with :class:`RequestTooLarge`.

On the card a forward copies the request into a pinned uint8 staging buffer
(rows past the request zeroed), copies it without blocking into the graph's
static input, replays the graph, and brings the ``[B,10]`` logits back
through a pinned buffer.  Capture, copies and replay all run on the engine's
one side stream on its one device, whichever thread calls.

Telemetry: every forward records ``pad`` / ``h2d`` / ``forward`` / ``d2h``
spans keyed by a process-wide batch sequence number, as the JAX engine does;
the ``forward`` span waits for the device, so each span means what it means
there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, dtype_name, resolve_device
from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from ..train.step import EvalProgram, make_eval_forward

# Batch sequence numbers are process-wide, not per engine, as in the JAX
# package: the batcher claims one at batch formation so its queue_wait and
# batch_form spans share the key with the engine's spans.
_SEQ_LOCK = threading.Lock()
_NEXT_SEQ = 0


def claim_batch_seq() -> int:
    """The next process-unique batch sequence number (span step key)."""
    global _NEXT_SEQ
    with _SEQ_LOCK:
        seq = _NEXT_SEQ
        _NEXT_SEQ += 1
        return seq


class ServeError(Exception):
    """Base class for request-visible serving failures."""


class RequestTooLarge(ServeError):
    """More rows than the largest padded batch bucket; split the request."""


def resolve_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """The effective bucket set at one card: the requested buckets,
    deduplicated, ascending.  (The JAX package also rounds each up to a
    multiple of its mesh size; the port serves on one card.)"""
    if not buckets:
        raise ValueError("need at least one batch bucket")
    if any(b < 1 for b in buckets):
        raise ValueError(f"batch buckets must be >= 1, got {list(buckets)}")
    return tuple(sorted({int(b) for b in buckets}))


class ServeEngine:
    """Eval-mode forwards of ``model`` on ``device`` in ``compute_dtype``
    (float32 when None), one program per bucket.

    ``forward()`` is synchronous and single-caller by design (the batcher's
    engine thread); a lock serialises misuse.  Counters have their own lock,
    so ``/healthz`` and ``/stats`` never wait behind a forward."""

    # CIFAR sample shape, NHWC uint8: the loaders' wire format.
    input_shape = (32, 32, 3)

    def __init__(self, model: nn.Module, *, device: DeviceLike = "cuda",
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 compute_dtype: Optional[torch.dtype] = None, tracer=None,
                 registry=None):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = model.to(self.device)
        self.buckets = resolve_buckets(buckets)
        self.max_rows = self.buckets[-1]
        self.trace_count = 0  # captured graphs (card) / warmed buckets (CPU)
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self._c_rows = self.registry.counter(
            "ddp_engine_rows_served_total",
            "Valid rows returned by forward()").labels()
        forwards = self.registry.counter(
            "ddp_engine_forwards_total",
            "Compiled forwards executed, by padded bucket", ("bucket",))
        self._fwd_children = {b: forwards.labels(bucket=str(b))
                              for b in self.buckets}
        self._g_compiled = self.registry.gauge(
            "ddp_engine_compiled_executables",
            "Executables compiled so far (the compile-bound contract)"
        ).labels()
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._done = torch.cuda.Event() if self._cuda else None
        self._programs: Dict[int, EvalProgram] = {}
        # Per bucket: the host tensor a request is padded into and the one
        # the logits come back through (pinned on the card), and numpy views.
        self._host_in: Dict[int, torch.Tensor] = {}
        self._host_out: Dict[int, torch.Tensor] = {}
        self.tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()  # the pipeline: one forward at a time
        self._stats_lock = threading.Lock()
        self._forward_batches = 0
        self._per_bucket: Dict[int, int] = {b: 0 for b in self.buckets}
        self.rows_served = 0
        self.warmed = False
        # Which snapshot this engine answers for (set by from_checkpoint).
        self.checkpoint_file: Optional[str] = None
        self.checkpoint_epoch: Optional[int] = None
        self.checkpoint_step: Optional[int] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, snapshot_path: str, model_name: str, *,
                        device: DeviceLike = "cuda",
                        buckets: Sequence[int] = (1, 8, 32, 128),
                        compute_dtype: Optional[torch.dtype] = None,
                        tracer=None, registry=None) -> "ServeEngine":
        """An engine for model ``model_name`` (``vgg``, ``deepnn`` or
        ``resnet18``) on the newest verifiable checkpoint under
        ``snapshot_path``, a head path or a directory, through the lineage
        walk the trainer's ``--resume`` uses
        (:func:`~ddp_tpu_torch.resilience.lineage.latest_verifiable`): a
        torn head falls back to the newest retained snapshot.  The file is
        loaded by :func:`~ddp_tpu_torch.train.checkpoint.restore`: one of
        another model raises
        :class:`~ddp_tpu_torch.train.checkpoint.CheckpointError`, and so do
        nothing to load and a sharded (v2) index (not ported yet, ROADMAP
        A7b).  ``checkpoint_file`` names the file used."""
        from ..models import get_model
        from ..resilience.lineage import latest_verifiable
        from ..train.checkpoint import CheckpointError, restore
        loaded = latest_verifiable(snapshot_path)
        if loaded is None:
            raise CheckpointError(
                f"no checkpoint found under {snapshot_path!r}; the serve "
                f"engine needs a trained snapshot (run training with "
                f"--snapshot_path first)")
        ckpt, used = loaded
        model = get_model(model_name)
        try:
            restore(ckpt, model)
        except CheckpointError as e:
            raise CheckpointError(f"checkpoint {used!r}: {e}") from None
        engine = cls(model, device=device, buckets=buckets,
                     compute_dtype=compute_dtype, tracer=tracer,
                     registry=registry)
        engine.checkpoint_file = used
        engine.checkpoint_epoch = int(ckpt.epoch)
        engine.checkpoint_step = int(ckpt.step)
        return engine

    def _on_capture(self) -> None:
        with self._stats_lock:
            self.trace_count += 1
        self._g_compiled.inc()

    def warm(self) -> int:
        """Make every bucket's program now (on the card: run each eagerly,
        then capture each as a CUDA graph), so no request pays for it.
        Returns ``trace_count``, the resolved bucket-set size.  Calling it
        again does nothing."""
        with self._lock:
            if not self._programs:
                self._programs = make_eval_forward(
                    self.model, self.buckets,
                    compute_dtype=self.compute_dtype, stream=self._stream,
                    on_capture=self._on_capture)
                for b, prog in self._programs.items():
                    self._host_in[b] = torch.zeros(
                        (b,) + self.input_shape, dtype=torch.uint8,
                        pin_memory=self._cuda)
                    self._host_out[b] = torch.zeros(
                        prog.output.shape, dtype=prog.output.dtype,
                        pin_memory=self._cuda)
        with self._stats_lock:
            self.warmed = True
            return self.trace_count

    # -- serving -----------------------------------------------------------

    def bucket_for(self, n_rows: int) -> int:
        """Smallest bucket holding ``n_rows``; :class:`RequestTooLarge`
        beyond the largest."""
        for b in self.buckets:
            if n_rows <= b:
                return b
        raise RequestTooLarge(
            f"{n_rows} rows exceed the largest padded batch bucket "
            f"{self.max_rows}; split the request or restart the server "
            "with a larger --buckets set")

    def _on_device(self):
        """The engine's device and side stream as current (card)."""
        if not self._cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _wait(self) -> None:
        """Block until the work enqueued on the side stream is done."""
        if self._cuda:
            self._done.record(self._stream)
            self._done.synchronize()

    def forward(self, images: np.ndarray,
                seq: Optional[int] = None) -> np.ndarray:
        """Logits for ``images`` (uint8 ``[n, 32, 32, 3]``): padded to the
        bucket, run by the bucket's program, the valid ``[n, 10]`` float32
        rows returned.  ``seq`` keys this forward's spans (the batcher
        claims it at batch formation); a direct call claims its own."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected images [n, {', '.join(map(str, self.input_shape))}"
                f"], got {images.shape}")
        if images.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 images (the loaders' wire format), got "
                f"{images.dtype}; scale/quantize on the client")
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, 0), np.float32)
        bucket = self.bucket_for(n)
        if seq is None:
            seq = claim_batch_seq()
        with self._lock:
            program = self._programs.get(bucket)
            if program is None:
                raise RuntimeError("ServeEngine.forward before warm(): the "
                                   "bucket programs are made at startup")
            with self._stats_lock:
                self._forward_batches += 1
            tracer = self.tracer
            host_in, host_out = self._host_in[bucket], self._host_out[bucket]
            with tracer.span("pad", step=seq):
                staged = host_in.numpy()
                staged[:n] = images
                staged[n:] = 0  # the buffer is reused: no stale rows
            with self._on_device():
                with tracer.span("h2d", step=seq):
                    program.input.copy_(host_in, non_blocking=self._cuda)
                with tracer.span("forward", step=seq):
                    out = program.run()
                    self._wait()
                with tracer.span("d2h", step=seq):
                    host_out.copy_(out, non_blocking=self._cuda)
                    self._wait()
                    logits = host_out.numpy()[:n].copy()
            with self._stats_lock:
                self._per_bucket[bucket] += 1
                self.rows_served += n
            self._fwd_children[bucket].inc()
            self._c_rows.inc(n)
        return logits

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Argmax class ids: the ``/predict`` convenience over
        :meth:`forward`."""
        return np.argmax(self.forward(images), axis=-1).astype(np.int64)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:  # never the pipeline lock
            return {
                "buckets": list(self.buckets),
                "compiled_executables": self.trace_count,
                "forward_batches": self._forward_batches,
                "forward_batches_per_bucket": {
                    str(b): c for b, c in self._per_bucket.items()},
                "rows_served": self.rows_served,
                "mesh_devices": 1,
                "compute_dtype": dtype_name(self.compute_dtype),
                "device": str(self.device),
                "checkpoint": {
                    "file": self.checkpoint_file,
                    "epoch": self.checkpoint_epoch,
                    "step": self.checkpoint_step,
                },
            }
