"""The per-rank train and eval steps (counterpart of
``ddp_tpu/train/step.py``).

One optimizer step on each rank: for each of its micro-batches (one, or
``--grad_accum`` A), the rank's batch, from the resident table
(:func:`micro_from_table`) or a streamed uint8 batch the host copied to the
card (:func:`to_device`, :func:`micro_from_batch`), cropped, flipped and
scaled u8/255 by one kernel (``ops/gather.py::gather_batch``),
forward in training mode with BatchNorm on the rank's own batch statistics
(the reference's unsynced BN, multigpu.py:127; ``--sync_bn`` takes them
over every rank's batch), the rank's share ``ce_sum / (count * world)`` of
the global-mean loss, backward; the micro-batches' gradients summed on the
rank and divided by A (:func:`make_accum_grads`); then the update stage:
one all-reduce of the gradients and one of BatchNorm's running buffers
(``parallel/dist.py``) and the SGD update at ``lr_schedule(step)``
(:func:`make_group_update`), or the sharded update of ``train/zero.py``.
Under ``--bf16`` (``compute_dtype=torch.bfloat16``) the batch comes out of
the kernel in bfloat16 and the model computes in it (``models/``);
the loss, the gradients, momentum and BatchNorm's buffers stay float32.
PyTorch runs it eagerly, one process per rank, where the JAX package runs
one ``shard_map`` program over the mesh.  The forward updates the running
buffers in place (the JAX package returns them as new state).  Without a
process group the collectives are the identity and the step is the
single-device one.
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.device_augment import Draws
from ..ops.gather import IMAGE_SHAPE, gather_batch
from ..ops.losses import cross_entropy_sum_count
from ..optim import sgd as sgd_lib
from ..parallel import dist
from ..parallel.tp.plan import TPWiring, forward_kwargs


def _as_input(x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC batch -> NCHW, uint8 scaled u8/255 (ToTensor) into
    ``compute_dtype`` (float32 when None; bfloat16: the float32 quotient
    rounded to nearest even, which is JAX's ``astype(bf16) / 255``), on the
    tensor's device.  A float batch from :func:`gather_batch` is already
    scaled and stored channels-first, so this returns its buffer as is.

    The uint8 branch divides by a device tensor, as
    :func:`~ddp_tpu_torch.ops.gather.gather_batch_plain` does: on a CUDA
    tensor ``x / 255.0`` multiplies by the reciprocal, one ulp off for 126
    byte values, and the served logits would then differ from the eval
    forward's, whose input comes from the kernel's true division."""
    x = x.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = (x.float() / torch.full((), 255.0, device=x.device)).to(
            compute_dtype or torch.float32)
    return x.contiguous()


@dataclass
class TrainState:
    """What evolves across steps.  ``model`` holds the weights and
    BatchNorm buffers; ``momentum`` is parallel to
    ``list(model.parameters())``, or under ``--shard_update`` the one flat
    slice of it this rank updates (``train/zero.py``); ``step`` is the
    host's count of optimizer steps (it drives the LR schedule without a
    device read)."""
    model: nn.Module
    momentum: List[torch.Tensor]
    step: int = 0


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model, sgd_lib.init(model.parameters()), 0)


def make_local_grads(model: nn.Module, sync_bn: bool = False,
                     compute_dtype: Optional[torch.dtype] = None,
                     tp: Optional[TPWiring] = None):
    """``fn(images [B,32,32,3], labels [B], generator=None) -> (loss,
    grads)`` on this rank's batch, with no collective but sync-BN's: the
    forward in training mode (BatchNorm over every rank's batch with
    ``sync_bn``, dropout's mask from ``generator``) in ``compute_dtype``,
    and the float32 gradients of the rank's share ``ce_sum / (count *
    world)`` of the global-mean loss (the JAX package's local objective,
    ``ddp_tpu/train/zero.py::_make_local_grads``).

    Every rank's batch has the same ``count`` (the sampler pads the shards
    to one length), so the shares sum to ``psum(ce_sum) / psum(count)``
    and the gradients summed over the ranks are that loss's gradient
    (``ddp_tpu/train/step.py:107``): the update stage sums them.  ``loss``
    is the rank's share, on the device and detached:
    :func:`~ddp_tpu_torch.parallel.dist.all_reduce_sum_` of it is the
    global-mean loss.  The gradients come from ``torch.autograd.grad``, so
    a ``DistributedDataParallel`` wrapper, whose hooks fire in
    ``.backward()``, would never see them: the collectives are explicit, as
    the JAX package's are.  Build it after the process group exists: it
    reads the data axis's size once (the world without a mesh: the ranks
    of one data row share a batch, so ``world`` is the data axis ``D``).
    ``tp`` runs the model's tensor-parallel forward (the JAX package's
    ``_make_local_grads(..., tp_axis=MODEL_AXIS)``)."""
    params = list(model.parameters())
    world = dist.data_size()
    tp_kwargs = forward_kwargs(tp)

    def local_grads(images: torch.Tensor, labels: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        model.train()
        logits = model(_as_input(images, compute_dtype), sync_bn=sync_bn,
                       compute_dtype=compute_dtype, generator=generator,
                       **tp_kwargs)
        ce_sum, count = cross_entropy_sum_count(logits, labels)
        loss = ce_sum / (count * world)
        return loss.detach(), list(torch.autograd.grad(loss, params))

    return local_grads


def make_accum_grads(local_grads, get_micro):
    """``accum(micros, draws, dropout=None) -> (loss, grads)``: one
    optimizer step's
    gradients over its A micro-batches ``micros`` in order (an ``[A, B]``
    index tensor's rows, or A streamed batches; the counterpart of
    ``ddp_tpu/train/step.py::make_accum_scan``), summed on the rank and
    divided by A, with ``loss`` the mean of the micro-batches' shares.
    ``get_micro(draws_k, micro)`` gives a micro-batch's images and labels,
    calling ``draws_k(B)`` for its crop/flip draws when it augments on the
    device; ``draws(k, B)`` gives micro-batch k's, and ``dropout(k)`` the
    generator of its dropout mask (a model without dropout ignores it;
    None passes none).  The BatchNorm buffers
    chain through the micro-batches, each
    forward normalising with its own statistics, as torch does under
    accumulation.  No collective: the update stage reduces the gradients
    once a step, torch's ``no_sync`` (the JAX scan all-reduces each
    micro-batch's; the sums agree up to rounding).  At A = 1 the step's
    arithmetic is the single micro-batch's, op for op."""

    def accum(micros: Sequence, draws: Callable[[int, int], Draws],
              dropout: Optional[Callable[[int], torch.Generator]] = None):
        loss, grads = None, None
        for k, micro in enumerate(micros):
            x, y = get_micro(functools.partial(draws, k), micro)
            micro_loss, micro_grads = local_grads(
                x, y, None if dropout is None else dropout(k))
            if grads is None:
                loss, grads = micro_loss, micro_grads
            else:
                loss = loss + micro_loss
                grads = torch._foreach_add(grads, micro_grads)
        a = len(micros)
        if a > 1:
            loss, grads = loss / a, torch._foreach_div(grads, a)
        return loss, grads

    return accum


def make_group_update(sgd_config: sgd_lib.SGDConfig,
                      lr_schedule: Callable[[int], float]):
    """``update(state, grads)``, the replicated update stage: the rank's
    gradients summed over the ranks (one all-reduce), BatchNorm's running
    buffers averaged over them (one all-reduce), SGD at
    ``lr_schedule(state.step)`` in place, then ``state.step += 1``.  The
    sharded stage, ``train/zero.py::make_zero_update``, takes the same
    arguments."""

    def update(state: TrainState, grads) -> None:
        grads = dist.all_reduce_grads(grads)
        dist.average_buffers(state.model)
        sgd_lib.apply_updates(list(state.model.parameters()), list(grads),
                              state.momentum, lr_schedule(state.step),
                              sgd_config)
        state.step += 1

    return update


def micro_from_table(images: torch.Tensor, labels: torch.Tensor,
                     device_augment: bool,
                     dtype: torch.dtype = torch.float32):
    """``get_micro(draws, idx_row) -> (images, labels)`` for the resident
    path: the batch of ``dtype`` images, cropped and flipped with
    ``draws(B)`` under ``device_augment``, and its labels, from one
    :func:`~ddp_tpu_torch.ops.gather.gather_batch` launch."""

    def get_micro(draws: Callable[[int], Draws], idx_row: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        return gather_batch(images, labels, idx_row,
                            draws(idx_row.shape[0]) if device_augment
                            else None, dtype=dtype)

    return get_micro


def micro_from_batch(device_augment: bool,
                     dtype: torch.dtype = torch.float32):
    """``get_micro(draws, batch) -> (images, labels)`` for the streaming
    path (the counterpart of ``ddp_tpu/train/step.py::_micro_from_batch``
    and ``_as_input``): the streamed uint8 ``[B,32,32,3]`` batch and its
    int64 labels, on the device, through one
    :func:`~ddp_tpu_torch.ops.gather.gather_batch` launch over its rows
    ``arange(B)``: the eval form (u8/255 into channels-first ``dtype``),
    or under ``device_augment`` cropped and flipped with ``draws(B)``.  The
    kernel is the batch's only conversion to float."""
    rows: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def get_micro(draws: Callable[[int], Draws], batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        images, labels = batch["image"], batch["label"]
        key = (images.shape[0], images.device)
        if key not in rows:
            rows[key] = torch.arange(key[0], device=images.device)
        return gather_batch(images, labels, rows[key],
                            draws(key[0]) if device_augment else None,
                            dtype=dtype)

    return get_micro


class DeviceBatch(dict):
    """A host batch on the device: its tensors by key, as
    :func:`to_device` enqueued their copies.  Call :meth:`wait` before the
    first use: it makes the compute stream wait for the copies."""
    ready: Optional["torch.cuda.Event"] = None
    compute: Optional["torch.cuda.Stream"] = None

    def wait(self) -> "DeviceBatch":
        """Make the compute stream wait for the copies (once); a no-op on
        the CPU."""
        if self.ready is not None:
            self.compute.wait_event(self.ready)
            self.ready = None
        return self


def to_device(batch: Dict[str, np.ndarray], device: torch.device, *,
              stream: Optional["torch.cuda.Stream"] = None,
              compute: Optional["torch.cuda.Stream"] = None) -> DeviceBatch:
    """A host batch of numpy arrays on ``device`` (the counterpart of
    ``shard_batch``/``shard_batch_stacked``, ``ddp_tpu/train/step.py:
    530-552``; any leading shape).

    On the card each array is copied into pinned memory, then to the card
    with ``non_blocking`` copies enqueued on the copy stream ``stream``
    (from pageable memory such a copy would be synchronous), from whatever
    thread calls this.  An event recorded after the copies is
    :class:`DeviceBatch`'s ``ready``, which ``compute`` (the stream that
    will read the batch; the calling thread's current stream when None)
    waits on in :meth:`DeviceBatch.wait`.  Each device tensor is allocated
    on the copy stream and read on ``compute``, so ``record_stream(compute)``
    keeps the caching allocator from handing its memory out again before
    the reading kernels have run.  On the CPU the arrays become tensors
    without a copy (``torch.from_numpy``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceBatch((k, torch.from_numpy(np.ascontiguousarray(v)))
                           for k, v in batch.items())
    if stream is None:
        raise ValueError("to_device: a copy stream is needed on the card")
    out = DeviceBatch()
    with torch.cuda.device(device):
        out.compute = compute or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                t = host.to(device, non_blocking=True)
                t.record_stream(out.compute)
                out[k] = t
            out.ready = torch.cuda.Event()
            out.ready.record(stream)
    return out


def make_eval_apply(model: nn.Module,
                    compute_dtype: Optional[torch.dtype] = None,
                    tp: Optional[TPWiring] = None):
    """``fn(images [B,32,32,3]) -> logits [B,10]``: the eval-mode
    forward (BatchNorm on running statistics) in ``compute_dtype``, without
    autograd; the logits are float32.  The one eval forward of the port:
    the resident eval and every serving program (:func:`make_eval_forward`)
    run it, in the compute dtype of the training (``ddp_tpu/cli.py:
    1123-1127``).  ``tp`` runs the tensor-parallel forward (the TP eval
    forward, ``ddp_tpu/train/step.py:411-437``): one model-group
    all-reduce a row-parallel layer."""
    tp_kwargs = forward_kwargs(tp)

    @torch.no_grad()
    def apply_fn(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(_as_input(images, compute_dtype),
                     compute_dtype=compute_dtype, **tp_kwargs)

    return apply_fn


class GraphProgram:
    """A fixed computation ``fn()`` that reads static tensors (its inputs,
    written in place before each run) and returns its outputs.  On the card
    :meth:`capture` records it as one CUDA graph, the counterpart of one
    compiled executable of the JAX package, and :meth:`run` replays it into
    the static ``output``; the graph's output lives in its private memory
    pool as long as the program.  On the CPU :meth:`run` is :meth:`eager`.
    On the card a program that was not captured raises: it never runs
    eagerly instead.  ``name`` says which program in that error;
    ``inputs`` names the static tensors a caller writes before a run.

    ``sums`` is the gloo group of a tensor-parallel program's row sums
    (``serve/model_group.py``): a gloo collective cannot sit inside a CUDA
    graph, so the capture splits at each sum (``parallel/dist.py::
    cut_model_sums``) into ``segments``, graphs of one memory pool, and
    :meth:`run` replays them in order with the sum of each cut's tensor
    between two, on the host (its seconds in ``sum_seconds``).  Without
    ``sums`` the program is one segment, ``graph``."""

    def __init__(self, fn: Callable, device: torch.device, name: str,
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 sums=None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.inputs = dict(inputs or {})
        self.sums = sums
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.segments: List[torch.cuda.CUDAGraph] = []
        # The tensors summed after each segment but the last.
        self._cut_tensors: List[torch.Tensor] = []
        self.sum_seconds = 0.0
        # The graph's static output (card); the latest run's outputs (CPU).
        self.output = None

    def eager(self):
        """The program op by op: the CPU path, and on the card the run
        before the capture and the reference the graph is held against."""
        return self.fn()

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Record :meth:`eager` on ``stream`` as this program's CUDA graph
        (its segments, split at the row sums, under ``sums``).  The caller
        has run it eagerly first (its kernels built and loaded, cuDNN's and
        cuBLAS's choices settled).

        The capture runs in ``thread_local`` capture mode: only this
        thread is barred from the calls a capture forbids.  A fleet's hot
        swap captures new programs on its watcher thread while the
        replicas still serving replay their graphs, synchronise on events
        and copy through pinned buffers on their batcher threads; in the
        default ``global`` mode those calls would fail, or break the
        capture.  The mode changes what other threads may do meanwhile,
        not what is recorded: the graph is the same."""
        if self.graph is not None:
            raise RuntimeError(f"{self.name} is captured")
        pool = torch.cuda.graph_pool_handle()
        segments: List[torch.cuda.CUDAGraph] = []
        cuts: List[torch.Tensor] = []
        live = [torch.cuda.CUDAGraph()]

        def begin() -> None:
            live[0].capture_begin(pool=pool,
                                  capture_error_mode="thread_local")

        def cut(t: torch.Tensor) -> torch.Tensor:
            live[0].capture_end()
            segments.append(live[0])
            cuts.append(t)
            live[0] = torch.cuda.CUDAGraph()
            begin()
            return t

        # As torch.cuda.graph: free what can be freed for the graph.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        split = (dist.cut_model_sums(cut) if self.sums is not None
                 else contextlib.nullcontext())
        with torch.cuda.stream(stream):
            begin()
            try:
                with split:
                    output = self.eager()
            except BaseException:
                try:
                    live[0].capture_end()
                except RuntimeError:
                    pass
                raise
            live[0].capture_end()
        segments.append(live[0])
        self.segments, self._cut_tensors = segments, cuts
        self.graph, self.output = segments[0], output

    def run(self):
        """The outputs: the graph's replay on the current stream (card), or
        :meth:`eager` (CPU)."""
        if self.device.type == "cpu":
            self.output = self.eager()
            return self.output
        if self.graph is None:
            raise RuntimeError(f"{self.name} was not captured; it does not "
                               f"run eagerly on the card")
        for i, graph in enumerate(self.segments):
            graph.replay()
            if i < len(self._cut_tensors):
                t0 = time.perf_counter()
                self.sums.all_reduce_(self._cut_tensors[i])
                self.sum_seconds += time.perf_counter() - t0
        return self.output


class EvalProgram(GraphProgram):
    """The serving forward at one batch size ``B``: the uint8 ``[B,32,32,3]``
    batch in the static tensor ``input`` -> :func:`gather_batch`'s eval form
    (rows ``arange(B)``, u8/255 into channels-first ``compute_dtype``) ->
    :func:`make_eval_apply` in ``compute_dtype`` -> float32 ``[B,10]``
    logits: one :class:`GraphProgram`, the counterpart of one compiled
    executable of the JAX package's ``make_eval_forward``."""

    def __init__(self, model: nn.Module, batch: int,
                 compute_dtype: Optional[torch.dtype] = None):
        device = next(model.parameters()).device
        super().__init__(self._forward, device, f"the {batch}-row program")
        self.batch = batch
        self.dtype = compute_dtype or torch.float32
        self.input = torch.zeros((batch,) + IMAGE_SHAPE, dtype=torch.uint8,
                                 device=device)
        self._labels = torch.zeros(batch, dtype=torch.int64, device=device)
        self._rows = torch.arange(batch, dtype=torch.int32, device=device)
        self._apply = make_eval_apply(model, compute_dtype)

    def _forward(self) -> torch.Tensor:
        images, _ = gather_batch(self.input, self._labels, self._rows,
                                 dtype=self.dtype)
        return self._apply(images)


def make_eval_forward(model: nn.Module, batches: Sequence[int], *,
                      compute_dtype: Optional[torch.dtype] = None,
                      stream: Optional[torch.cuda.Stream] = None,
                      on_capture: Optional[Callable[[], None]] = None
                      ) -> Dict[int, EvalProgram]:
    """One :class:`EvalProgram` per batch size in ``batches`` (counterpart of
    ``ddp_tpu/train/step.py::make_eval_forward``, whose jit compiles one
    executable per padded batch bucket), ready to run, in
    ``compute_dtype`` (float32 when None).

    On the card every program first runs once eagerly on ``stream`` (a side
    stream; one is made when None), all of them before any capture: that
    builds and loads the kernel library (``nvcc`` must not run inside a
    capture), loads its module, and settles cuDNN's choice for each shape.
    Then each is captured on ``stream``.  A failed build, launch or capture
    raises.  On the CPU each program runs once eagerly.  ``on_capture`` is
    called once per program, after its capture on the card and after its
    run on the CPU: the counterpart of ``on_trace``."""
    programs = {b: EvalProgram(model, b, compute_dtype) for b in batches}
    device = next(model.parameters()).device
    if device.type == "cpu":
        for p in programs.values():
            p.output = p.eager()
            if on_capture is not None:
                on_capture()
        return programs
    if stream is None:
        stream = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        for p in programs.values():
            p.eager()
    stream.synchronize()
    for p in programs.values():
        with torch.cuda.device(device):
            p.capture(stream)
        if on_capture is not None:
            on_capture()
    return programs
