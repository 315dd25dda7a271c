"""KV-cached generative decoding: the serve engine for ``tinylm``
(counterpart of ``ddp_tpu/serve/kvcache.py`` at one device).

A generative model needs three program families, still a small fixed set
made at start-up (``warm()``), so no stream waits on a build:

- ``prefill``, one a padded PROMPT-length bucket: the causal forward of
  one stream's prompt, its next-token logits and the prompt's key/value
  stacks (``TinyLM.prefill``);
- ``cache_write``, one a prompt bucket: the prefilled keys and values
  copied into the stream's cache SLOT at positions ``0..bucket-1``;
- ``decode``, ONE for the whole run: every slot advances one token
  (``TinyLM.decode_step``: each slot's key/value written in place at its
  position, attention over its valid prefix).  Slots nobody reads compute
  garbage that is never read, which keeps the shape, and so the program
  count, fixed whatever streams are live.

On the card each program is one CUDA graph over static input tensors (the
prompt's tokens, the slot, the decode step's ``tokens`` and ``positions``),
captured at ``warm()`` and replayed a call: the counterpart of the JAX
engine's compiled executables, and ``trace_count`` counts the captures.
Each is a ``train/step.py::GraphProgram``, as the classifier engine's are:
on the card a program that was not captured raises, never runs eagerly.
On the CPU the same three programs run eagerly and each is counted once,
at its first run.  ``compile_bound`` is ``2 * len(prompt buckets) + 1``.

The cache, ``[n_layers, slots, T_MAX, n_heads, head_dim]`` twice (K and V)
in the compute dtype, is allocated once and written in place by the
cache-write and decode programs, the counterpart of the JAX engine's
donated cache buffers: no step makes a second cache.  The JAX engine also
shards the slots over a data axis and, under a plan, the heads over a
model axis; the port serves on one device (a serving model axis is ROADMAP
A12b).

Greedy choice is the first maximum of the float32 logits on the host,
as ``np.argmax`` picks.  Calls run on the engine's one side stream on its
device, whichever thread calls; the token batcher's engine thread is the
one caller by design, and a lock serialises misuse.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, dtype_name, resolve_device
from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from ..train.step import GraphProgram
from .engine import RequestTooLarge, ServeError  # noqa: F401 (re-export)


def resolve_prompt_buckets(buckets: Sequence[int],
                           t_max: int) -> Tuple[int, ...]:
    """The padded prompt-length buckets: deduplicated, ascending, clamped
    into ``[1, t_max]``."""
    if not buckets:
        raise ValueError("need at least one prompt bucket")
    if any(b < 1 for b in buckets):
        raise ValueError(f"prompt buckets must be >= 1, got {list(buckets)}")
    return tuple(sorted({min(int(b), t_max) for b in buckets}))


class SlotsExhausted(ServeError):
    """Every KV-cache slot is occupied: admission-level backpressure; the
    token batcher queues behind this, never the engine."""


class KVCacheEngine:
    """Slot-managed generative decoding of ``model`` (a ``TinyLM``) on
    ``device`` in ``compute_dtype`` (float32 when None), over a fixed set
    of programs.  ``metric_labels`` (a fleet's ``{"replica": "r0"}``)
    label every series it registers; ``stream`` is the side stream it
    captures and runs on (card; a new one when None)."""

    def __init__(self, model, *, device: DeviceLike = "cuda",
                 slots: int = 8, prompt_buckets: Sequence[int] = (16, 64),
                 compute_dtype: Optional[torch.dtype] = None, tracer=None,
                 registry=None, metric_labels=None,
                 stream: Optional[torch.cuda.Stream] = None):
        from ..models import transformer as tfm
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.vocab = int(tfm.VOCAB)
        self.t_max = int(tfm.T_MAX)
        self.prompt_buckets = resolve_prompt_buckets(prompt_buckets,
                                                     self.t_max)
        self.max_prompt = self.prompt_buckets[-1]
        # Protocol alias: the fleet's surfaces report these as buckets.
        self.buckets = self.prompt_buckets
        self.compile_bound = 2 * len(self.prompt_buckets) + 1
        self.trace_count = 0  # captured graphs (card) / programs run (CPU)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        labels = dict(metric_labels or {})
        labelnames = tuple(sorted(labels))
        prefills = self.registry.counter(
            "ddp_kvcache_prefills_total",
            "Prompt prefills executed, by padded prompt bucket",
            labelnames + ("bucket",))
        self._prefill_children = {
            b: prefills.labels(bucket=str(b), **labels)
            for b in self.prompt_buckets}
        self._c_decode_steps = self.registry.counter(
            "ddp_kvcache_decode_steps_total",
            "Decode steps executed (all slots advance together)",
            labelnames).labels(**labels)
        self._g_active = self.registry.gauge(
            "ddp_kvcache_active_slots",
            "KV-cache slots currently bound to live streams",
            labelnames).labels(**labels)
        self._g_slots = self.registry.gauge(
            "ddp_kvcache_slots", "Total KV-cache slots",
            labelnames).labels(**labels)
        self._g_slots.set(self.slots)
        self._g_compiled = self.registry.gauge(
            "ddp_engine_compiled_executables",
            "Executables compiled so far (the compile-bound contract)",
            labelnames).labels(**labels)

        self._cuda = self.device.type == "cuda"
        if stream is None and self._cuda:
            stream = torch.cuda.Stream(self.device)
        self._stream = stream
        self._done = torch.cuda.Event() if self._cuda else None
        cd = compute_dtype or torch.float32
        shape = (int(tfm.N_LAYERS), self.slots, self.t_max,
                 int(tfm.N_HEADS), int(tfm.HEAD_DIM))
        self._k = torch.zeros(shape, dtype=cd, device=self.device)
        self._v = torch.zeros(shape, dtype=cd, device=self.device)
        # Set by warm() once every program is made (and captured, card).
        self._prefill: Dict[int, GraphProgram] = {}
        self._write: Dict[int, GraphProgram] = {}
        self._decode: Optional[GraphProgram] = None
        # Host tensors requests are staged through (pinned on the card).
        self._host: Dict[str, torch.Tensor] = {}

        self._lock = threading.Lock()        # the pipeline
        self._stats_lock = threading.Lock()  # counters (probe-readable)
        self._free = list(range(self.slots))
        self._pos: Dict[int, int] = {}       # slot -> next write position
        self.prefills = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self.warmed = False
        self.checkpoint_file: Optional[str] = None
        self.checkpoint_epoch: Optional[int] = None
        self.checkpoint_step: Optional[int] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, snapshot_path: str, model_name: str, *,
                        device: DeviceLike = "cuda", slots: int = 8,
                        prompt_buckets=(16, 64),
                        compute_dtype: Optional[torch.dtype] = None,
                        tracer=None, registry=None, metric_labels=None,
                        stream: Optional[torch.cuda.Stream] = None
                        ) -> "KVCacheEngine":
        """An engine on the newest verifiable checkpoint under
        ``snapshot_path``, through the classifier engine's lineage walk (a
        v1 file or a v2 set, from any training layout)."""
        from ..models import get_model
        from ..models import transformer as tfm
        from ..resilience.lineage import latest_verifiable
        from ..train.checkpoint import CheckpointError, restore
        if model_name != tfm.LM_NAME:
            raise ValueError(
                f"generative serving supports the {tfm.LM_NAME!r} decoder "
                f"(models/transformer.py), got {model_name!r}")
        loaded = latest_verifiable(snapshot_path)
        if loaded is None:
            raise CheckpointError(
                f"no checkpoint found under {snapshot_path!r}; train the "
                "LM first (python -m ddp_tpu_torch.train.lm "
                "--snapshot_path)")
        ckpt, used = loaded
        model = get_model(tfm.LM_NAME)
        try:
            restore(ckpt, model)
        except CheckpointError as e:
            raise CheckpointError(f"checkpoint {used!r}: {e}") from None
        eng = cls(model, device=device, slots=slots,
                  prompt_buckets=prompt_buckets, compute_dtype=compute_dtype,
                  tracer=tracer, registry=registry,
                  metric_labels=metric_labels, stream=stream)
        eng.checkpoint_file = used
        eng.checkpoint_epoch = int(ckpt.epoch)
        eng.checkpoint_step = int(ckpt.step)
        return eng

    def _on_trace(self) -> None:
        with self._stats_lock:
            self.trace_count += 1
        self._g_compiled.inc()

    def _make_programs(self):
        """The programs, their static inputs and the host staging buffers,
        as ``(prefill, write, decode, host)``; nothing is set on the
        engine."""
        model, cd, dev = self.model, self.compute_dtype, self.device
        prefill: Dict[int, GraphProgram] = {}
        write: Dict[int, GraphProgram] = {}
        host: Dict[str, torch.Tensor] = {}
        pin = self._cuda

        def prefill_fn(tokens):
            def fn():
                with torch.no_grad():
                    logits, k, v = model.prefill(tokens[None],
                                                 compute_dtype=cd)
                return logits[0], k[:, 0], v[:, 0]
            return fn

        def write_fn(bucket, slot, prog):
            def fn():
                _, k, v = prog.output
                self._k[:, :, :bucket].index_copy_(
                    1, slot, k[:, None].to(self._k.dtype))
                self._v[:, :, :bucket].index_copy_(
                    1, slot, v[:, None].to(self._v.dtype))
            return fn

        for b in self.prompt_buckets:
            tokens = torch.zeros(b, dtype=torch.long, device=dev)
            slot = torch.zeros(1, dtype=torch.long, device=dev)
            prefill[b] = GraphProgram(prefill_fn(tokens), dev,
                                      f"the {b}-token prefill",
                                      {"tokens": tokens})
            write[b] = GraphProgram(write_fn(b, slot, prefill[b]), dev,
                                    f"the {b}-token cache write",
                                    {"slot": slot})
            host[f"tokens{b}"] = torch.zeros(b, dtype=torch.long,
                                             pin_memory=pin)
        tokens = torch.zeros(self.slots, dtype=torch.long, device=dev)
        positions = torch.zeros(self.slots, dtype=torch.long, device=dev)

        def decode_fn():
            with torch.no_grad():
                return model.decode_step(tokens, positions, self._k,
                                         self._v, compute_dtype=cd)

        decode = GraphProgram(decode_fn, dev, "the decode",
                              {"tokens": tokens, "positions": positions})
        host["slot"] = torch.zeros(1, dtype=torch.long, pin_memory=pin)
        host["step"] = torch.zeros((2, self.slots), dtype=torch.long,
                                   pin_memory=pin)
        host["row"] = torch.zeros(self.vocab, dtype=torch.float32,
                                  pin_memory=pin)
        host["logits"] = torch.zeros((self.slots, self.vocab),
                                     dtype=torch.float32, pin_memory=pin)
        return prefill, write, decode, host

    def warm(self) -> int:
        """Make every program now: prefill and cache-write for each prompt
        bucket and the one decode (on the card: each run eagerly, then
        each captured as a CUDA graph; on the CPU: each run once).  Returns
        ``trace_count`` (``compile_bound`` from a cold engine); calling it
        again makes nothing new.  The engine takes the programs, and counts
        them, only once all of them are made: a failed run or capture
        raises and leaves it cold, so the next call makes them all again
        (a cold engine's programs never run)."""
        with self._lock:
            if self._decode is None:
                prefill, write, decode, host = self._make_programs()
                progs = [p for b in self.prompt_buckets
                         for p in (prefill[b], write[b])] + [decode]
                # The eager runs set each output: a cache write reads its
                # prefill's (the graph's static one once captured, so the
                # prefills are captured before the writes).
                with self._on_device():
                    for prog in progs:
                        prog.output = prog.eager()
                if self._cuda:
                    self._stream.synchronize()
                    with torch.cuda.device(self.device):
                        for prog in progs:
                            prog.capture(self._stream)
                    self._stream.synchronize()
                self._prefill, self._write, self._host = prefill, write, host
                self._decode = decode
                for _ in progs:
                    self._on_trace()
        with self._stats_lock:
            self.warmed = True
            return self.trace_count

    def _on_device(self):
        if not self._cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _wait(self) -> None:
        if self._cuda:
            self._done.record(self._stream)
            self._done.synchronize()

    # -- slot lifecycle ----------------------------------------------------

    def free_slots(self) -> int:
        with self._stats_lock:
            return len(self._free)

    def active_slots(self) -> int:
        with self._stats_lock:
            return self.slots - len(self._free)

    def bucket_for(self, n_tokens: int) -> int:
        for b in self.prompt_buckets:
            if n_tokens <= b:
                return b
        raise RequestTooLarge(
            f"{n_tokens} prompt tokens exceed the largest prompt bucket "
            f"{self.max_prompt}; shorten the prompt or restart with a "
            "larger --prefill_buckets set")

    def start_stream(self, prompt: Sequence[int]) -> Tuple[int, int]:
        """Admit one stream: take a slot, prefill its prompt into the slot's
        cache, and return ``(slot, first generated token)``, the TTFT
        boundary.  :class:`SlotsExhausted` when no slot is free,
        :class:`RequestTooLarge` past the largest prompt bucket."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token list, "
                             f"got shape {prompt.shape}")
        if np.any(prompt < 0) or np.any(prompt >= self.vocab):
            raise ValueError(f"prompt tokens must be in [0, {self.vocab})")
        n = int(prompt.size)
        bucket = self.bucket_for(n)
        if not self.warmed:
            self.warm()
        with self._stats_lock:
            if not self._free:
                raise SlotsExhausted(
                    f"all {self.slots} KV-cache slots are occupied")
            slot = self._free.pop(0)
        prefill, write = self._prefill[bucket], self._write[bucket]
        with self._lock:
            staged = self._host[f"tokens{bucket}"]
            arr = staged.numpy()
            arr[:n] = prompt
            arr[n:] = 0
            self._host["slot"].numpy()[0] = slot
            with self._on_device():
                prefill.inputs["tokens"].copy_(staged,
                                               non_blocking=self._cuda)
                write.inputs["slot"].copy_(self._host["slot"],
                                           non_blocking=self._cuda)
                logits, _, _ = prefill.run()
                write.run()
                self._host["row"].copy_(logits[n - 1],
                                        non_blocking=self._cuda)
                self._wait()
            first = int(np.argmax(self._host["row"].numpy()))
        with self._stats_lock:
            self._pos[slot] = n
            self.prefills += 1
            self.tokens_out += 1
        self._prefill_children[bucket].inc()
        self._g_active.set(self.active_slots())
        return slot, first

    def release(self, slot: int) -> None:
        """Return a finished or abandoned stream's slot to the free pool.
        No cache scrub: a later prefill overwrites from position 0, and
        nothing past a stream's position is ever read."""
        with self._stats_lock:
            if slot in self._pos:
                del self._pos[slot]
                self._free.append(slot)
        self._g_active.set(self.active_slots())

    def position(self, slot: int) -> int:
        with self._stats_lock:
            return self._pos[slot]

    # -- decoding ----------------------------------------------------------

    def decode(self, last_tokens: Dict[int, int]) -> Dict[int, int]:
        """One decode step for the ``{slot: last token}`` streams; every
        other slot rides along computing garbage nobody reads.  Returns
        ``{slot: next token}`` and advances each stream's position."""
        if not last_tokens:
            return {}
        out = self.decode_logits(last_tokens)
        return {slot: int(np.argmax(out[slot])) for slot in last_tokens}

    def decode_logits(self, last_tokens: Dict[int, int]) -> np.ndarray:
        """:meth:`decode`'s step, returning the float32 logits of every
        slot (``[slots, VOCAB]``, a host copy) instead of the choices."""
        if not self.warmed:
            self.warm()
        step = self._host["step"]
        with self._lock:
            arr = step.numpy()
            arr[:] = 0
            with self._stats_lock:
                for slot, tok in last_tokens.items():
                    pos = self._pos[slot]
                    if pos >= self.t_max:
                        raise ServeError(
                            f"slot {slot} is at T_MAX={self.t_max}; the "
                            "batcher must finish streams before the cache "
                            "runs out of positions")
                    arr[0, slot] = tok
                    arr[1, slot] = pos
            prog = self._decode
            with self._on_device():
                prog.inputs["tokens"].copy_(step[0], non_blocking=self._cuda)
                prog.inputs["positions"].copy_(step[1],
                                               non_blocking=self._cuda)
                logits = prog.run()
                self._host["logits"].copy_(logits, non_blocking=self._cuda)
                self._wait()
            out = self._host["logits"].numpy().copy()
        with self._stats_lock:
            for slot in last_tokens:
                self._pos[slot] += 1
            self.decode_steps += 1
            self.tokens_out += len(last_tokens)
        self._c_decode_steps.inc()
        return out

    # -- introspection -----------------------------------------------------

    def cache_buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The K and V caches (the tensors the programs write in place)."""
        return self._k, self._v

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "slots": self.slots,
                "active_slots": self.slots - len(self._free),
                "prompt_buckets": list(self.prompt_buckets),
                "compiled_executables": self.trace_count,
                "compile_bound": self.compile_bound,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_out": self.tokens_out,
                "t_max": self.t_max,
                "mesh_devices": 1,
                "compute_dtype": dtype_name(self.compute_dtype),
                "device": str(self.device),
                "checkpoint": {
                    "file": self.checkpoint_file,
                    "epoch": self.checkpoint_epoch,
                    "step": self.checkpoint_step,
                },
            }
