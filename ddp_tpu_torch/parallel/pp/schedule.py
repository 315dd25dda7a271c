"""GPipe and 1F1B micro-batch schedules, one process a stage (counterpart
of ``ddp_tpu/parallel/pp/schedule.py``).

The 3-D grid ``(data, model, stage)`` is a stack of S identical
``(data, model)`` planes.  Each rank holds only its stage's blocks
(:func:`stage_module_` cuts the model; ``PP_BLOCKS``, ``models/``) and runs
its part of the schedule (:func:`schedule_ops`, filtered to its stage):
the forward of its block range for each micro-batch, its backward through
the autograd graph the forward kept (the JAX package re-runs the stage
forward under ``jax.vjp``; here the graph is kept until its backward, so
no forward runs twice), and on the last stage the fused forward+backward
where the loss lives.  Activations go forward and cotangents back with
point-to-point sends between the neighbouring stages of one pipeline
(``parallel/dist.py::send_stage``/``recv_stage``).

Numerics are the ``--grad_accum`` step's (``train/step.py``), cut at block
boundaries: each stage differentiates its slice of the local objective
``ce_sum / (count * D)``, sums its micro-batches' gradients in order 0..A-1
and divides by A, then its update stage all-reduces them over its data
group and takes the SGD step (``train/step.py::make_group_update``).  The
crop/flip draws and the dropout masks are keyed on (data index, step,
micro-batch) as the accumulation step keys them, so ``(D, M, S)`` is the
``(D, M)`` ``--grad_accum A`` run bit for bit, and GPipe equals 1F1B (the
same per-stage order; 1F1B only changes when work runs, bounding the live
forward graphs at min(S, A) instead of A).

The trainer's side (the counterparts of ``place_state``, ``pp_shard_fn``
and ``eval_params_for``): :func:`stage_module_` and
:func:`stage_checkpoint` cut the state, :func:`pp_feed` sends the images to
stage 0 and the labels to the others, :func:`gather_eval_model` gathers the
parameters onto stage 0's plane for evaluation and
:func:`gather_whole_state` the whole state onto rank 0 for a save.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...models import get_model
from ...ops.losses import cross_entropy_sum_count
from .. import dist
from ..tp.plan import TPWiring, forward_kwargs
from .partition import StagePlan, predicted_bubble, stage_of_path

SCHEDULES = ("gpipe", "1f1b")


def schedule_ops(kind: str, num_micro: int, num_stages: int):
    """The enqueue order: a list of ``("F", j, k)`` / ``("B", j, k)`` /
    ``("FB", k)`` ops (stage j, micro k; the last stage always runs the
    fused FB).  Both schedules respect the same dependencies (F(j,k) after
    F(j-1,k), B(j,k) after B(j+1,k)/FB(k), per-stage micros in order), so
    they are numerically interchangeable; they differ in how long forward
    activations stay alive (GPipe: all A per stage; 1F1B: min(s, A))."""
    a, s = int(num_micro), int(num_stages)
    if kind not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {kind!r}; "
                         "expected 'gpipe' or '1f1b'")
    if s < 2:
        raise ValueError(f"a pipeline schedule needs s>=2 stages, got {s}")
    if kind == "gpipe":
        ops = [("F", j, k) for k in range(a) for j in range(s - 1)]
        for k in range(a):
            ops.append(("FB", k))
            ops.extend(("B", j, k) for j in range(s - 2, -1, -1))
        return ops
    # 1F1B: per-stage local sequences (warmup forwards, then strict
    # backward/forward alternation), merged into one dependency-
    # respecting enqueue order.
    local = []
    for j in range(s - 1):
        warm = min(a, s - 1 - j)
        seq = [("F", j, f) for f in range(warm)]
        fw, bw = warm, 0
        while bw < a:
            seq.append(("B", j, bw))
            bw += 1
            if fw < a:
                seq.append(("F", j, fw))
                fw += 1
        local.append(seq)
    local.append([("FB", k) for k in range(a)])

    done = set()

    def ready(op):
        if op[0] == "F":
            _, j, k = op
            return j == 0 or ("F", j - 1, k) in done
        if op[0] == "FB":
            return ("F", s - 2, op[1]) in done
        _, j, k = op
        return (("FB", k) if j == s - 2 else ("B", j + 1, k)) in done

    ptr = [0] * s
    ops = []
    total = sum(len(q) for q in local)
    while len(ops) < total:
        progressed = False
        for j in range(s):
            if ptr[j] < len(local[j]) and ready(local[j][ptr[j]]):
                op = local[j][ptr[j]]
                ops.append(op)
                done.add(op)
                ptr[j] += 1
                progressed = True
        if not progressed:  # pragma: no cover - schedule bug backstop
            raise RuntimeError("1F1B schedule deadlocked; per-stage "
                               f"pointers {ptr}")
    return ops


def stage_of(op, num_stages: int) -> int:
    """The stage an op of :func:`schedule_ops` runs on."""
    return num_stages - 1 if op[0] == "FB" else op[1]


# -- the state's cut ---------------------------------------------------------


class _Absent(nn.Module):
    """Where another stage's layer sits in a stage's model: no
    parameters, and a call is a bug."""

    def __init__(self, name: str):
        super().__init__()
        self.absent = name

    def forward(self, *_):
        raise RuntimeError(f"{self.absent} belongs to another pipeline "
                           f"stage")


def _tree_path(model_name: str, key: str) -> str:
    from ... import interop
    return interop.rule_of(model_name, key)[0]


def stage_keys(model_name: str, plan: StagePlan, k: int,
               keys: Iterable[str]) -> List[str]:
    """The port keys among ``keys`` (``state_dict`` or parameter names)
    that stage ``k`` owns, in their order."""
    return [key for key in keys
            if stage_of_path(plan, _tree_path(model_name, key)) == k]


def stage_module_(model: nn.Module, plan: StagePlan, k: int) -> None:
    """Cut ``model``, in place, to stage ``k``'s layers: each layer of
    another stage's blocks is replaced by a placeholder without
    parameters, so ``model.parameters()`` and ``model.state_dict()`` hold
    stage ``k``'s tensors only, under their usual names."""
    drop = {key.rsplit(".", 1)[0] for key, _ in model.named_parameters()
            if stage_of_path(plan, _tree_path(model.name, key)) != k}
    for prefix in sorted(drop):
        parent, _, leaf = prefix.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf,
                _Absent(prefix))


def stage_checkpoint(ckpt, plan: StagePlan, k: int):
    """``ckpt`` (whole trees, or a tensor-parallel rank's slices) cut to
    stage ``k``'s subtrees of the weights and the momentum, which
    ``checkpoint.restore`` loads into the stage's model."""
    from .partition import stage_subtree
    return ckpt._replace(params=stage_subtree(plan, k, ckpt.params),
                         momentum=stage_subtree(plan, k, ckpt.momentum))


def handoff_shapes(model_name: str, plan: StagePlan,
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> List[Tuple[int, ...]]:
    """The per-image shape of the activation leaving each stage but the
    last (the full-width activation a cut hands over), from the model's
    block forward on the meta device."""
    model = get_model(model_name, device="meta")
    model.eval()
    x = torch.zeros((1, 3, 32, 32), device="meta")
    out = []
    with torch.no_grad():
        for lo, hi in plan.stages[:-1]:
            x = model.forward_blocks(x, (lo, hi),
                                     compute_dtype=compute_dtype)
            out.append(tuple(x.shape[1:]))
    return out


def pp_feed(batches: Iterable[Dict[str, np.ndarray]], stage: int
            ) -> Iterator[Dict[str, np.ndarray]]:
    """The stacked ``[A, B, ...]`` group stream of one stage: stage 0 takes
    the images (with their labels, which ``gather_batch`` reads), the
    others the labels (the last computes the loss with them, a middle one
    reads only their count)."""
    for b in batches:
        yield b if stage == 0 else {"label": b["label"]}


# -- the step ----------------------------------------------------------------


class PPStep:
    """One optimizer step of this rank's pipeline stage:
    ``step_fn(state, micros, draws=None, dropout=None) -> loss``, the
    signature of ``train/epoch.py::make_train_step``'s step.  ``micros`` are
    the step's A micro-batches as :func:`pp_feed` gave them to this stage
    (images and labels on stage 0, labels elsewhere), on the device;
    ``draws(step, B, micro=k)`` gives stage 0's crop/flip draws under
    ``device_augment`` and ``dropout(step, micro=k)`` the dropout
    generator.  ``state`` holds the stage's model (:func:`stage_module_`)
    and its momentum.  ``loss`` is this rank's share of the step's
    global-mean loss on the last stage, and 0 on the others.

    Each stage's first step with a given A is a warm-up; its second is
    timed (CUDA events around the step and each op's compute on a card,
    the host clock on the CPU), which gives ``bubble``: the measured idle
    share of the pipeline's makespan against ``(s-1)/(A+s-1)``, and the
    ``pp_bubble`` span on ``tracer``.
    ``peak_inflight`` is the most forward graphs this stage held at once.
    """

    def __init__(self, model: nn.Module, plan: StagePlan, stage: int,
                 update: Callable, *, device: torch.device,
                 device_augment: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 tp: Optional[TPWiring] = None, schedule: str = "1f1b",
                 tracer=None):
        from ...train.step import micro_from_batch
        if plan.num_stages < 2:
            raise ValueError("the pipeline step needs s>=2 stages; run s=1 "
                             "through the standard step builders")
        schedule_ops(schedule, 1, plan.num_stages)  # validates the kind
        self.model, self.plan, self.stage = model, plan, int(stage)
        self.s = plan.num_stages
        self.schedule = schedule
        self.tracer = tracer
        self.device = torch.device(device)
        self._blocks = plan.stages[self.stage]
        self._cd = compute_dtype
        self._dtype = compute_dtype or torch.float32
        self._tp_kwargs = forward_kwargs(tp)
        self._world = dist.data_size()
        self._update = update
        self._get_micro = micro_from_batch(device_augment, self._dtype)
        shapes = handoff_shapes(model.name, plan, compute_dtype)
        self._in_shape = shapes[self.stage - 1] if self.stage else None
        self._out_shape = (shapes[self.stage] if self.stage < self.s - 1
                           else None)
        self._ops: Dict[int, list] = {}
        self._seen: Dict[int, int] = {}
        self.bubble: Optional[dict] = None
        self.peak_inflight = 0

    def _mark(self):
        """A point on this rank's timeline: a CUDA event recorded on the
        current stream on a card, the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _seconds(self, spans) -> float:
        """The summed seconds of ``(mark, mark)`` spans (on a card once the
        events have completed)."""
        if self.device.type != "cuda":
            return sum(b - a for a, b in spans)
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in spans) / 1e3

    def __call__(self, state, micros: List[Dict[str, torch.Tensor]],
                 draws=None, dropout=None) -> torch.Tensor:
        from ...train.step import _as_input
        a = len(micros)
        if a not in self._ops:
            self._ops[a] = [op for op in schedule_ops(self.schedule, a,
                                                      self.s)
                            if stage_of(op, self.s) == self.stage]
        self._seen[a] = self._seen.get(a, 0) + 1
        timed = self._seen[a] == 2
        step = state.step
        params = list(self.model.parameters())
        lo_stage, last = self.stage == 0, self.stage == self.s - 1
        self.model.train()
        saved: Dict[int, tuple] = {}   # micro -> (input, output)
        pending: list = []             # sends in flight
        loss = grads = None
        busy, inflight = [], 0  # busy: (mark, mark) of each op's compute
        start = self._mark() if timed else None

        def batch_of(k: int) -> int:
            return next(iter(micros[k].values())).shape[0]

        def recv(shape, src: int, k: int) -> torch.Tensor:
            return dist.recv_stage((batch_of(k),) + tuple(shape),
                                   self._dtype, self.device, src, tag=k)

        def generator(k: int):
            return None if dropout is None else dropout(step, micro=k)

        def accumulate(micro_loss, micro_grads):
            nonlocal loss, grads
            if grads is None:
                loss, grads = micro_loss, micro_grads
            else:
                if micro_loss is not None:
                    loss = loss + micro_loss
                grads = torch._foreach_add(grads, micro_grads)

        for op in self._ops[a]:
            k = op[-1]
            if op[0] == "F":
                if lo_stage:
                    x, _ = self._get_micro(
                        None if draws is None else
                        (lambda n, _k=k: draws(step, n, micro=_k)),
                        micros[k])
                    x = _as_input(x, self._cd)
                else:
                    x = recv(self._in_shape, self.stage - 1, k)
                    x.requires_grad_()
                t0 = self._mark() if timed else None
                out = self.model.forward_blocks(
                    x, self._blocks, compute_dtype=self._cd,
                    generator=generator(k), **self._tp_kwargs)
                if timed:
                    busy.append((t0, self._mark()))
                saved[k] = (None if lo_stage else x, out)
                inflight = max(inflight, len(saved))
                pending.append(dist.send_stage(out, self.stage + 1, tag=k))
            elif op[0] == "FB":
                x = recv(self._in_shape, self.stage - 1, k)
                x.requires_grad_()
                t0 = self._mark() if timed else None
                logits = self.model.forward_blocks(
                    x, self._blocks, compute_dtype=self._cd,
                    generator=generator(k), **self._tp_kwargs)
                ce_sum, count = cross_entropy_sum_count(
                    logits, micros[k]["label"])
                micro_loss = ce_sum / (count * self._world)
                *micro_grads, gx = torch.autograd.grad(micro_loss,
                                                       params + [x])
                if timed:
                    busy.append((t0, self._mark()))
                pending.append(dist.send_stage(gx, self.stage - 1, tag=k))
                accumulate(micro_loss.detach(), micro_grads)
            else:
                x, out = saved.pop(k)
                g = recv(self._out_shape, self.stage + 1, k)
                t0 = self._mark() if timed else None
                micro_grads = list(torch.autograd.grad(
                    out, params + ([] if x is None else [x]),
                    grad_outputs=g))
                if timed:
                    busy.append((t0, self._mark()))
                if x is not None:
                    gx = micro_grads.pop()
                    pending.append(dist.send_stage(gx, self.stage - 1,
                                                   tag=k))
                accumulate(None, micro_grads)
        dist.wait_sends(pending)
        end = self._mark() if timed else None  # the schedule's ops only
        if a > 1:
            grads = torch._foreach_div(grads, a)
            if loss is not None:
                loss = loss / a
        self._update(state, grads)
        self.peak_inflight = max(self.peak_inflight, inflight)
        if timed:
            self._record_bubble(a, self._seconds([(start, end)]),
                                self._seconds(busy), inflight, step)
        return loss if last else torch.zeros((), device=self.device)

    def _record_bubble(self, a: int, wall: float, busy: float,
                       inflight: int, step: int) -> None:
        """The timed step's measured bubble: every rank's (wall seconds of
        its part of the step, busy seconds, peak in-flight graphs) gathered
        over the side group, this pipeline's rows read.  The makespan is
        the longest wall (each stage enters the step together and the last
        one to finish waited on the others), and the bubble the share of
        ``s`` times it the stages were not busy."""
        rows = dist.all_gather_rows(
            np.array([wall, busy, inflight], np.float32),
            kind="pp_bubble")
        mesh = dist.mesh()
        mine = [rows[r] for r in mesh.stage_ranks(mesh.data_index,
                                                  mesh.model_index)]
        makespan = float(max(r[0] for r in mine))
        total_busy = float(sum(r[1] for r in mine))
        measured = (1.0 - total_busy / (self.s * makespan)) if makespan \
            else 0.0
        self.bubble = {
            "schedule": self.schedule, "num_stages": self.s,
            "num_micro": a, "bubble_measured": measured,
            "bubble_predicted": float(predicted_bubble(self.s, a)),
            "makespan_s": makespan,
            "peak_inflight_acts": int(max(r[2] for r in mine))}
        if self.tracer is not None:
            bubble_s = (self.s * makespan - total_busy) / self.s
            self.tracer.add_span("pp_bubble", time.monotonic() - bubble_s,
                                 bubble_s, step=step)


# -- gathers onto stage 0 and rank 0 -----------------------------------------


def gather_eval_model(model: nn.Module, plan: StagePlan, tp_plan,
                      model_index: int) -> Optional[nn.Module]:
    """Every stage's parameters on stage 0 of this rank's pipeline, for
    evaluation there (``ddp_tpu/cli.py:1132-1144``): each stage k > 0 sends
    its (tensor-parallel) slices to stage 0, one flat buffer, and stage 0
    returns a whole model of its slices, its own stage copied from
    ``model``; the other stages return None.  Every rank of the pipeline
    calls it; counted as ``pp_state``."""
    stage = dist.stage_index()
    if stage != 0:
        with torch.no_grad():
            flat = dist._flat(list(model.parameters()))
        dist.wait_sends([dist.send_stage(flat, 0, kind="pp_state")])
        return None
    device = next(model.parameters()).device
    whole = get_model(model.name, device=device)
    if tp_plan is not None and tp_plan.model_size > 1:
        from ..tp.plan import shard_module_
        shard_module_(whole, tp_plan, model_index)
    named = dict(whole.named_parameters())
    own = dict(model.named_parameters())
    with torch.no_grad():
        for key, p in own.items():
            named[key].copy_(p)
        for k in range(1, plan.num_stages):
            keys = stage_keys(model.name, plan, k, named)
            like = [named[key] for key in keys]
            flat = dist.recv_stage((sum(t.numel() for t in like),),
                                   like[0].dtype, device, k,
                                   kind="pp_state")
            torch._foreach_copy_(like, dist._views(flat, like))
    return whole


def gather_whole_state(sd: Dict[str, torch.Tensor],
                       mom: Dict[str, torch.Tensor], model_name: str,
                       plan: StagePlan
                       ) -> Optional[Tuple[Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]]:
    """The whole ``state_dict`` and momentum on rank 0, from each stage's
    whole (tensor-parallel gathered) ``sd`` and ``mom``: the rank at data
    and model index 0 of each stage k > 0 sends its stage's, one flat
    buffer; rank 0 returns the whole state in the model's order, every
    other rank None.  Counted as ``pp_state``."""
    mesh = dist.mesh()
    stage = mesh.stage_index
    if mesh.data_index or mesh.model_index:
        return None
    if stage != 0:
        with torch.no_grad():
            flat = dist._flat(list(sd.values()) + list(mom.values()))
        dist.wait_sends([dist.send_stage(flat, 0, kind="pp_state")])
        return None
    device = next(iter(sd.values())).device
    meta = get_model(model_name, device="meta")
    full_sd = meta.state_dict()
    full_names = [n for n, _ in meta.named_parameters()]
    out_sd: Dict[str, torch.Tensor] = dict(sd)
    out_mom: Dict[str, torch.Tensor] = dict(mom)
    for k in range(1, plan.num_stages):
        sd_keys = stage_keys(model_name, plan, k, full_sd)
        mom_keys = stage_keys(model_name, plan, k, full_names)
        like = ([torch.empty(full_sd[n].shape, dtype=full_sd[n].dtype)
                 for n in sd_keys]
                + [torch.empty(full_sd[n].shape, dtype=full_sd[n].dtype)
                   for n in mom_keys])
        flat = dist.recv_stage((sum(t.numel() for t in like),),
                               like[0].dtype, device, k, kind="pp_state")
        views = dist._views(flat, like)
        out_sd.update(zip(sd_keys, views[:len(sd_keys)]))
        out_mom.update(zip(mom_keys, views[len(sd_keys):]))
    return ({n: out_sd[n] for n in full_sd},
            {n: out_mom[n] for n in full_names})
