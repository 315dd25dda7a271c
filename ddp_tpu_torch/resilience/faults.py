"""Fault injection for drills: the failures the resilience layer exists
for, made reproducible (counterpart of the training half of
``ddp_tpu/resilience/faults.py``).

Nothing here runs on a production path: each injector wraps a method of
one ``Trainer`` instance (no global state), and the one production
touchpoint, :func:`install_env_faults`, does nothing unless
:data:`FAULT_ENV` is set.

Faults:
  ``tear_file``         truncate a checkpoint (outside damage; the atomic
                        saver never tears one itself)
  ``poison_loss``       the loss recorded at global step k becomes NaN,
                        once: drives the ``--on_nan`` policies
  ``sigterm_at_epoch``  SIGTERM to this process after epoch k runs: the
                        epoch-boundary preemption drill
  ``sigterm_at_step``   SIGTERM right before global step k dispatches: the
                        mid-epoch preemption drill (``data_state`` resume)
  ``flip_param_bit``    flip one bit of a parameter on one rank before step
                        k: the silent corruption the drift audit exists for
  ``poison_batch``      the batch of step k reaches the model as its raw
                        pixels times ``scale``: the loss spike the rolling
                        guard bounds
  ``torn_data_state``   tear a checkpoint's ``data_state`` record: resume
                        must fall back to the epoch boundary, warned once
  ``stall_at_epoch``    one rank sleeps after epoch k: the hung peer the
                        watchdog bounds

``DDP_TPU_FAULT`` holds semicolon-separated specs ``kind@key=val,...``:
``sigterm@epoch=1``, ``sigterm@step=12``, ``poison@step=5``,
``flip_param_bit@step=6,replica=1``, ``poison_batch@step=9,scale=1e4``,
``stall@epoch=0,rank=1,secs=600``.  The JAX package's other kinds wait for
what they break: ``fail_ckpt_write`` and the mirror faults for the
asynchronous writer and the store (ROADMAP A7b), the serve faults for the
fleet (A9); a spec naming one raises, naming its item.
"""
from __future__ import annotations

import os
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..train import checkpoint as ckpt_lib

FAULT_ENV = "DDP_TPU_FAULT"
# Kinds of the JAX package's vocabulary the port does not run yet, with the
# ROADMAP item that brings what each fault breaks.
NOT_YET = {"fail_ckpt_write": "A7b", "fail_put": "A7b", "slow_put": "A7b",
           "torn_remote_object": "A7b", "wipe_local_ckpt": "A7b",
           "crash_replica": "A9", "slow_forward": "A9",
           "torn_publish": "A9"}


def _say(msg: str) -> None:
    print(f"[fault] {msg}", file=sys.stderr)
    sys.stderr.flush()


def tear_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate ``path`` to ``keep_fraction`` of its bytes (at least one
    byte shorter)."""
    size = os.path.getsize(path)
    keep = min(int(size * keep_fraction), size - 1)
    with open(path, "r+b") as f:
        f.truncate(max(keep, 0))


def poison_loss(trainer, step: int, value: float = float("nan")) -> None:
    """The loss recorded at global step ``step`` becomes ``value``, once (a
    latch: after an ``--on_nan restore`` rewinds past ``step`` it does not
    fire again, as a transient would not).  Hooks the loss flush, where the
    guard sees a real divergence."""
    orig = trainer._flush_losses
    fired = [False]

    def wrapped(epoch, start_step, losses):
        if not fired[0] and start_step <= step < start_step + len(losses):
            losses = list(losses)
            losses[step - start_step] = value
            fired[0] = True
        return orig(epoch, start_step, losses)

    trainer._flush_losses = wrapped


def _after_epoch(trainer, fn) -> None:
    orig = trainer._run_epoch

    def wrapped(epoch, *a, **kw):
        orig(epoch, *a, **kw)
        fn(epoch)

    trainer._run_epoch = wrapped


def _before_step(trainer, fn) -> None:
    """Wrap ``trainer.train_step`` so ``fn(state, global_step)`` runs before
    each dispatch (the host's step count, resume-aware)."""
    orig = trainer.train_step

    def wrapped(state, micros, draws=None, dropout=None):
        fn(state, state.step)
        return orig(state, micros, draws, dropout)

    trainer.train_step = wrapped


def sigterm_at_step(trainer, step: int) -> None:
    """SIGTERM to this process right before global step ``step``
    dispatches: a preemption notice landing mid-epoch.  The step-boundary
    check stops before the next step, with a mid-epoch ``data_state``."""
    fired = [False]

    def fire(state, s):
        if not fired[0] and s >= step:
            fired[0] = True
            _say(f"delivering SIGTERM before step {s}")
            os.kill(os.getpid(), signal.SIGTERM)

    _before_step(trainer, fire)


def flip_param_bit(trainer, step: int, replica: int = 1,
                   bit: int = 28) -> None:
    """Flip bit ``bit`` of the first element of the first parameter leaf
    (``ddp_tpu``'s flatten order) on rank ``replica`` only, right before
    global step ``step`` dispatches: an upset on one card.  Replicas then
    apply the same updates to different values, so the divergence persists
    until the drift audit names the leaf.  Bit 28 is a float32 exponent
    bit: even on a 0.0 leaf the flip gives a normal number (2^-95), which
    survives arithmetic where a denormal would be flushed."""
    from ..parallel import dist
    from .drift import leaf_order, leaf_paths
    fired = [False]

    @torch.no_grad()
    def fire(state, s):
        if fired[0] or s < step:
            return
        fired[0] = True
        world = dist.world_size()
        r = replica % world
        if dist.rank() != r:
            return
        model = state.model
        leaf = list(model.parameters())[leaf_order(model)[0]]
        if leaf.element_size() == 4:
            b = bit % 32
            # The int32 word with bit b set (bit 31 is the sign).
            words, mask = leaf.view(-1).view(torch.int32), \
                (1 << b) - (1 << 32 if b == 31 else 0)
        else:
            words, mask = leaf.view(-1).view(torch.uint8), 1 << (bit % 8)
        words[:1].bitwise_xor_(mask)
        _say(f"flipped bit {bit} of param leaf {leaf_paths(model)[0]!r} on "
             f"replica {r} before step {s}")

    _before_step(trainer, fire)


def poison_batch(trainer, step: int, scale: float = 1e4) -> None:
    """The batch at global step ``step``, once, reaches the model as its
    raw pixel values times ``scale``: a corrupted input shard, whose loss
    spikes by orders of magnitude.  The JAX drill feeds that float batch
    past its u8/255; here ``gather_batch`` has divided, so the model's
    input is scaled by ``255 * scale``."""
    orig = trainer.train_step
    fired = [False]

    def wrapped(state, micros, draws=None, dropout=None):
        if fired[0] or state.step < step:
            return orig(state, micros, draws, dropout)
        fired[0] = True
        _say(f"poisoned batch at step {state.step} (x{scale:g})")
        handle = state.model.register_forward_pre_hook(
            lambda m, args, kwargs: ((args[0] * (255.0 * scale),)
                                     + args[1:], kwargs),
            with_kwargs=True)
        try:
            return orig(state, micros, draws, dropout)
        finally:
            handle.remove()

    trainer.train_step = wrapped


def torn_data_state(path: str) -> None:
    """Replace a checkpoint's ``data_state`` record with torn bytes (the
    file is rewritten, so a lineage manifest's sha no longer matches).
    Resume must read the record as absent: the epoch boundary, warned."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    flat["meta/data_state_json"] = np.frombuffer(b'{"torn', np.uint8)
    ckpt_lib.write_npz_hashed(path, flat)
    _say(f"tore the data_state record of {path!r}")


def sigterm_at_epoch(trainer, epoch: int) -> None:
    """SIGTERM to this process right after epoch ``epoch`` runs, before the
    save gate and the preemption check."""

    def fire(e):
        if e == epoch:
            _say(f"delivering SIGTERM after epoch {e}")
            os.kill(os.getpid(), signal.SIGTERM)

    _after_epoch(trainer, fire)


def stall_at_epoch(trainer, epoch: int, seconds: float,
                   rank: Optional[int] = None) -> None:
    """Sleep ``seconds`` after epoch ``epoch`` on ``rank`` (every rank when
    None): a wedged rank; its peers block in their next collective."""
    from ..parallel import dist

    def fire(e):
        if e == epoch and (rank is None or dist.rank() == rank):
            _say(f"rank {dist.rank()} stalling {seconds:.0f}s after epoch "
                 f"{e}")
            time.sleep(seconds)

    _after_epoch(trainer, fire)


def install_env_faults(trainer) -> None:
    """Apply the :data:`FAULT_ENV` specs to ``trainer`` (nothing when the
    variable is unset)."""
    spec = os.environ.get(FAULT_ENV)
    if not spec:
        return
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, argstr = part.partition("@")
        kv = dict(a.split("=", 1) for a in argstr.split(",") if a)
        if kind == "sigterm":
            if "step" in kv:
                sigterm_at_step(trainer, int(kv["step"]))
            else:
                sigterm_at_epoch(trainer, int(kv["epoch"]))
        elif kind == "flip_param_bit":
            flip_param_bit(trainer, int(kv["step"]),
                           replica=int(kv.get("replica", "1")),
                           bit=int(kv.get("bit", "28")))
        elif kind == "poison_batch":
            poison_batch(trainer, int(kv["step"]),
                         scale=float(kv.get("scale", "1e4")))
        elif kind == "poison":
            poison_loss(trainer, int(kv["step"]),
                        float(kv.get("value", "nan")))
        elif kind == "stall":
            stall_at_epoch(trainer, int(kv["epoch"]),
                           float(kv.get("secs", "3600")),
                           rank=int(kv["rank"]) if "rank" in kv else None)
        elif kind in NOT_YET:
            raise ValueError(
                f"{FAULT_ENV} fault kind {kind!r} in {part!r} is not ported "
                f"yet: what it breaks comes with ROADMAP {NOT_YET[kind]}")
        else:
            raise ValueError(f"unknown {FAULT_ENV} fault kind {kind!r} "
                             f"in {part!r}")
