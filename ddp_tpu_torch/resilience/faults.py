"""Fault injection for drills: the failures the resilience layer exists
for, made reproducible (counterpart of ``ddp_tpu/resilience/faults.py``).

Nothing here runs on a production path: each injector wraps a method of
one ``Trainer`` instance, serve replica or fleet (no global state), and
the two production touchpoints, :func:`install_env_faults` (a trainer)
and :func:`install_serve_faults` (a serve fleet), do nothing unless
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
  ``fail_ckpt_write``   the write of epoch k's checkpoint dies on the
                        writer thread: the error must surface at the next
                        join, and the lineage stays as it was
  ``fail_put``          the next n mirror uploads fail: the uploader's
                        retries absorb them
  ``slow_put``          every mirror upload stalls ms milliseconds: the
                        mirror lags, the steps do not
  ``torn_remote_object`` the next mirror upload lands truncated under the
                        full-length sha: the mirror walk skips it
  ``wipe_local_ckpt``   every local lineage file goes after epoch k's
                        checkpoint is committed and mirrored: the mirror
                        is the only copy

Serve faults (a fleet's replicas and its hot-swap watcher):
  ``crash_replica_at_request_n``  a replica dies for good at its n-th
                        submit: the router retries elsewhere and ejects it
  ``slow_forward_ms``   every submit on a replica takes ms longer: a
                        straggler the routing steers around
  ``torn_publish``      the head is torn right before the watcher's next
                        load: the swap is skipped with a named event

``DDP_TPU_FAULT`` holds semicolon-separated specs ``kind@key=val,...``:
``sigterm@epoch=1``, ``sigterm@step=12``, ``poison@step=5``,
``flip_param_bit@step=6,replica=1``, ``poison_batch@step=9,scale=1e4``,
``stall@epoch=0,rank=1,secs=600``, ``fail_ckpt_write@epoch=1``,
``fail_put@n=2``, ``slow_put@ms=500``, ``torn_remote_object@``,
``wipe_local_ckpt@epoch=0`` (the meanings and key checks of
``ddp_tpu/resilience/faults.py``); a serve process takes
``crash_replica@requests=25,replica=0``, ``slow_forward@ms=50,replica=1``
and ``torn_publish@``.  Each vocabulary refuses the other's kinds.
"""
from __future__ import annotations

import collections
import os
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..train import checkpoint as ckpt_lib

FAULT_ENV = "DDP_TPU_FAULT"


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


def fail_ckpt_write(trainer, epoch: int) -> None:
    """The write of epoch ``epoch``'s checkpoint dies on the writer thread,
    once (a full disk, a lost mount).  It fails in
    ``lineage.preserve_head()``, the writer's first call, so the head is
    never opened and the lineage stays byte for byte as it was; the error
    must surface at the next ``_join_pending_save``.  The epoch rides a
    queue from the main thread's save call to the writer: the joins
    serialise the writers, so the order matches.  Rank 0 only (the writer
    is rank 0's)."""
    if trainer.lineage is None:
        raise ValueError("fail_ckpt_write needs a trainer with a snapshot "
                         "path (no lineage, no writer thread)")
    orig_save = trainer._checkpoint
    orig_preserve = trainer.lineage.preserve_head
    pending = collections.deque()
    fired = [False]

    def save(ep, data_state=None):
        pending.append(int(ep))
        return orig_save(ep, data_state)

    def preserve():
        ep = pending.popleft() if pending else None
        if not fired[0] and ep == int(epoch):
            fired[0] = True
            _say(f"failing the checkpoint write of epoch {ep} on the "
                 f"writer thread")
            raise OSError(28, f"injected checkpoint write failure at "
                              f"epoch {ep}")
        return orig_preserve()

    trainer._checkpoint = save
    trainer.lineage.preserve_head = preserve


def crash_replica_at_request_n(replica, n: int) -> None:
    """Replica ``replica`` dies for good at its ``n``-th submit: the latched
    ``crashed`` flag makes every later submit AND health probe fail, so the
    router both retries the victim request elsewhere and (after
    ``eject_after`` probes) ejects the replica from rotation — the closest
    in-process model of a killed serve process."""
    orig = replica.submit
    lock = threading.Lock()
    count = [0]

    def wrapped(images, timeout=None, req=None):
        with lock:
            count[0] += 1
            c = count[0]
        if c >= n:
            if not replica.crashed:
                _say(f"replica {replica.replica_id} crashing at request {c}")
            replica.crashed = True
        return orig(images, timeout=timeout, req=req)

    replica.submit = wrapped


def slow_forward_ms(replica, ms: float) -> None:
    """Every submit on ``replica`` takes ``ms`` longer: a straggling replica
    the least-loaded routing should steer around and the per-request
    deadline budget must bound."""
    orig = replica.submit
    delay_s = float(ms) / 1e3

    def wrapped(images, timeout=None, req=None):
        time.sleep(delay_s)
        return orig(images, timeout=timeout, req=req)

    replica.submit = wrapped


def torn_publish(fleet) -> None:
    """Truncate the resolved head file right before the fleet's NEXT
    snapshot load (once): the watcher's full lineage walk must then skip
    the publish with a named ``swap_skipped`` event and keep serving the
    current snapshot."""
    orig = fleet._load_snapshot
    fired = [False]

    def wrapped():
        if not fired[0]:
            fired[0] = True
            from .lineage import _resolve_head
            head = _resolve_head(fleet.snapshot_path)
            if os.path.exists(head):
                _say(f"tearing published head {head!r} before the watcher "
                     "loads it")
                tear_file(head)
        return orig()

    fleet._load_snapshot = wrapped


def _known_kwargs(kind: str, part: str, kv: dict, allowed) -> None:
    """A typo'd key fails the drill at install time instead of arming
    nothing."""
    unknown = sorted(set(kv) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown kwarg(s) {unknown} for {FAULT_ENV} fault {kind!r} "
            f"in {part!r} (allowed: {sorted(allowed)})")


def _mirror_store_of(trainer):
    """The trainer's ``DirStore`` mirror, to inject into: the mirror faults
    are a drill wiring error without ``--mirror``."""
    store = getattr(trainer, "_mirror_store", None)
    if store is None or not hasattr(store, "inject_fail_puts"):
        raise ValueError(
            f"{FAULT_ENV} mirror fault needs a trainer running with "
            "--mirror over a DirStore backend (no store to inject into)")
    return store


def fail_put(trainer, n) -> None:
    """The next ``n`` mirror uploads fail at the store (a flaky remote)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"fail_put: n must be >= 1, got {n}")
    _mirror_store_of(trainer).inject_fail_puts(n)
    _say(f"next {n} mirror put(s) will fail")


def slow_put(trainer, ms) -> None:
    """Every mirror upload stalls ``ms`` milliseconds at the store (a hung
    remote): the per-op deadline bounds it, the steps go on."""
    ms = float(ms)
    if ms < 0:
        raise ValueError(f"slow_put: ms must be >= 0, got {ms:g}")
    _mirror_store_of(trainer).inject_slow_put(ms / 1e3)
    _say(f"mirror puts slowed by {ms:g} ms")


def torn_remote_object(trainer) -> None:
    """The next mirror upload lands truncated while the store records the
    full-length sha: the mirror walk must detect it at get time and fall
    back to the next mirrored object."""
    _mirror_store_of(trainer).inject_torn_next_put()
    _say("next mirror put will land torn")


def wipe_local_ckpt(trainer, epoch) -> None:
    """Delete every local lineage file (head, manifest, rotated snapshots,
    shard files) once epoch ``epoch``'s checkpoint has committed and been
    mirrored: total local-disk loss.  Fires at the start of the next epoch,
    after the write's join and a bounded mirror drain; later saves make a
    new head, and a relaunch restores from the mirror."""
    epoch = int(epoch)
    if epoch < 0:
        raise ValueError(f"wipe_local_ckpt: epoch must be >= 0, got {epoch}")
    path = getattr(trainer, "snapshot_path", None)
    if not path:
        raise ValueError("wipe_local_ckpt needs a trainer with a snapshot "
                         "path (nothing local to wipe)")
    orig = trainer._run_epoch
    fired = [False]

    def wrapped(ep, *a, **kw):
        if not fired[0] and ep > epoch:
            fired[0] = True
            trainer._join_pending_save()
            trainer._mirror_drain(60.0)
            d = os.path.dirname(os.path.abspath(path))
            base = os.path.basename(path)
            victims = [f for f in os.listdir(d)
                       if f == base or f.startswith(base + ".")]
            for v in victims:
                try:
                    os.unlink(os.path.join(d, v))
                except OSError:
                    pass
            _say(f"wiped {len(victims)} local checkpoint file(s) under "
                 f"{d!r} after epoch {epoch}; the mirror is the only copy "
                 f"now")
        return orig(ep, *a, **kw)

    trainer._run_epoch = wrapped


def _specs():
    """``(kind, part, kwargs)`` of each :data:`FAULT_ENV` spec (none when
    the variable is unset)."""
    spec = os.environ.get(FAULT_ENV)
    for part in (spec or "").split(";"):
        part = part.strip()
        if part:
            kind, _, argstr = part.partition("@")
            yield kind, part, dict(a.split("=", 1)
                                   for a in argstr.split(",") if a)


def install_serve_faults(fleet) -> None:
    """Apply the :data:`FAULT_ENV` serve-fault specs to ``fleet`` (nothing
    when the variable is unset).  Specs use the serve vocabulary only: a
    serve process given a trainer spec is a drill wiring error and fails
    loudly."""
    for kind, part, kv in _specs():
        if kind == "crash_replica":
            idx = int(kv.get("replica", "0"))
            crash_replica_at_request_n(fleet.replicas[idx],
                                       int(kv["requests"]))
        elif kind == "slow_forward":
            idx = int(kv.get("replica", "0"))
            slow_forward_ms(fleet.replicas[idx], float(kv["ms"]))
        elif kind == "torn_publish":
            torn_publish(fleet)
        else:
            raise ValueError(f"unknown {FAULT_ENV} serve fault kind "
                             f"{kind!r} in {part!r}")


def install_env_faults(trainer) -> None:
    """Apply the :data:`FAULT_ENV` specs to ``trainer`` (nothing when the
    variable is unset)."""
    for kind, part, kv in _specs():
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
        elif kind == "fail_ckpt_write":
            fail_ckpt_write(trainer, int(kv["epoch"]))
        elif kind == "fail_put":
            _known_kwargs(kind, part, kv, ("n",))
            fail_put(trainer, kv.get("n", "1"))
        elif kind == "slow_put":
            _known_kwargs(kind, part, kv, ("ms",))
            slow_put(trainer, kv["ms"])
        elif kind == "torn_remote_object":
            _known_kwargs(kind, part, kv, ())
            torn_remote_object(trainer)
        elif kind == "wipe_local_ckpt":
            _known_kwargs(kind, part, kv, ("epoch",))
            wipe_local_ckpt(trainer, kv["epoch"])
        else:
            raise ValueError(f"unknown {FAULT_ENV} fault kind {kind!r} "
                             f"in {part!r}")
