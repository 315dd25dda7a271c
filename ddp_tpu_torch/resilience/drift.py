"""Cross-replica silent-data-corruption audit: bit-level parameter
fingerprints compared over the ranks with two small all-reduces
(counterpart of ``ddp_tpu/resilience/drift.py``).

Data-parallel training applies the same update to the same parameters on
every rank (the lockstep DDP relies on, multigpu.py:97), so the replicas
must agree bit for bit and any disagreement is a fault (a flipped memory
bit, a bad kernel on one card, a torn copy): no tolerance.

Each rank folds every parameter into a 32-bit fingerprint
(:func:`_leaf_fingerprint`, bit for bit the JAX package's: a
multiplicative hash over the raw bits with the position mixed in, not a
float sum, which could cancel a corruption or differ in reduction order).
Replica 0's row reaches every rank as one sum all-reduce of a row that is
zero on the other ranks; the second sums a ``[world, L]`` matrix in which
each rank fills its own row with its mismatches against it, so every rank
reads which leaves and which replicas diverge.  The audit fingerprints the
port's own layout (OIHW kernels): the replicas are compared with each
other, never with the JAX package's tree.  Leaves are taken and named in
``ddp_tpu``'s flatten order and key paths (``['backbone']['bn0']['bias']``,
through ``interop.py``'s mapping), so an event names what JAX's would.

Integers: ``torch.uint32`` has few operations, so the hash runs in int64
on values below 2^32, each product split into 16-bit halves
(:func:`_mul32`) so no int64 product overflows.

A divergence logs a ``drift_detected`` event naming the leaves and
replicas, then takes the action: ``abort`` (:class:`DriftDetectedError`)
or ``restore`` (the trainer's :class:`~.guard.RestoreFromLastGood` path,
sharing the guard's restore budget).
"""
from __future__ import annotations

import sys
from typing import List

import torch
from torch import nn

from .. import interop
from ..parallel import dist

DRIFT_ACTIONS = ("abort", "restore")

# Knuth's multiplicative constant, and the golden-ratio position mixer.
_HASH_MULT = 2654435761
_POS_MULT = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


class DriftDetectedError(RuntimeError):
    """Replicas disagree bit for bit and the action said stop."""


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant
    ``c`` < 2^32, from 16-bit halves: no partial product reaches 2^34."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    a_lo = a & 0xFFFF
    cross = ((a >> 16) * c_lo + a_lo * c_hi) & 0xFFFF
    return (a_lo * c_lo + (cross << 16)) & _MASK32


def _leaf_fingerprint(x: torch.Tensor) -> torch.Tensor:
    """One tensor's uint32 checksum of its raw bits, as an int64 scalar on
    its device; equal to ``ddp_tpu``'s ``_leaf_fingerprint`` of the same
    1-D array.  32-bit dtypes are taken bit for bit; other widths are cast
    to float32 first (deterministic and comparable across replicas, just
    quantised)."""
    flat = x.detach().reshape(-1)
    if flat.dtype.itemsize != 4:
        flat = flat.to(torch.float32)
    bits = flat.view(torch.int32).to(torch.int64) & _MASK32
    pos = torch.arange(bits.numel(), dtype=torch.int64, device=bits.device)
    h = _mul32(bits ^ _mul32(pos, _POS_MULT), _HASH_MULT)
    h = h ^ (h >> 15)
    return h.sum() & _MASK32


def _keystr(path: str) -> str:
    return "".join(f"['{k}']" for k in path.split("/"))


def leaf_order(model: nn.Module) -> List[int]:
    """Indices into ``list(model.parameters())`` in ``ddp_tpu``'s flatten
    order (its dicts' sorted keys, level by level)."""
    paths = interop.param_tree_paths(model)
    return sorted(range(len(paths)), key=lambda i: paths[i].split("/"))


def leaf_paths(model: nn.Module) -> List[str]:
    """The parameters' ``ddp_tpu`` key paths in flatten order: the names a
    ``drift_detected`` event reports."""
    paths = interop.param_tree_paths(model)
    return [_keystr(paths[i]) for i in leaf_order(model)]


def fingerprints(model: nn.Module) -> torch.Tensor:
    """``[L]`` int64 fingerprints of ``model``'s parameters in flatten
    order, on their device."""
    params = list(model.parameters())
    return torch.stack([_leaf_fingerprint(params[i])
                        for i in leaf_order(model)])


def audit_counts(model: nn.Module) -> torch.Tensor:
    """The ``[world, L]`` mismatch matrix, the same on every rank: entry
    ``(r, i)`` is 1 where rank r's fingerprint of leaf i differs from rank
    0's.  Two sum all-reduces (``collective_calls["drift_audit"]``); at
    world 1 without a group, zeros."""
    fps = fingerprints(model)
    rank, world = dist.rank(), dist.world_size()
    fp0 = dist.all_reduce_sum_(fps if rank == 0 else torch.zeros_like(fps),
                               kind="drift_audit")
    mism = torch.zeros((world, fps.numel()), dtype=torch.int64,
                       device=fps.device)
    mism[rank] = (fps != fp0).to(torch.int64)
    return dist.all_reduce_sum_(mism, kind="drift_audit")


class DriftAuditor:
    """The every-K-steps audit of the trainer's streaming loop.

    Synchronous by design: an audit reads its mismatch matrix to the host
    and decides before the next dispatch, so a corruption cannot spread
    through K more steps and checkpoint writes while the verdict waits.
    It costs a device sync and a fingerprint pass every K steps."""

    def __init__(self, model: nn.Module, *, every: int,
                 action: str = "abort"):
        if action not in DRIFT_ACTIONS:
            raise ValueError(
                f"drift_action must be one of {DRIFT_ACTIONS}, got "
                f"{action!r}")
        self.every = int(every)
        self.action = action
        self.paths = leaf_paths(model)
        self.last_audit_step = -1  # the stall line's and /healthz's

    def due(self, step: int) -> bool:
        return self.every > 0 and step > 0 and step % self.every == 0

    def audit(self, model: nn.Module, step: int, *, metrics=None,
              guard=None) -> None:
        """Run one audit at global ``step``; raise per the action on a
        divergence.  ``guard`` (the trainer's StepHealthGuard) holds the
        restore budget ``action='restore'`` shares."""
        mism = audit_counts(model).tolist()  # [world][L]
        self.last_audit_step = int(step)
        counts = [sum(col) for col in zip(*mism)]
        if not any(counts):
            return
        bad = [i for i, c in enumerate(counts) if c]
        bad_paths = [self.paths[i] for i in bad[:16]]
        bad_replicas = sorted({r for r, row in enumerate(mism)
                               for i in bad if row[i]})
        msg = (f"cross-replica parameter drift at global step {step}: "
               f"{len(bad)}/{len(counts)} leaves diverge "
               f"(e.g. {bad_paths[:4]}), replicas {bad_replicas[:8]} "
               "disagree with replica 0 — silent data corruption on at "
               "least one replica")
        print(f"WARNING: {msg}", file=sys.stderr)
        sys.stderr.flush()
        if metrics is not None:
            metrics.log_event(
                "drift_detected", step=int(step), action=self.action,
                leaves=bad_paths, replicas=bad_replicas[:32],
                n_leaves_diverged=len(bad))
            metrics.fsync()  # the verdict must survive an abort
        if self.action == "restore":
            from .guard import RestoreFromLastGood
            if guard is not None:
                if guard.restores >= guard.max_restores:
                    raise DriftDetectedError(
                        f"{msg}; restore budget exhausted "
                        f"({guard.restores}/{guard.max_restores})")
                guard.restores += 1
                guard.last_decision = f"drift_restore@step={int(step)}"
            print("WARNING: --drift_action restore: reloading the last "
                  "verified checkpoint", file=sys.stderr)
            sys.stderr.flush()
            raise RestoreFromLastGood(msg)
        raise DriftDetectedError(
            f"{msg}; --drift_action abort (pass --drift_action restore "
            "to roll back to the last verified checkpoint instead)")
