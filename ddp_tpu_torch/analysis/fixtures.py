"""Seeded-faulty fixtures, one per static pass: each is source text the
matching pass MUST flag (and the port's own tree must not).  They are the
passes' own regression suite: ``python -m ddp_tpu_torch.analysis --fixture
<name>`` exits nonzero under ``--strict`` for every name here, and
``tests/test_torch_analysis.py`` pins each pass to its fixture, so a
refactor that silently blinds a check fails the tests.

The names are those of ``ddp_tpu/analysis/fixtures.py``'s source-text
fixtures; the sources are written in the port's idiom.  JAX's jaxpr
fixtures trace programs, which the port builds only with its program
registry: each is refused by name with the item that ports it
(:data:`REFUSED`).  Nothing here executes on a device.
"""
from __future__ import annotations

import textwrap
from typing import Callable, Dict, List

from .findings import Finding

_HOT_LOOP_DEVICE_GET = textwrap.dedent("""\
    import torch

    def run_epoch(trainer, batches):
        losses, host = [], None
        for batch in batches:
            loss = trainer.train_step(trainer.state, batch)
            losses.append(loss.item())        # implicit per-step sync
            host = loss.cpu()                 # explicit per-step copy
        return losses, host
    """)


def hot_loop_device_get() -> List[Finding]:
    """``loss.item()`` and ``loss.cpu()`` inside the epoch loop: one
    device->host round trip per iteration."""
    from .hostsync import scan_source
    return scan_source("fixture:hot_loop_device_get.py",
                       _HOT_LOOP_DEVICE_GET)


_LOCK_FREE_SHARED_ATTR = textwrap.dedent("""\
    import threading

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0                    # shared, never guarded
            self._thread = threading.Thread(target=self._run, daemon=True)

        def _run(self):
            while True:
                self.count += 1               # worker-side write, no lock

        def snapshot(self):
            return self.count                 # caller-side read, no lock
    """)


def lock_free_shared_attr() -> List[Finding]:
    """A counter mutated by the spawned thread and read by the caller
    with no lock and no annotation: the data-race shape the lockset lint
    exists to catch."""
    from .lockset import lint_source
    return lint_source("fixture:lock_free_shared_attr.py",
                       _LOCK_FREE_SHARED_ATTR)


_RANK_GATED_COLLECTIVE = textwrap.dedent("""\
    import torch.distributed as dist

    def flush_epoch(stats):
        if dist.get_rank() == 0:          # rank-local check
            dist.all_reduce(stats)
        return stats
    """)


def rank_gated_collective() -> List[Finding]:
    """An ``all_reduce`` only rank 0 reaches: the other ranks never enter
    the collective and the job hangs; the divergence lint's canonical
    finding."""
    from .divergence import scan_source
    return scan_source("fixture:rank_gated_collective.py",
                       _RANK_GATED_COLLECTIVE)


FIXTURES: Dict[str, Callable[[], List[Finding]]] = {
    "hot_loop_device_get": hot_loop_device_get,
    "lock_free_shared_attr": lock_free_shared_attr,
    "rank_gated_collective": rank_gated_collective,
}

# Every fixture a --strict run must fail on.
ERROR_FIXTURES = tuple(FIXTURES)

# JAX's jaxpr fixtures, each refused with the reason the port lacks it.
REFUSED: Dict[str, str] = {
    "wrong_axis_psum": "the collective audit of the program registry is "
                       "ROADMAP A13c.2",
    "model_axis_all_gather": "the collective audit of the program "
                             "registry is ROADMAP A13c.2",
    "budget_buster": "the cost model and its budgets are ROADMAP A13c.3",
    "captured_constant": "an eager program captures no constants into a "
                         "compiled executable: no counterpart (ROADMAP C5)",
    "missing_donation": "an eager program has no buffer donation: no "
                        "counterpart (ROADMAP C5)",
    "scalar_closure": "an eager program is not retraced per closed-over "
                      "value: no counterpart (ROADMAP C5)",
}


def fixture_names() -> List[str]:
    return list(FIXTURES)


def run_fixture(name: str) -> List[Finding]:
    if name in REFUSED:
        raise SystemExit(f"--fixture {name}: not ported; {REFUSED[name]}")
    if name not in FIXTURES:
        raise ValueError(f"unknown fixture {name!r}; "
                         f"have {fixture_names()}")
    return FIXTURES[name]()
