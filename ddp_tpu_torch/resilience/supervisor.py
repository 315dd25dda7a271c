"""Run supervisor: the restart wrapper the exit-status contract was written
for (counterpart of ``ddp_tpu/resilience/supervisor.py``; the CLI's exit 75
is "the restart wrapper's cue").

``python -m ddp_tpu_torch.supervise -- -m ddp_tpu_torch.multigpu 10 1
--snapshot_path ...`` launches the training run as a child process and
closes the recovery loop:

- exit 75 (preempted): the emergency checkpoint is on disk; relaunch at
  once with ``--resume``, no backoff (the scheduler's doing, not the
  run's).
- exit 124 (watchdog): the run stalled; relaunch with ``--resume`` under
  exponential backoff with jitter.
- any other nonzero exit: a crash; relaunch under the same backoff while
  the failure ledger calls the death transient.

Relaunches manage the topology flags: before each, the live card count
is probed in a throwaway interpreter (``torch.cuda.device_count()``; the
wrapper never initialises CUDA itself, which would hold the cards the
child needs).  A ``--mesh_shape`` child is relaunched on
:func:`shrink_mesh` of the full mesh (parsed once from the original
command) and the probe: the stage axis gives way first, then the data
axis, and the canonical checkpoint restores onto whatever survives; a
``--num_devices`` child's world is the smaller of the two.

The failure ledger tails the child's metrics JSONL between launches and
keeps, per death, the exit code, the mesh or world it ran at, the last guard or
drift event, the failure signature and the flight recorder's
``postmortem.json`` (``obs/blackbox.py``).  The same ``drift_detected`` or
``spike_*``/``nonfinite_*`` event at the same global step twice is a
poisoned step that kills every attempt alike: the supervisor stops and
writes ``diagnosis.json``.

Exit codes (continuing the child's):
  0    the child completed (possibly after restarts)
  86   restart budget exhausted: the ledger printed, the newest verifiable
       checkpoint still on disk for a manual relaunch
  87   deterministic failure diagnosed (the same failure signature at the
       same step twice)

Every name, message, metric and file is the JAX package's, and the child's
environment gets :data:`SUPERVISED_ENV` (the CLI's preemption line then
says the supervisor relaunches) and, for tests, the probe reads
:data:`PROBE_ENV` instead of starting an interpreter.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

SUPERVISOR_BUDGET_EXIT_STATUS = 86
SUPERVISOR_DETERMINISTIC_EXIT_STATUS = 87

# Test seam: when set, the device probe trusts this count instead of
# starting an interpreter that imports torch.
PROBE_ENV = "DDP_TPU_SUPERVISE_DEVICES"

# Set in every child's environment so cli.py's preemption message can say
# "the supervisor relaunches automatically" instead of telling a human to
# type --resume.
SUPERVISED_ENV = "DDP_TPU_SUPERVISED"


# -- pure helpers (unit-tested directly) -----------------------------------


def classify_exit(returncode: int) -> str:
    """``preempted`` (75) / ``stalled`` (124) / ``crash`` (anything else
    nonzero, including signal deaths reported as negative returncodes)."""
    from .preemption import EMERGENCY_CHECKPOINT_EXIT_STATUS
    from .watchdog import WATCHDOG_EXIT_STATUS
    if returncode == EMERGENCY_CHECKPOINT_EXIT_STATUS:
        return "preempted"
    if returncode == WATCHDOG_EXIT_STATUS:
        return "stalled"
    return "crash"


def backoff_delay(restart_no: int, *, base: float, cap: float,
                  jitter: float, rng: random.Random) -> float:
    """``min(base * 2**restart_no, cap)`` spread by ``±jitter`` (fractional)
    — the standard decorrelation so a rack of supervisors whose children
    died together does not relaunch them together."""
    nominal = min(base * (2.0 ** restart_no), cap)
    spread = 1.0 + jitter * (2.0 * rng.random() - 1.0)
    return max(0.0, nominal * spread)


def shrink_mesh(full: Tuple[int, ...], ndev: int) -> Tuple[int, ...]:
    """The largest surviving mesh under ``full`` that fits on ``ndev``
    devices; same arity out as in.

    2-D ``(D, M)``: the model axis is load-bearing (the checkpoint's
    layer shards assume M-way TP unless resharded), so shrink the DATA
    axis first and only split M when even one M-wide replica no longer
    fits — then the largest divisor of M that does.

    3-D ``(D, M, S)``: the STAGE axis shrinks first — losing a host
    kills a whole stage plane, the canonical checkpoint restores onto
    any stage count, and the partitioner simply re-cuts the model into
    the surviving ``s'`` stages at relaunch (``s'=1`` collapses to the
    plain 2-D mesh), so stages are the cheapest axis to give up.  Only
    when not even one (D, M) plane survives does the 2-D policy above
    take over (with s=1)."""
    dims = tuple(int(v) for v in full)
    ndev = max(1, int(ndev))
    if len(dims) == 3:
        d, m, s = dims
        if d * m * s <= ndev:
            return (d, m, s)
        if d * m <= ndev:
            return (d, m, max(1, ndev // (d * m)))
        d2, m2 = shrink_mesh((d, m), ndev)
        return (d2, m2, 1)
    d, m = dims
    if d * m <= ndev:
        return (d, m)
    if m <= ndev:
        return (max(1, ndev // m), m)
    # Not even one full model replica fits: largest divisor of M <= ndev.
    for cand in range(ndev, 0, -1):
        if m % cand == 0:
            return (1, cand)
    return (1, 1)


def _get_flag(argv: Sequence[str], name: str) -> Optional[str]:
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return None


def _set_flag(argv: Sequence[str], name: str, value: str) -> List[str]:
    out = list(argv)
    for i, a in enumerate(out):
        if a == name and i + 1 < len(out):
            out[i + 1] = value
            return out
        if a.startswith(name + "="):
            out[i] = f"{name}={value}"
            return out
    out.extend([name, value])
    return out


def _ensure_resume(argv: Sequence[str]) -> List[str]:
    out = list(argv)
    if "--resume" not in out:
        out.append("--resume")
    return out


# -- failure ledger --------------------------------------------------------


def _iter_new_events(path: Optional[str], offset: int):
    """Parse the ``event`` records appended to the metrics JSONL since
    ``offset``; returns ``(events, new_offset)``.  Only complete lines are
    consumed — a torn trailing line is left for the next read."""
    if not path:
        return [], offset
    try:
        size = os.path.getsize(path)
    except OSError:
        return [], offset
    if size < offset:  # replaced/truncated by a fresh run
        offset = 0
    events = []
    try:
        with open(path, "r") as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return [], offset
    end = chunk.rfind("\n")
    if end < 0:
        return [], offset
    for line in chunk[:end].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "event" in rec:
            events.append(rec)
    return events, offset + end + 1


def _failure_signature(events) -> Optional[Tuple[str, int]]:
    """The deterministic-failure fingerprint of one death: the LAST
    drift/guard anomaly event, keyed ``(what, step)``.  ``None`` when the
    death left no such event (nothing to match a recurrence against)."""
    for rec in reversed(events):
        kind = rec.get("event")
        if kind == "drift_detected" and "step" in rec:
            return ("drift_detected", int(rec["step"]))
        if kind == "guard_decision" and "step" in rec:
            decision = str(rec.get("decision", ""))
            if decision.startswith(("spike_", "nonfinite_")):
                return (decision, int(rec["step"]))
    return None


class FailureLedger:
    """Per-death forensic record: exit code, classified reason, the mesh
    the attempt ran at (``mesh``: its ``--mesh_shape``, else its
    ``--num_devices``), the metrics
    events it appended, and the failure signature, on which the
    transient-vs-deterministic call is made.  Printed whenever the
    supervisor gives up."""

    def __init__(self, metrics_path: Optional[str] = None):
        self.metrics_path = metrics_path
        self.deaths: List[dict] = []
        self._offset = 0
        self._sig_counts: dict = {}
        # Flight-recorder linkage: the child dumps postmortem.json next
        # to the metrics JSONL on every abnormal exit (obs/blackbox.py).
        # Remember the bundle's identity at construction so a stale file
        # left by a PREVIOUS run is never attributed to this run's first
        # death — only a bundle that changed since last look counts.
        self._pm_seen = self._postmortem_stat()

    def _postmortem_path(self) -> Optional[str]:
        if not self.metrics_path:
            return None
        from ..obs.blackbox import POSTMORTEM_BASENAME  # stdlib-only
        return os.path.join(
            os.path.dirname(os.path.abspath(self.metrics_path)),
            POSTMORTEM_BASENAME)

    def _postmortem_stat(self) -> Optional[Tuple[float, int]]:
        path = self._postmortem_path()
        if not path:
            return None
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_mtime, st.st_size)

    def _link_postmortem(self) -> Optional[dict]:
        """The just-dead child's flight-recorder bundle, schema-checked —
        or ``None`` when there is no FRESH bundle (a SIGKILLed child
        cannot dump; an unchanged file belongs to an earlier death)."""
        stat = self._postmortem_stat()
        if stat is None or stat == self._pm_seen:
            return None
        self._pm_seen = stat
        path = self._postmortem_path()
        from ..obs.blackbox import validate_postmortem  # stdlib-only
        try:
            with open(path) as f:  # type: ignore[arg-type]
                doc = json.load(f)
            validate_postmortem(doc)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            return {"path": path, "valid": False, "error": str(e)}
        return {"path": path, "valid": True, "reason": doc["reason"],
                "exit_status": doc["exit_status"]}

    def record_death(self, *, exit_code: int, reason: str,
                     mesh: Optional[str], wall_s: float) -> dict:
        events, self._offset = _iter_new_events(self.metrics_path,
                                                self._offset)
        sig = _failure_signature(events)
        count = 0
        if sig is not None:
            count = self._sig_counts.get(sig, 0) + 1
            self._sig_counts[sig] = count
        entry = {
            "death": len(self.deaths) + 1,
            "exit_code": int(exit_code),
            "reason": reason,
            "mesh": mesh,
            "wall_s": round(float(wall_s), 3),
            "events": len(events),
            "last_event": events[-1] if events else None,
            "signature": sig,
            "signature_count": count,
            "postmortem": self._link_postmortem(),
        }
        self.deaths.append(entry)
        return entry

    @staticmethod
    def is_deterministic(entry: dict) -> bool:
        """A crash whose signature has now been seen twice — spec'd as
        exactly-2 so one recurrence is enough and budget stops burning."""
        return (entry["reason"] == "crash"
                and entry["signature"] is not None
                and entry["signature_count"] >= 2)

    def format(self) -> str:
        lines = ["failure ledger "
                 f"({self.metrics_path or 'no metrics stream'}):"]
        if not self.deaths:
            lines.append("  (no deaths recorded)")
        for d in self.deaths:
            last = d["last_event"]
            last_txt = "-"
            if last is not None:
                step = last.get("step")
                last_txt = str(last.get("event"))
                if last.get("decision"):
                    last_txt += f":{last['decision']}"
                if step is not None:
                    last_txt += f"@step={step}"
            sig_txt = "-"
            if d["signature"] is not None:
                sig_txt = (f"{d['signature'][0]}@step={d['signature'][1]} "
                           f"(x{d['signature_count']})")
            pm = d.get("postmortem")
            pm_txt = "-"
            if pm is not None:
                pm_txt = (pm["reason"] if pm.get("valid")
                          else f"INVALID({pm.get('error', '?')})")
            lines.append(
                f"  death {d['death']}: exit {d['exit_code']} "
                f"({d['reason']}) mesh={d['mesh'] or '-'} "
                f"wall={d['wall_s']:.1f}s last_event={last_txt} "
                f"signature={sig_txt} postmortem={pm_txt}")
        return "\n".join(lines)


# -- device probe ----------------------------------------------------------


def probe_device_count(env: Optional[dict] = None,
                       timeout: float = 120.0) -> Optional[int]:
    """The live card count, from :data:`PROBE_ENV` when set (tests) or a
    throwaway interpreter otherwise (the supervisor itself must not
    initialise CUDA: a context in the wrapper would hold the very cards the
    child needs).  ``None`` when the probe fails: the caller keeps the full
    world and lets the child's own device check report the shortage."""
    env = dict(env if env is not None else os.environ)
    override = env.get(PROBE_ENV)
    if override:
        try:
            return max(1, int(override))
        except ValueError:
            return None
    try:
        out = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.cuda.device_count())"],
            env=env, capture_output=True, text=True, timeout=timeout)
        return int(out.stdout.strip().splitlines()[-1])
    except (subprocess.SubprocessError, OSError, ValueError, IndexError):
        return None


# -- the supervisor --------------------------------------------------------


def _default_launcher(argv: Sequence[str], env: dict) -> int:
    return subprocess.call(list(argv), env=env)


class Supervisor:
    """Launch ``child_argv``, classify its deaths, and relaunch with
    ``--resume`` under a bounded budget.  Every collaborator with a side
    effect (process launch, device probe, sleep, clock) is injectable so
    the edge-case tests run in milliseconds without subprocesses."""

    def __init__(self, child_argv: Sequence[str], *,
                 max_restarts: int = 5,
                 backoff_base: float = 1.0,
                 backoff_max: float = 60.0,
                 jitter: float = 0.25,
                 seed: Optional[int] = None,
                 keep_fault_env: bool = False,
                 prom_path: Optional[str] = None,
                 env: Optional[dict] = None,
                 launcher: Optional[Callable] = None,
                 device_probe: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.child_argv = list(child_argv)
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.keep_fault_env = bool(keep_fault_env)
        self._rng = random.Random(seed)
        self._base_env = dict(env if env is not None else os.environ)
        self._launcher = launcher or _default_launcher
        self._device_probe = device_probe or probe_device_count
        self._sleep = sleep
        self._clock = clock
        # Full-mesh topology to grow back to, parsed once from the ORIGINAL
        # argv (later relaunches rewrite the flags in place).
        mesh = _get_flag(self.child_argv, "--mesh_shape")
        self._full_mesh: Optional[Tuple[int, ...]] = None
        if mesh:
            try:
                dims = tuple(int(x) for x in mesh.split(","))
                if len(dims) in (2, 3):
                    self._full_mesh = dims
            except ValueError:
                pass
        ndev = _get_flag(self.child_argv, "--num_devices")
        self._full_num_devices = (int(ndev)
                                  if ndev and ndev.isdigit() else None)
        metrics_path = _get_flag(self.child_argv, "--metrics_path")
        self.ledger = FailureLedger(metrics_path)
        self.prom_path = prom_path or (
            metrics_path + ".supervisor.prom" if metrics_path else None)
        if registry is None:
            from ..obs.registry import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        from ..obs.registry import SECONDS_BUCKETS
        self._restarts_total = registry.counter(
            "ddp_supervisor_restarts_total",
            "Child relaunches by classified death reason", ("reason",))
        self._recovery_seconds = registry.histogram(
            "ddp_supervisor_recovery_seconds",
            "Child death to relaunch, seconds (backoff + probe included)",
            buckets=SECONDS_BUCKETS)
        self.restarts_used = 0

    # -- per-launch plumbing ----------------------------------------------

    def _child_env(self, first_launch: bool) -> dict:
        env = dict(self._base_env)
        env[SUPERVISED_ENV] = "1"
        if not first_launch and not self.keep_fault_env:
            # A step/epoch-triggered DDP_TPU_FAULT would re-fire on the
            # resumed run (the injectors count from the RESUMED host step,
            # already past the trigger) and preempt it forever — injected
            # faults are one drill each unless the campaign says otherwise.
            env.pop("DDP_TPU_FAULT", None)
        return env

    def _relaunch_argv(self, argv: Sequence[str]) -> List[str]:
        argv = _ensure_resume(argv)
        if self._full_mesh is None and self._full_num_devices is None:
            return argv  # no topology flags to manage
        ndev = self._device_probe(self._child_env(first_launch=False))
        if self._full_mesh is not None:
            full_n = 1
            for v in self._full_mesh:
                full_n *= v
            new = shrink_mesh(self._full_mesh,
                              full_n if ndev is None else ndev)
            if new != self._full_mesh:
                note = ""
                if len(new) == 3 and new[2] != self._full_mesh[2]:
                    note = (f" (stage plane lost: the partitioner re-cuts "
                            f"{self._full_mesh[2]} -> {new[2]} stage(s) "
                            f"from the canonical checkpoint)")
                print(f"[supervise] {ndev} device(s) live: shrinking mesh "
                      f"{','.join(map(str, self._full_mesh))} -> "
                      f"{','.join(map(str, new))} for this relaunch{note}",
                      file=sys.stderr)
            argv = _set_flag(argv, "--mesh_shape",
                             ",".join(map(str, new)))
        else:
            want = self._full_num_devices
            n = want if ndev is None else min(want, ndev)
            argv = _set_flag(argv, "--num_devices", str(max(1, n)))
        return argv

    def _write_prom(self) -> None:
        if not self.prom_path:
            return
        try:
            with open(self.prom_path, "w") as f:
                f.write(self.registry.exposition())
        except OSError as e:
            print(f"[supervise] WARNING: cannot write scrape file "
                  f"{self.prom_path!r}: {e}", file=sys.stderr)

    def _write_diagnosis(self, entry: dict) -> Optional[str]:
        """Exit-87 repro artifact: ``diagnosis.json`` next to the ledger's
        metrics stream.  A DETERMINISTIC verdict means a specific step
        poisons the run every time — this file pins everything needed to
        reproduce it after the fact: the failure signature (what + step +
        occurrences), the checkpoint the relaunches restored from (head
        ref incl. ``data_state`` and mirror status), the mirror URI, and
        the last guard/drift event of every death."""
        base = (os.path.dirname(os.path.abspath(self.ledger.metrics_path))
                if self.ledger.metrics_path else os.getcwd())
        path = os.path.join(base, "diagnosis.json")
        sig = entry.get("signature") or (None, None)
        snapshot = _get_flag(self.child_argv, "--snapshot_path")
        ckpt: Optional[dict] = None
        if snapshot:
            head = None
            try:
                from .lineage import read_manifest
                m = read_manifest(snapshot)
                if m is not None and isinstance(m.get("head"), dict):
                    head = m["head"]
            except Exception:  # noqa: BLE001 — forensics must not crash
                head = None
            ckpt = {"path": snapshot, "head": head}
        doc = {
            "schema": "supervisor_diagnosis/1",
            "verdict": "deterministic",
            "signature": {"what": sig[0], "step": sig[1],
                          "occurrences": entry.get("signature_count", 0)},
            "exit_code": entry.get("exit_code"),
            "mesh": entry.get("mesh"),
            "checkpoint": ckpt,
            "mirror": _get_flag(self.child_argv, "--mirror"),
            # The dying attempt's flight-recorder bundle (fresh-file
            # check in FailureLedger._link_postmortem).
            "postmortem": entry.get("postmortem"),
            "last_events": [d.get("last_event")
                            for d in self.ledger.deaths],
            "deaths": self.ledger.deaths,
            "child_argv": list(self.child_argv),
        }
        try:
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            print(f"[supervise] WARNING: cannot write diagnosis "
                  f"artifact {path!r}: {e}", file=sys.stderr)
            return None
        print(f"[supervise] diagnosis artifact written to {path}",
              file=sys.stderr)
        return path

    # -- the loop ----------------------------------------------------------

    def run(self) -> int:
        argv = list(self.child_argv)
        first = True
        backoff_no = 0  # escalates on stall/crash only, never preemption
        while True:
            mesh = (_get_flag(argv, "--mesh_shape")
                    or _get_flag(argv, "--num_devices"))
            print(f"[supervise] launching (attempt "
                  f"{self.restarts_used + 1}/"
                  f"{self.max_restarts + 1}): {' '.join(argv)}",
                  file=sys.stderr)
            sys.stderr.flush()
            t0 = self._clock()
            rc = self._launcher(argv, self._child_env(first))
            wall = self._clock() - t0
            if rc == 0:
                print(f"[supervise] child completed after "
                      f"{self.restarts_used} restart(s)", file=sys.stderr)
                self._write_prom()
                return 0
            reason = classify_exit(rc)
            entry = self.ledger.record_death(
                exit_code=rc, reason=reason, mesh=mesh, wall_s=wall)
            print(f"[supervise] child died: exit {rc} ({reason})",
                  file=sys.stderr)
            if FailureLedger.is_deterministic(entry):
                sig = entry["signature"]
                print(f"[supervise] DETERMINISTIC failure: "
                      f"{sig[0]} at step {sig[1]} recurred "
                      f"({entry['signature_count']} occurrences) — a "
                      "poisoned step, not bad luck; refusing to burn the "
                      "remaining restart budget", file=sys.stderr)
                print(self.ledger.format(), file=sys.stderr)
                self._write_diagnosis(entry)
                self._write_prom()
                return SUPERVISOR_DETERMINISTIC_EXIT_STATUS
            if self.restarts_used >= self.max_restarts:
                print(f"[supervise] restart budget exhausted "
                      f"({self.max_restarts} restart(s) used); giving up — "
                      "the newest verifiable checkpoint is still on disk "
                      "for a manual relaunch", file=sys.stderr)
                print(self.ledger.format(), file=sys.stderr)
                self._write_prom()
                return SUPERVISOR_BUDGET_EXIT_STATUS
            t_dead = self._clock()
            if reason == "preempted":
                delay = 0.0  # checkpoint already on disk; relaunch now
            else:
                delay = backoff_delay(backoff_no, base=self.backoff_base,
                                      cap=self.backoff_max,
                                      jitter=self.jitter, rng=self._rng)
                backoff_no += 1
            if delay > 0:
                print(f"[supervise] backing off {delay:.2f}s before "
                      "relaunch", file=sys.stderr)
                self._sleep(delay)
            argv = self._relaunch_argv(argv)
            self.restarts_used += 1
            self._restarts_total.labels(reason=reason).inc()
            # Death-to-relaunch recovery time: the wall clock covers the
            # backoff sleep and the device probe; under an injected
            # (instant) sleep the clock never moves, so the nominal delay
            # is the floor.
            self._recovery_seconds.observe(
                max(delay, self._clock() - t_dead))
            first = False


# -- CLI -------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.supervise",
        description="Restart wrapper for ddp_tpu_torch training runs: "
                    "relaunch with --resume on preemption (75) / stall "
                    "(124) / transient crash, under a bounded backoff "
                    "budget, with elastic mesh shrink-and-grow-back.",
        epilog="Everything after `--` is the child command; a leading "
               "*.py token is run under this interpreter.")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="Restart budget (default 5); exhaustion exits "
                        f"{SUPERVISOR_BUDGET_EXIT_STATUS}")
    p.add_argument("--backoff_base", type=float, default=1.0,
                   help="First stall/crash backoff in seconds (default 1); "
                        "doubles per restart. Preemption never backs off.")
    p.add_argument("--backoff_max", type=float, default=60.0,
                   help="Backoff cap in seconds (default 60)")
    p.add_argument("--jitter", type=float, default=0.25,
                   help="Fractional backoff jitter (default 0.25)")
    p.add_argument("--seed", type=int, default=None,
                   help="Jitter RNG seed (reproducible drills)")
    p.add_argument("--prom", default=None, metavar="PATH",
                   help="Supervisor metrics scrape file (default: "
                        "<child --metrics_path>.supervisor.prom)")
    p.add_argument("--keep_fault_env", action="store_true",
                   help="Keep DDP_TPU_FAULT in relaunch environments "
                        "(default: stripped after the first launch so a "
                        "step-triggered fault is one drill, not a loop)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, child = argv[:split], argv[split + 1:]
    else:
        own, child = argv, []
    args = build_parser().parse_args(own)
    if not child:
        print("usage: python -m ddp_tpu_torch.supervise [options] -- "
              "<child command>", file=sys.stderr)
        return 2
    if child[0].endswith(".py") or child[0] == "-m":
        child = [sys.executable] + child
    sup = Supervisor(child, max_restarts=args.max_restarts,
                     backoff_base=args.backoff_base,
                     backoff_max=args.backoff_max, jitter=args.jitter,
                     seed=args.seed, prom_path=args.prom,
                     keep_fault_env=args.keep_fault_env)
    return sup.run()


if __name__ == "__main__":
    raise SystemExit(main())
