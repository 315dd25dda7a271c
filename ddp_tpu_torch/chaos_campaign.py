"""The chaos campaign (counterpart of ``tools/chaos_campaign.py``): the
``DDP_TPU_FAULT`` drill matrix run under the port's supervisor (``python -m
ddp_tpu_torch.supervise``), each drill scored on one question: did the run
finish with no data lost and no operator input?

    python -m ddp_tpu_torch.chaos_campaign [--out CHAOS.json]
        [--drills sigterm_step,...] [--device cuda|cpu] [--workdir DIR]
        [--keep] [--timeout 900]

Per drill the scorecard records the restarts the supervisor spent by
reason and its death-to-relaunch seconds (read back from its own
``.prom`` exposition), the wall time, final-state bit parity against an
undisturbed control run of the same config (weights, BatchNorm buffers,
momentum and step of the newest verifiable checkpoint), and the flight
recorder's bundle: every abnormal exit must leave a schema-valid
``postmortem.json`` in the drill's directory, or the drill fails even if
the data survived.

The matrix:
  sigterm_step     mid-epoch preemption -> exit 75 -> immediate resume
  watchdog_stall   wedged run -> watchdog exit 124 -> backoff resume
  flip_param_bit   a flipped bit on one replica -> drift abort (exit 1) ->
                   resume from the last clean checkpoint
  poison_batch     a corrupted batch -> guard spike abort (exit 1) ->
                   resume from the last clean checkpoint
  torn_data_state  preempt, then tear the checkpoint's resume record ->
                   the epoch-boundary resume, warned
  local_wipe       preempt with ``--mirror``, then remove the whole local
                   checkpoint directory -> resume from the mirror alone
  kill_stage       a pipelined run preempted mid-schedule, a whole stage
                   plane dead at relaunch (the probe sees fewer cards) ->
                   the supervisor's stage-first shrink collapses the
                   stage axis and the canonical checkpoint restores onto
                   the 2-D mesh bit for bit

Every child runs in deterministic mode, so that bit parity means something
on a card: ``python -m ddp_tpu_torch.repeat_check --child singlegpu
--deterministic -- <arguments>``, where the supervisor's appended
``--resume`` lands among the training arguments.  The configs are the JAX
campaign's in the port's form: the JAX campaign runs A and B at
``--mesh_shape 8,1`` over eight virtual CPU devices, and a ``(D, 1)`` mesh
is the port's data-parallel run of D ranks, so A and B run here without
``--mesh_shape`` at world 1 (one card holds one NCCL rank).  DeepNN at
lr 0.05, seed 3; A is 64 images in batches of 32 (2 steps an epoch, 3
epochs) at world 1; B is 320 images (10 steps an epoch) with
``save_every`` 2, so the guard has its 8-step history before the poisoned
step 12 and no checkpoint lands between the poison and the abort; C is A
at world 2 in batches of 16 a rank, since a drift needs two replicas: on
the CPU ``--spawn 2``, on a card two ranks over gloo on the one card
(NCCL refuses two ranks on one card), started by this module's
``--gloo_ranks 2``.  P is the JAX campaign's pipelined config, 32 images,
``--grad_accum 2``, 2 optimizer steps an epoch: on the CPU ``--mesh_shape
2,1,2`` in batches of 4 (``multigpu`` spawns the mesh's four gloo ranks),
its probe reporting 2 cards at relaunch, so (2,1,2) becomes (2,1,1); on a
card ``--mesh_shape 1,1,2`` in batches of 8 as gloo ranks on the one card
(this module's hidden ``--gloo_mesh``, which starts as many as the mesh
has), its probe reporting 1, so (1,1,2) becomes (1,1,1).  Exits nonzero
when any drill fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .resilience.supervisor import PROBE_ENV, _get_flag

SCHEMA = "chaos_campaign/1"

_COMMON = ["--model", "deepnn", "--lr", "0.05", "--synthetic", "--seed", "3"]
_CONFIGS = {
    "A": ["3", "1", "--batch_size", "32", "--synthetic_size", "64"],
    "B": ["3", "2", "--batch_size", "32", "--synthetic_size", "320"],
    "C": ["3", "1", "--batch_size", "16", "--synthetic_size", "64"],
    "P": ["3", "1", "--synthetic_size", "32", "--grad_accum", "2"],
}
# Config P's mesh, batch and the card count its drill's probe reports, by
# device.
_P_MESH = {"cpu": (["--batch_size", "4", "--mesh_shape", "2,1,2"], "2"),
           "cuda": (["--batch_size", "8", "--mesh_shape", "1,1,2"], "1")}
# name -> (config, DDP_TPU_FAULT spec, or None for a two-stage drill, extra
# training arguments); the faults and flags are the JAX campaign's.
_DRILLS = {
    "sigterm_step": ("A", "sigterm@step=2", []),
    "watchdog_stall": ("A", "stall@epoch=1,secs=600",
                       ["--watchdog_secs", "15"]),
    "flip_param_bit": ("C", "flip_param_bit@step=2,replica=1",
                       ["--drift_audit_every", "1",
                        "--drift_action", "abort"]),
    "poison_batch": ("B", "poison_batch@step=12,scale=1e4",
                     ["--guard_spike_factor", "4",
                      "--guard_action", "abort"]),
    "torn_data_state": ("A", None, []),
    "local_wipe": ("A", None, []),
    "kill_stage": ("P", "sigterm@step=2", []),
}
CI_DRILLS = "sigterm_step,watchdog_stall"


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    env = dict(os.environ)
    env.pop("DDP_TPU_FAULT", None)
    # The children import this package from wherever they start.
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # Deterministic mode's cuBLAS needs its workspace set before CUDA
    # starts.
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    return env


def _child_argv(config: str, extra: List[str], workdir: str, device: str,
                snapshot: Optional[str] = None) -> List[str]:
    """The training command of ``config`` (without the interpreter)."""
    args = (_CONFIGS[config] + _COMMON + extra
            + ["--snapshot_path", snapshot or os.path.join(workdir, "ck.pt"),
               "--metrics_path", os.path.join(workdir, "metrics.jsonl")])
    if config == "P":
        args += _P_MESH[device][0]
    if device == "cpu":
        args += ["--device", "cpu"]
    if config == "P":
        if device == "cpu":
            return ["-m", "ddp_tpu_torch.repeat_check", "--child",
                    "multigpu", "--deterministic", "--", *args]
        return ["-m", "ddp_tpu_torch.chaos_campaign", "--gloo_mesh", "--",
                *args]
    if config == "C":
        if device == "cpu":
            return ["-m", "ddp_tpu_torch.repeat_check", "--child",
                    "multigpu", "--deterministic", "--", *args, "--spawn",
                    "2"]
        return ["-m", "ddp_tpu_torch.chaos_campaign", "--gloo_ranks", "2",
                "--", *args]
    return ["-m", "ddp_tpu_torch.repeat_check", "--child", "singlegpu",
            "--deterministic", "--", *args]


def _run(argv: List[str], env: dict, timeout: float,
         tag: str) -> Tuple[int, float]:
    print(f"[chaos] {tag}: {' '.join(argv)}", flush=True)
    t0 = time.monotonic()
    proc = subprocess.run(argv, env=env, timeout=timeout)
    return proc.returncode, time.monotonic() - t0


def _supervised(child: List[str], env: dict, timeout: float, tag: str,
                fault: Optional[str] = None) -> Tuple[int, float]:
    env = dict(env)
    if fault:
        env["DDP_TPU_FAULT"] = fault
    argv = [sys.executable, "-m", "ddp_tpu_torch.supervise",
            "--backoff_base", "0.2", "--backoff_max", "5",
            "--seed", "0", "--"] + child
    return _run(argv, env, timeout, tag)


def final_state(snapshot: str):
    """The newest verifiable checkpoint of a finished run."""
    from .resilience.lineage import latest_verifiable
    loaded = latest_verifiable(snapshot)
    return None if loaded is None else loaded[0]


def same_state(a, b) -> bool:
    """Two checkpoints' step, weights, BatchNorm buffers and momentum, bit
    for bit."""
    if a is None or b is None or a.step != b.step:
        return False

    def flat(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            yield from (flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else [(prefix + k, np.asarray(v))])

    for section in ("params", "batch_stats", "momentum"):
        fa = list(flat(getattr(a, section)))
        fb = list(flat(getattr(b, section)))
        if [k for k, _ in fa] != [k for k, _ in fb] or not all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for (_, x), (_, y) in zip(fa, fb)):
            return False
    return True


def supervisor_stats(workdir: str) -> Dict[str, object]:
    """Restarts by reason and the recovery seconds, read back from the
    supervisor's end-of-run exposition."""
    from .obs.registry import parse_exposition
    prom = os.path.join(workdir, "metrics.jsonl.supervisor.prom")
    out: Dict[str, object] = {"restarts": 0, "restart_reasons": {},
                              "recovery_seconds_sum": 0.0}
    try:
        with open(prom) as f:
            fams = parse_exposition(f.read())
    except (OSError, ValueError):
        return out
    reasons: Dict[str, int] = {}
    fam = fams.get("ddp_supervisor_restarts_total")
    if fam:
        for (sname, labels), v in fam["samples"].items():
            if sname == "ddp_supervisor_restarts_total":
                reasons[dict(labels).get("reason", "?")] = int(v)
    out["restart_reasons"] = reasons
    out["restarts"] = sum(reasons.values())
    hist = fams.get("ddp_supervisor_recovery_seconds")
    if hist:
        for (sname, _labels), v in hist["samples"].items():
            if sname == "ddp_supervisor_recovery_seconds_sum":
                out["recovery_seconds_sum"] = round(float(v), 3)
    return out


def postmortem_check(workdir: str) -> dict:
    """The drill's flight-recorder bundle: present and schema-valid."""
    from .obs.blackbox import validate_postmortem
    path = os.path.join(workdir, "postmortem.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return {"present": os.path.exists(path), "valid": False,
                "error": str(e)}
    try:
        validate_postmortem(doc)
    except ValueError as e:
        return {"present": True, "valid": False, "error": str(e)}
    return {"present": True, "valid": True, "reason": doc["reason"],
            "exit_status": doc["exit_status"]}


def _run_control(config: str, root: str, env: dict, device: str,
                 timeout: float) -> dict:
    workdir = os.path.join(root, f"control_{config}")
    os.makedirs(workdir, exist_ok=True)
    child = [sys.executable] + _child_argv(config, [], workdir, device)
    rc, wall = _run(child, env, timeout, f"control {config}")
    if rc != 0:
        raise RuntimeError(f"control {config} failed with exit {rc}: the "
                           "campaign has no baseline to score against")
    return {"config": config, "workdir": workdir, "wall_s": round(wall, 1)}


def _run_torn(root: str, env: dict, device: str, timeout: float) -> dict:
    """A run preempted at the epoch boundary, its checkpoint's resume
    record then torn on disk, then the supervised ``--resume``: it must
    fall back to the epoch boundary, warned, and finish."""
    from .resilience import faults
    from .resilience.lineage import _resolve_head
    workdir = os.path.join(root, "torn_data_state")
    os.makedirs(workdir, exist_ok=True)
    child = _child_argv("A", [], workdir, device)
    rc, wall1 = _run([sys.executable] + child,
                     dict(env, DDP_TPU_FAULT="sigterm@epoch=1"), timeout,
                     "torn_data_state stage 1 (preempt)")
    if rc != 75:
        return {"workdir": workdir, "supervisor_exit": rc,
                "error": f"stage-1 preemption exited {rc}, wanted 75"}
    faults.torn_data_state(_resolve_head(os.path.join(workdir, "ck.pt")))
    rc, wall2 = _supervised(child + ["--resume"], env, timeout,
                            "torn_data_state stage 2 (resume)")
    return {"workdir": workdir, "supervisor_exit": rc,
            "wall_s": round(wall1 + wall2, 1)}


def _run_local_wipe(root: str, env: dict, device: str,
                    timeout: float) -> dict:
    """Total local-disk loss: a mirrored run preempted mid-epoch (its
    upload drained before exit 75), its whole checkpoint directory
    removed, then the supervised ``--resume`` must restore from the mirror
    alone.  The checkpoint lives in a directory of its own, so the wipe
    spares the metrics and scrape files the scorecard reads."""
    workdir = os.path.join(root, "local_wipe")
    ckdir = os.path.join(workdir, "ckpt")
    os.makedirs(ckdir, exist_ok=True)
    snapshot = os.path.join(ckdir, "ck.pt")
    mirror = os.path.join(workdir, "mirror")
    child = _child_argv("A", ["--mirror", mirror], workdir, device,
                        snapshot=snapshot)
    fault = "sigterm@step=4 + rm -rf local ckpt dir"
    rc, wall1 = _run([sys.executable] + child,
                     dict(env, DDP_TPU_FAULT="sigterm@step=4"), timeout,
                     "local_wipe stage 1 (preempt, mirror draining)")
    if rc != 75:
        return {"workdir": workdir, "supervisor_exit": rc,
                "snapshot": snapshot, "fault": fault,
                "error": f"stage-1 preemption exited {rc}, wanted 75"}
    shutil.rmtree(ckdir)
    print(f"[chaos] local_wipe: removed {ckdir} (local tier gone; mirror "
          f"at {mirror} is the only copy)", flush=True)
    rc, wall2 = _supervised(child + ["--resume"], env, timeout,
                            "local_wipe stage 2 (resume from mirror)")
    return {"workdir": workdir, "supervisor_exit": rc, "snapshot": snapshot,
            "fault": fault, "wall_s": round(wall1 + wall2, 1)}


def _run_kill_stage(root: str, env: dict, device: str,
                    timeout: float) -> dict:
    """Stage loss: the pipelined config P is SIGTERMed mid-schedule (exit
    75, emergency checkpoint on disk), and at the relaunch the
    supervisor's probe reports one (data, model) plane of cards only: the
    stage-first shrink must give the stage axis up (S -> 1) rather than
    the data axis, and the canonical checkpoint must restore onto the
    collapsed mesh and finish bit for bit the undisturbed pipelined
    control (``tools/chaos_campaign.py:311-331``)."""
    workdir = os.path.join(root, "kill_stage")
    os.makedirs(workdir, exist_ok=True)
    child = _child_argv("P", [], workdir, device)
    # The probe seam: the supervisor believes one stage plane survived.
    drill_env = dict(env)
    drill_env[PROBE_ENV] = _P_MESH[device][1]
    rc, wall = _supervised(child, drill_env, timeout, "kill_stage",
                           fault="sigterm@step=2")
    return {"workdir": workdir, "supervisor_exit": rc,
            "fault": "sigterm@step=2 + stage plane dead at relaunch",
            "wall_s": round(wall, 1)}


def run_campaign(drills: List[str], root: str, env: dict, device: str,
                 timeout: float) -> dict:
    configs = sorted({_DRILLS[d][0] for d in drills})
    controls = {c: _run_control(c, root, env, device, timeout)
                for c in configs}
    results: Dict[str, dict] = {}
    for name in drills:
        config, fault, extra = _DRILLS[name]
        if name == "torn_data_state":
            res = _run_torn(root, env, device, timeout)
        elif name == "local_wipe":
            res = _run_local_wipe(root, env, device, timeout)
        elif name == "kill_stage":
            res = _run_kill_stage(root, env, device, timeout)
        else:
            workdir = os.path.join(root, name)
            os.makedirs(workdir, exist_ok=True)
            child = _child_argv(config, extra, workdir, device)
            rc, wall = _supervised(child, env, timeout, name, fault=fault)
            res = {"workdir": workdir, "supervisor_exit": rc,
                   "wall_s": round(wall, 1)}
        res.setdefault(
            "fault", fault or "sigterm@epoch=1 + torn data_state record")
        res["control"] = config
        res.update(supervisor_stats(res["workdir"]))
        snap = res.pop("snapshot", None) or os.path.join(res["workdir"],
                                                         "ck.pt")
        bit = same_state(final_state(snap), final_state(
            os.path.join(controls[config]["workdir"], "ck.pt")))
        res["bit_identical"] = bit
        res["zero_data_loss"] = bit and res["supervisor_exit"] == 0
        # Every drill kills a child abnormally at least once, so a valid
        # bundle must be in the workdir (the last death's survives the
        # relaunch that completes).
        res["postmortem"] = postmortem_check(res["workdir"])
        res["pass"] = res["zero_data_loss"] and res["postmortem"]["valid"]
        res.pop("workdir")
        results[name] = res
        print(f"[chaos] {name}: exit={res['supervisor_exit']} "
              f"restarts={res['restarts']} {res['restart_reasons']} "
              f"recover={res['recovery_seconds_sum']}s "
              f"bit_identical={bit} "
              f"postmortem={res['postmortem'].get('reason', 'MISSING')}"
              f" -> {'PASS' if res['pass'] else 'FAIL'}", flush=True)
    for c in controls.values():
        c.pop("workdir")
    ok = all(r["pass"] for r in results.values())
    return {"schema": SCHEMA,
            "generated_by": "python -m ddp_tpu_torch.chaos_campaign",
            "device": device, "controls": controls, "drills": results,
            "verdict": "PASS" if ok else "FAIL"}


def _gloo_rank(argv: List[str]) -> None:
    """One rank of config C or P on a card: deterministic mode (as
    ``repeat_check``'s children), gloo."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    from . import cli
    cli.main_multi(argv, backend="gloo")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    split = argv.index("--") if "--" in argv else len(argv)
    own, rest = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.chaos_campaign",
        description=__doc__.splitlines()[0])
    p.add_argument("--out", default="CHAOS.json",
                   help="Scorecard path (default CHAOS.json)")
    p.add_argument("--drills", default=",".join(_DRILLS),
                   help="Comma-separated subset of the matrix (default: "
                        "all of " + ",".join(_DRILLS) + "; CI runs "
                        + CI_DRILLS + ")")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, for every child")
    p.add_argument("--workdir", default=None,
                   help="Working directory (default: a fresh tempdir)")
    p.add_argument("--keep", action="store_true",
                   help="Keep the working directory (debugging)")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="Per-subprocess timeout in seconds (default 900)")
    p.add_argument("--gloo_ranks", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--gloo_mesh", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--gloo_rank", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(own)
    if args.gloo_rank:
        _gloo_rank(rest)
        return 0
    if args.gloo_ranks or args.gloo_mesh:
        # --gloo_mesh: as many ranks as the child's --mesh_shape, which
        # the supervisor rewrites at a relaunch.
        from .parallel import dist
        n = args.gloo_ranks or int(np.prod([
            int(v) for v in _get_flag(rest, "--mesh_shape").split(",")]))
        return dist.launch_local(
            [sys.executable, "-m", "ddp_tpu_torch.chaos_campaign",
             "--gloo_rank", "--", *rest], n, same_device=True)
    drills = [d.strip() for d in args.drills.split(",") if d.strip()]
    unknown = [d for d in drills if d not in _DRILLS]
    if unknown:
        p.error(f"unknown drill(s) {unknown}; matrix: " + ",".join(_DRILLS))
    if args.device not in ("cuda", "cpu"):
        p.error(f"--device must be cuda or cpu, not {args.device!r}")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            p.error("--device cuda: torch sees no CUDA card (pass --device "
                    "cpu to run the campaign on the CPU)")
    root = args.workdir or tempfile.mkdtemp(prefix="chaos_campaign_")
    os.makedirs(root, exist_ok=True)
    try:
        card = run_campaign(drills, root, _env(), args.device, args.timeout)
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(card, f, indent=1)
    print(f"[chaos] scorecard written to {args.out}: {card['verdict']}",
          flush=True)
    return 0 if card["verdict"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
