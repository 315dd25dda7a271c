"""Repeat the port's main path and compare the runs' loss histories bit for
bit: is one seed's run deterministic on this device?

    python -m ddp_tpu_torch.repeat_check [--entries singlegpu,singlegpu] \\
        [--deterministic] -- <training arguments>

Each entry (``singlegpu``, or ``multigpu`` as rank 0 of a world-1 process
group: NCCL on the card, gloo on the CPU) runs in a process of its own with
the training arguments and ``--result_json``.  ``--deterministic`` runs
each with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in its environment and, in
the process, ``torch.backends.cudnn.deterministic = True``, cuDNN's
benchmark off and ``torch.use_deterministic_algorithms(True)``, which
raises where an operation has no deterministic implementation.  The mode
stays in those processes.  Prints, for each run after the first, whether
its history equals the first's bit for bit and the largest difference,
and one JSON summary line last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

import torch

from .parallel.dist import free_port

ENTRIES = ("singlegpu", "multigpu")


def _child(entry: str, deterministic: bool, argv: List[str]) -> None:
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
    from . import cli
    (cli.main if entry == "singlegpu" else cli.main_multi)(argv)


def run_entries(entries: Sequence[str], train_args: Sequence[str], *,
                deterministic: bool = False, timeout: float = 600.0,
                snapshot_path: Optional[str] = None) -> List[Dict]:
    """Run each entry once, one process each, and return their
    ``--result_json`` summaries in order.  Each run checkpoints to a file
    of its own, or to ``snapshot_path`` when given (a run with
    ``--resume`` then continues the one before it).  Raises RuntimeError
    if one fails."""
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, entry in enumerate(entries):
            if entry not in ENTRIES:
                raise ValueError(f"unknown entry {entry!r}: {ENTRIES}")
            path = os.path.join(tmp, f"run{k}.json")
            env = dict(os.environ)
            if deterministic:
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            if entry == "multigpu":
                env.update(MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(free_port()), RANK="0",
                           WORLD_SIZE="1", LOCAL_RANK="0")
            cmd = [sys.executable, "-m", "ddp_tpu_torch.repeat_check",
                   "--child", entry] + \
                (["--deterministic"] if deterministic else []) + \
                ["--", *train_args, "--snapshot_path",
                 snapshot_path or os.path.join(tmp, f"run{k}.pt"),
                 "--result_json", path]
            r = subprocess.run(cmd, env=env, timeout=timeout)
            if r.returncode != 0:
                raise RuntimeError(f"repeat_check: run {k} ({entry}) exited "
                                   f"with {r.returncode}")
            with open(path) as f:
                results.append(json.load(f))
    return results


def compare(results: Sequence[Dict]) -> List[Dict]:
    """Each run after the first against the first: bit-equal histories,
    the largest absolute difference, and both accuracies."""
    first = results[0]["loss_history"]
    out = []
    for res in results[1:]:
        hist = res["loss_history"]
        diff = max((abs(a - b) for a, b in zip(first, hist)), default=0.0) \
            if len(hist) == len(first) else float("inf")
        out.append({"bit_equal": hist == first, "max_abs_diff": diff,
                    "first_diff_step": next(
                        (i for i, (a, b) in enumerate(zip(first, hist))
                         if a != b), None),
                    "accuracy": [results[0]["accuracy"], res["accuracy"]]})
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    split = argv.index("--") if "--" in argv else len(argv)
    own, train_args = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--entries", default="singlegpu,singlegpu")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--child", choices=ENTRIES, help=argparse.SUPPRESS)
    args = p.parse_args(own)
    if args.child:
        _child(args.child, args.deterministic, train_args)
        return {}
    entries = args.entries.split(",")
    results = run_entries(entries, train_args,
                          deterministic=args.deterministic)
    pairs = compare(results)
    for k, pair in enumerate(pairs, 1):
        print(f"run {k} ({entries[k]}) against run 0 ({entries[0]}), "
              f"deterministic mode {args.deterministic}: bit-equal "
              f"{pair['bit_equal']}, max |loss diff| "
              f"{pair['max_abs_diff']:.3e}, first differing step "
              f"{pair['first_diff_step']}, accuracy {pair['accuracy']}",
              flush=True)
    summary = {"entries": entries, "deterministic": args.deterministic,
               "device": results[0]["device"],
               "backends": [r["backend"] for r in results],
               "pairs": pairs,
               "step_ms_median": [statistics.median(r["step_ms"])
                                  if r["step_ms"] else None
                                  for r in results]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
