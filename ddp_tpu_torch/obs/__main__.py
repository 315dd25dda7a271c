"""``python -m ddp_tpu_torch.obs``: read a run's span spill and explain it
(counterpart of ``python -m ddp_tpu.obs``, with its flags, exit codes and
one-line diagnoses).  An offline tool: it reads files and touches no
device.

Prints the phase table (serial and overlap lanes, with the serial sum as a
share of wall), a step-time histogram and the slowest steps with their
phases; ``--perfetto OUT.json`` also writes a schema-checked
``trace_event`` file for ``ui.perfetto.dev``.  ``--requests`` lists the
slowest serving requests hop by hop instead; ``--ledger CALIB.json`` joins
the spill with a ``bench.py --calibrate_cost`` record (``obs/ledger.py``).
``--postmortem BUNDLE.json`` checks and renders a flight-recorder bundle
(``obs/blackbox.py``, ``postmortem.json`` beside the metrics stream after
an abnormal exit) and needs no spill.

A data-parallel run spills one file per rank (``--trace_spill`` and
``.hostN``); pass them all: the report prints one section per host (each
host's clock and wall are its own), the Perfetto export lays them side by
side.

Exit status: 0 on success; 2 on an unusable spill or bundle (a missing
file, no spans, a mixed train+serve spill, a torn or invalid bundle), each
diagnosed in one line.

Usage:
    python -m ddp_tpu_torch.obs trace_spill.jsonl [more_spills...]
        [--perfetto trace.json] [--top 10] [--bins 12]
        [--requests] [--ledger CALIB.json [--ledger_scale N]]
    python -m ddp_tpu_torch.obs --postmortem postmortem.json [--json]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .export import (format_report, format_requests_report, read_spill,
                     request_flows)
from .ledger import build_ledger, format_ledger

# Phase fingerprints: a train spill has the consumer loop's dispatch
# phase; a serve spill has the batcher pipeline.  Both in one spill
# means two unrelated runs were concatenated (or one path was reused),
# and every wall identity in the report would be fiction.
_TRAIN_MARKERS = frozenset(("dispatch",))
_SERVE_MARKERS = frozenset(("queue_wait", "batch_form"))


def _diagnose(spans: list, paths: list) -> Optional[str]:
    """One-line reason this spill cannot be reported on, or None."""
    if not spans:
        return (f"no spans in {', '.join(paths)} — was the run "
                "--obs_off, or killed before the first flush?")
    phases = {s["phase"] for s in spans}
    if (phases & _TRAIN_MARKERS) and (phases & _SERVE_MARKERS):
        return ("mixed train+serve spill (has both 'dispatch' and "
                f"{sorted(phases & _SERVE_MARKERS)}) — spills are "
                "per-run; pass one run's files, not a concatenation")
    return None


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.obs",
        description=__doc__.splitlines()[0])
    p.add_argument("spill", nargs="*",
                   help="Span spill file(s) from --trace_spill (one per "
                        "host; pass all of a run's files to merge)")
    p.add_argument("--postmortem", default=None, metavar="BUNDLE.json",
                   help="Render a flight-recorder postmortem bundle "
                        "(obs/blackbox.py) instead of a spill report; "
                        "missing/torn bundles exit 2 with a one-line "
                        "diagnosis")
    p.add_argument("--perfetto", default=None, metavar="OUT.json",
                   help="Also export a schema-validated Chrome/Perfetto "
                        "trace_event JSON (open in ui.perfetto.dev)")
    p.add_argument("--top", type=int, default=10,
                   help="Slowest-K steps/requests to list (default 10)")
    p.add_argument("--bins", type=int, default=12,
                   help="Step-time histogram bins (default 12)")
    p.add_argument("--requests", action="store_true",
                   help="Report the slowest-K request flows (router req "
                        "ids) instead of the phase/step tables")
    p.add_argument("--ledger", default=None, metavar="CALIB.json",
                   help="Join the spill against a bench.py "
                        "--calibrate_cost record into the predicted-vs-"
                        "measured efficiency ledger")
    p.add_argument("--ledger_scale", type=float, default=1.0,
                   help="Multiply predictions by this factor (set to the "
                        "device count on a virtual CPU mesh, whose "
                        "shards serialize; default 1)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="With --requests/--ledger: emit JSON instead of "
                        "the terminal table")
    args = p.parse_args(argv)
    if args.postmortem is not None:
        # Bundle mode needs no spill; diagnose every unusable shape in
        # one line (the operator is mid-incident — no tracebacks).
        from .blackbox import format_postmortem, validate_postmortem
        try:
            with open(args.postmortem) as f:
                doc = json.load(f)
        except OSError as e:
            print(f"cannot read postmortem bundle: {e} — did the run "
                  "exit cleanly (no bundle is written on status 0)?",
                  file=sys.stderr)
            return 2
        except json.JSONDecodeError as e:
            print(f"torn postmortem bundle {args.postmortem}: {e} — the "
                  "writer is crash-atomic, so a torn file means a "
                  "partial copy or truncation in transit",
                  file=sys.stderr)
            return 2
        try:
            validate_postmortem(doc)
        except ValueError as e:
            print(f"invalid postmortem bundle {args.postmortem}: {e}",
                  file=sys.stderr)
            return 2
        print(json.dumps(doc) if args.as_json else format_postmortem(doc))
        return 0
    if not args.spill:
        p.error("a spill file is required (or use --postmortem)")
    try:
        spans = read_spill(args.spill)
    except OSError as e:
        print(f"cannot read spill: {e}", file=sys.stderr)
        return 2
    why = _diagnose(spans, args.spill)
    if why is not None:
        print(why, file=sys.stderr)
        return 2
    try:
        if args.ledger is not None:
            try:
                with open(args.ledger) as f:
                    calib = json.load(f)
                ledger = build_ledger(spans, calib,
                                      pred_scale=args.ledger_scale)
            except (OSError, ValueError, json.JSONDecodeError) as e:
                print(f"cannot build ledger: {e}", file=sys.stderr)
                return 2
            print(json.dumps(ledger) if args.as_json
                  else format_ledger(ledger))
        elif args.requests:
            print(json.dumps(request_flows(spans)) if args.as_json
                  else format_requests_report(spans, top=args.top))
        else:
            print(format_report(spans, top=args.top, bins=args.bins,
                                perfetto_out=args.perfetto))
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
