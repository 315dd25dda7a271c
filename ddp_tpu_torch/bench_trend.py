"""Trajectory comparator over the repo's BENCH_*.json history
(counterpart of ``tools/bench_trend.py``; same families, verdicts and
output).  A copy, since the port imports nothing of the tree it replaces:
a fix to either is made to both, and ``tests/test_torch_bench_modes.py``
holds the two outputs equal.

Every round lands one ``BENCH_rNN.json`` (the bench command's JSON-line
records in ``tail``, sometimes pre-parsed under ``parsed``).  This tool
reads the whole series, groups records into metric families (the metric
string minus its parenthetical config — configs drift round to round, the
family is the trajectory), and prints
each family's history with a verdict on the newest point vs the best of
its history: ``ok`` within the noise threshold, ``WARN`` when the
headline moved the wrong way by more than ``--threshold`` percent.

Direction is inferred from the unit: throughput-like units
(``samples/sec``, ``req/s``, MFU fractions) are higher-better;
time/overhead units (``ms``, ``s``, ``%``) are lower-better; unknown
units are tracked but never warned on.

CI runs this after the tier-1 suite and uploads ``--out`` as an
artifact; regressions WARN rather than fail — the bench box is shared
and noisy, and the gate for hard floors is BUDGETS.json, not this
trend.  ``--strict`` turns warnings into exit 1 for local use.

Usage:
    python -m ddp_tpu_torch.bench_trend [--glob 'BENCH_*.json']
        [--threshold 10] [--out trend.json] [--strict]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

HIGHER_BETTER = ("samples/sec", "req/s", "mfu", "fraction", "accuracy",
                 "speedup", "tokens/s", "tokens/sec")
LOWER_BETTER = ("ms", "s/flop", "s/byte", "seconds", "%", "s")


def _direction(unit: str) -> Optional[int]:
    """+1 higher-better, -1 lower-better, None unknown (never warned)."""
    u = (unit or "").lower()
    for marker in HIGHER_BETTER:
        if marker in u:
            return +1
    # Exact-ish time units only: "s" must not swallow "samples/sec".
    for marker in LOWER_BETTER:
        if u == marker or u.startswith(marker + "/") or \
                u.startswith(marker + " "):
            return -1
    return None


def _family(metric: str) -> str:
    """Metric family: the headline text minus its parenthetical config
    (batch sizes, chip counts, bucket lists drift between rounds) —
    except the compute precision, which changes what is being measured
    (an fp32 round is not a regression of a bf16 round)."""
    base = re.sub(r"\s*\(.*", "", metric).strip()
    cfg = re.search(r"\((.*)\)", metric)
    tokens = [t for t in ("fp32", "bf16")
              if cfg and t in cfg.group(1)]
    return base + (f" [{'/'.join(tokens)}]" if tokens else "")


def _records_of(doc: dict) -> List[dict]:
    """Every metric record in one BENCH_rNN.json: the ``parsed``
    field (dict or list) plus any JSON lines in ``tail`` / ``tail_*``
    keys, deduped by (metric, value)."""
    out: List[dict] = []
    parsed = doc.get("parsed")
    if isinstance(parsed, dict):
        out.append(parsed)
    elif isinstance(parsed, list):
        out.extend(r for r in parsed if isinstance(r, dict))
    for key, val in doc.items():
        if not (key == "tail" or key.startswith("tail_")):
            continue
        for line in str(val).splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "metric" in rec:
                out.append(rec)
    seen: set = set()
    uniq: List[dict] = []
    for r in out:
        k = (r.get("metric"), repr(r.get("value")))
        if r.get("metric") and k not in seen:
            seen.add(k)
            uniq.append(r)
    # Memory-ledger records (bench.py --mem_ledger, r14+) carry a
    # per-program gap dict; expand it into one family per program so the
    # trend tracks each program's measured-vs-predicted gap separately —
    # the headline (median abs gap) hides a single program drifting.
    # Absolute value: the trajectory cares about |gap| shrinking, and a
    # sign flip through zero is not an improvement past the prediction.
    for r in list(uniq):
        gaps = r.get("mem_gap_pct")
        if not isinstance(gaps, dict):
            continue
        for prog, gap in sorted(gaps.items()):
            if isinstance(gap, (int, float)):
                uniq.append({
                    "metric": f"memory gap {prog}",
                    "value": abs(gap),
                    "unit": "% absolute measured-vs-predicted "
                            "resident-bytes gap"})
    return uniq


def _round_no(path: str) -> int:
    m = re.search(r"r(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def build_trend(paths: List[str], threshold_pct: float) -> dict:
    """The full trend table: per metric family, the (round, value)
    series and a verdict comparing the newest point against the best
    earlier point (best = max or min per the unit's direction)."""
    series: Dict[str, dict] = {}
    for path in sorted(paths, key=_round_no):
        rnd = _round_no(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"WARNING: skipping {path}: {e}", file=sys.stderr)
            continue
        for rec in _records_of(doc):
            try:
                value = float(rec["value"])
            except (KeyError, TypeError, ValueError):
                continue  # prose-valued records have no trajectory
            fam = _family(str(rec["metric"]))
            ent = series.setdefault(
                fam, {"unit": rec.get("unit", ""), "points": []})
            ent["points"].append({"round": rnd, "value": value})
    families: List[dict] = []
    warnings: List[str] = []
    for fam in sorted(series):
        ent = series[fam]
        pts = ent["points"]
        direction = _direction(ent["unit"])
        verdict = "single-point" if len(pts) < 2 else "ok"
        delta_pct = None
        if len(pts) >= 2 and direction is not None:
            prev = [p["value"] for p in pts[:-1]]
            best = max(prev) if direction > 0 else min(prev)
            cur = pts[-1]["value"]
            if best:
                delta_pct = round((cur - best) / abs(best) * 100.0, 2)
                regressed = (direction > 0 and delta_pct < -threshold_pct
                             ) or (direction < 0
                                   and delta_pct > threshold_pct)
                if regressed:
                    verdict = "WARN"
                    warnings.append(
                        f"{fam}: r{pts[-1]['round']} value {cur:g} is "
                        f"{delta_pct:+.1f}% vs best-of-history {best:g} "
                        f"({ent['unit']})")
        elif len(pts) >= 2:
            verdict = "untracked-unit"
        families.append({
            "family": fam, "unit": ent["unit"], "points": pts,
            "direction": ({1: "higher-better", -1: "lower-better",
                           None: "unknown"}[direction]),
            "delta_vs_best_pct": delta_pct, "verdict": verdict,
        })
    return {"threshold_pct": threshold_pct, "families": families,
            "warnings": warnings}


def format_trend(trend: dict) -> str:
    lines = [f"{'family':<58} {'unit':<18} {'pts':>4} "
             f"{'Δ vs best':>10} verdict"]
    for fam in trend["families"]:
        d = (f"{fam['delta_vs_best_pct']:+.1f}%"
             if fam["delta_vs_best_pct"] is not None else "-")
        lines.append(f"{fam['family'][:58]:<58} {fam['unit'][:18]:<18} "
                     f"{len(fam['points']):>4} {d:>10} {fam['verdict']}")
    for w in trend["warnings"]:
        lines.append(f"WARN: {w}")
    if not trend["warnings"]:
        lines.append(f"no headline regressions beyond "
                     f"{trend['threshold_pct']:g}%")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.bench_trend",
        description=__doc__.splitlines()[0])
    p.add_argument("--glob", default="BENCH_*.json",
                   help="History files to compare (default BENCH_*.json "
                        "in the current directory)")
    p.add_argument("--threshold", type=float, default=10.0,
                   help="Regression warning threshold in percent vs the "
                        "best historical point (default 10)")
    p.add_argument("--out", default=None, metavar="OUT.json",
                   help="Also write the full trend table as JSON (the CI "
                        "artifact)")
    p.add_argument("--strict", action="store_true",
                   help="Exit 1 when any family WARNs (local gating; CI "
                        "stays advisory)")
    args = p.parse_args(argv)
    paths = sorted(glob.glob(args.glob), key=_round_no)
    # Chaos scorecards (chaos_campaign.py) live next to the bench
    # records and match sloppy globs like '*_r*.json', but they hold
    # pass/fail drill verdicts, not metric trajectories — mixing them in
    # would invent bogus families.
    # Introspection artifacts (obs/blackbox.py postmortem bundles,
    # obs/inspect.py profile captures, supervisor diagnosis.json) are
    # also JSON and also land in run directories sloppy globs cover.
    _ARTIFACT_PREFIXES = ("CHAOS_", "postmortem", "profile_capture",
                          "profile_trace", "diagnosis")
    skipped = [p for p in paths
               if os.path.basename(p).startswith(_ARTIFACT_PREFIXES)]
    if skipped:
        print(f"ignoring {len(skipped)} non-bench artifact(s): "
              + ", ".join(os.path.basename(p) for p in skipped),
              file=sys.stderr)
        paths = [p for p in paths if p not in skipped]
    if not paths:
        print(f"no files match {args.glob!r} — nothing to compare",
              file=sys.stderr)
        return 2
    trend = build_trend(paths, args.threshold)
    print(format_trend(trend))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trend, f, indent=1)
        print(f"trend table written to {args.out}", file=sys.stderr)
    return 1 if (args.strict and trend["warnings"]) else 0


if __name__ == "__main__":
    raise SystemExit(main())
