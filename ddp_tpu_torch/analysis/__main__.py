"""``python -m ddp_tpu_torch.analysis``: the static passes of the program
auditor (the counterpart of ``python -m ddp_tpu.analysis``).

Runs, over the port's own tree:

1. the host-sync AST pass over ``train/``, ``data/``, ``serve/`` and
   ``parallel/`` (``hostsync``),
2. the lockset lint over the threaded subsystems (``lockset``),
3. the multi-rank divergence lint over the host-side coordination code
   (``divergence``),

prints one findings table, optionally writes the JSON artifact (JAX's
keys; ``inventories`` and ``cost_table`` stay empty), and with
``--strict`` exits nonzero on any ``error`` finding: the gate.
``--fixture <name>`` runs one seeded-faulty fixture instead (every fixture
fails ``--strict``; that is tested).

JAX's default run also traces the registered programs and prices them.
The port has no program registry yet, so a run must say
``--skip-programs`` (a run without it is refused, naming ROADMAP A13c.2,
rather than quietly auditing less), and the program flags (``--programs``,
``--model``, ``--mesh-shape``, ``--budgets``, ``--write-budgets``) are
refused by name with the item that ports each.

    python -m ddp_tpu_torch.analysis --skip-programs --strict
    python -m ddp_tpu_torch.analysis --skip-programs --json findings.json
    python -m ddp_tpu_torch.analysis --fixture rank_gated_collective --strict
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

# Program flags of JAX's CLI and the item that ports each.
_REGISTRY = "A13c.2, the program registry and the collective audit"
_BUDGETS = "A13c.3, the cost model and its budgets"
REFUSED_FLAGS = {
    "programs": ("--programs", _REGISTRY),
    "model": ("--model", _REGISTRY),
    "mesh_shape": ("--mesh-shape", _REGISTRY),
    "budgets": ("--budgets", _BUDGETS),
    "write_budgets": ("--write-budgets", _BUDGETS),
}


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.analysis",
        description="Audit the port's threaded runtime and host loops "
                    "before a chip run (the static passes).")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero when any error-severity finding "
                        "is reported (the gate)")
    p.add_argument("--json", metavar="PATH",
                   help="write the findings as a JSON artifact (JAX's "
                        "keys; no program inventories or cost table yet)")
    p.add_argument("--programs", metavar="A,B,...",
                   help="refused: the program registry is ROADMAP A13c.2")
    p.add_argument("--model", default=None,
                   help="refused: the program registry is ROADMAP A13c.2")
    p.add_argument("--mesh-shape", "--mesh_shape", dest="mesh_shape",
                   default=None, metavar="D,M[,S]",
                   help="refused: the program registry is ROADMAP A13c.2")
    from .fixtures import REFUSED, fixture_names
    p.add_argument("--fixture", metavar="NAME",
                   help="run one seeded-faulty fixture instead of the "
                        "passes: " + ", ".join(fixture_names())
                        + " (JAX's " + ", ".join(REFUSED)
                        + " are refused by name)")
    p.add_argument("--budgets", metavar="PATH", default=None,
                   help="refused: the cost budgets are ROADMAP A13c.3")
    p.add_argument("--write-budgets", action="store_true",
                   help="refused: the cost budgets are ROADMAP A13c.3")
    p.add_argument("--skip-programs", action="store_true",
                   help="skip the program auditors (required: they are "
                        "ROADMAP A13c.2); static passes only")
    p.add_argument("--skip-static", action="store_true",
                   help="skip the host-sync, lockset and divergence "
                        "passes")
    p.add_argument("--list", action="store_true",
                   help="list registered programs and fixtures, exit")
    return p.parse_args(argv)


def _refuse(args: argparse.Namespace) -> None:
    """Refuse by name what the port does not run yet."""
    for dest, (flag, item) in REFUSED_FLAGS.items():
        if getattr(args, dest):
            raise SystemExit(f"{flag}: not ported; it is ROADMAP {item}")
    if not (args.skip_programs or args.fixture or args.list):
        raise SystemExit(
            "the program auditors (the registry's collective audit, cost "
            "and liveness) are not ported; they are ROADMAP A13c.2. Pass "
            "--skip-programs to run the static passes alone")


def run(argv: Optional[List[str]] = None, out=None) -> int:
    args = _parse(argv)
    out = out or sys.stdout
    _refuse(args)

    if args.list:
        from .fixtures import REFUSED, fixture_names
        print("programs: none registered (ROADMAP A13c.2)", file=out)
        print("fixtures:", file=out)
        for name in fixture_names():
            print(f"  {name}", file=out)
        print("refused fixtures:", file=out)
        for name, why in REFUSED.items():
            print(f"  {name}: {why}", file=out)
        return 0

    from .findings import count_by_severity, format_table

    findings = []
    if args.fixture:
        from .fixtures import run_fixture
        findings.extend(run_fixture(args.fixture))
    elif not args.skip_static:
        from .divergence import scan_packages as divergence_scan
        from .hostsync import scan_packages
        from .lockset import scan_modules
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        findings.extend(scan_packages(pkg_root))
        findings.extend(scan_modules(pkg_root))
        findings.extend(divergence_scan(pkg_root))

    print(format_table(findings), file=out)
    counts = count_by_severity(findings)

    if args.json:
        artifact = {"counts": counts,
                    "findings": [f.as_json() for f in findings],
                    "inventories": {},
                    "cost_table": {},
                    "mesh_shape": []}
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(artifact, fh, indent=2, sort_keys=True)
        print(f"wrote {args.json}", file=out)

    if args.strict and counts["error"]:
        print(f"--strict: {counts['error']} error finding(s)", file=out)
        return 1
    return 0


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
