"""The findings model every pass in this package reports through (a copy
of ``ddp_tpu/analysis/findings.py``: the same findings give the same
table text).

One flat record type, ``Finding(severity, check, where, detail)``, so the
CLI can render any pass's output in one table and one JSON artifact, and
``--strict`` has a single rule to apply (nonzero exit on any ``error``).
Severity vocabulary:

- ``error``: a violated invariant (an unlocked shared attribute, a host
  sync in a step loop, a collective only some ranks reach).  Fails
  ``--strict``.
- ``warning``: a smell the pass cannot prove is a bug (an unparseable
  module, a configured module that is missing).  Reported, never fatal.
- ``info``: context lines.

``check`` is a stable machine-readable slug (``host-sync``, ``lockset``,
``divergence``), the JSON artifact's join key; ``where`` locates the
finding (``file:line``, or a fixture name); ``detail`` is the human
sentence.
"""
from __future__ import annotations

from typing import List, NamedTuple

SEVERITIES = ("error", "warning", "info")


class Finding(NamedTuple):
    severity: str
    check: str
    where: str
    detail: str

    def as_json(self) -> dict:
        return {"severity": self.severity, "check": self.check,
                "where": self.where, "detail": self.detail}


def make_finding(severity: str, check: str, where: str,
                 detail: str) -> Finding:
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}; "
                         f"expected one of {SEVERITIES}")
    return Finding(severity, check, where, detail)


def count_by_severity(findings: List[Finding]) -> dict:
    out = {s: 0 for s in SEVERITIES}
    for f in findings:
        out[f.severity] += 1
    return out


def format_table(findings: List[Finding]) -> str:
    """The findings table the CLI prints: severity-sorted, fixed columns.
    An empty list renders the explicit all-clear line (the absence of a
    table must be distinguishable from a crashed pass)."""
    if not findings:
        return "no findings"
    order = {s: i for i, s in enumerate(SEVERITIES)}
    rows = sorted(findings, key=lambda f: (order[f.severity], f.check,
                                           f.where))
    cols = ("severity", "check", "where", "detail")
    body = [(f.severity, f.check, f.where, f.detail) for f in rows]
    widths = [max(len(c), *(len(r[i]) for r in body))
              for i, c in enumerate(cols[:3])]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths) + "  {}"
    lines = [fmt.format(*cols)]
    lines += [fmt.format(*r) for r in body]
    counts = count_by_severity(findings)
    lines.append(", ".join(f"{counts[s]} {s}{'s' if counts[s] != 1 else ''}"
                           for s in SEVERITIES if counts[s]))
    return "\n".join(lines)
