"""Labelled counters, gauges and histograms with Prometheus text exposition
(counterpart of ``ddp_tpu/obs/registry.py``: the part the serving engine,
the batcher and ``GET /metrics`` use).

The metric names, label schemas and the text format are the JAX package's,
so a scraper of ``python -m ddp_tpu.serve`` reads the port's server the same
way.  A registry is an ordinary object, never a process singleton: the serve
entry point makes one and hands it to the engine and the batcher.  One lock
guards family creation; each child guards its own value, so ``inc()`` on the
serving path never waits behind a scrape for longer than a dict update.

The format is Prometheus text exposition v0.0.4: ``# HELP`` / ``# TYPE``
lines, ``\\`` ``\"`` ``\\n`` escapes in label values, and cumulative
``_bucket{le=...}`` histogram series ending at ``+Inf`` with matching
``_sum`` and ``_count``.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Milliseconds-flavoured default buckets: request latencies are the
# histograms serving keeps.
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != v:
        return "NaN"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labelset(labelnames: Sequence[str],
              labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Counter:
    """A monotone counter child; ``value`` is the read side the ``stats()``
    dicts are backed by."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Report ``fn()`` at collection time instead of a stored value,
        for a component that stays its own source of truth."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None:
            return float(fn())
        with self._lock:
            return self._value


class _Gauge(_Counter):
    """A gauge child: free to move both ways."""

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount


class _Histogram:
    """Cumulative-bucket histogram child (each ``le`` bucket counts every
    observation <= its bound)."""

    def __init__(self, buckets: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self._bounds) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self._bounds):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        """(bounds, cumulative counts incl +Inf, sum, count)."""
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return self._bounds, cum, self._sum, self._count

    @property
    def value(self) -> float:
        """The observation count."""
        with self._lock:
            return float(self._count)


_KINDS = {"counter": _Counter, "gauge": _Gauge}


class _Family:
    """One named metric family: a TYPE, a HELP string, a label schema, and
    the children keyed by label values."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str],
                 buckets: Sequence[float]) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = (_Histogram(self._buckets)
                         if self.kind == "histogram"
                         else _KINDS[self.kind]())
                self._children[key] = child
            return child

    def set_function(self, fn: Callable[[], float]) -> None:
        """:meth:`_Counter.set_function` of an unlabelled family's one
        child."""
        self.labels().set_function(fn)

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """A collection of metric families with Prometheus exposition.

    Asking again for a name with the same kind and label names returns the
    existing family, so every component declares what it uses; a kind or
    schema mismatch raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str],
                buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"bad label name {ln!r} on {name}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labelnames)} but exists as {fam.kind}"
                        f"{fam.labelnames}")
                return fam
            fam = _Family(name, kind, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labelnames, buckets)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def exposition(self) -> str:
        """Prometheus text format v0.0.4 for every family, sorted by name."""
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} "
                           f"{fam.help.replace(chr(10), ' ')}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                if fam.kind == "histogram":
                    bounds, cum, h_sum, h_count = child.snapshot()
                    for b, c in zip(bounds + (math.inf,), cum):
                        ls = _labelset(fam.labelnames + ("le",),
                                       key + (_fmt_value(b),))
                        out.append(f"{fam.name}_bucket{ls} {c}")
                    ls = _labelset(fam.labelnames, key)
                    out.append(f"{fam.name}_sum{ls} {_fmt_value(h_sum)}")
                    out.append(f"{fam.name}_count{ls} {h_count}")
                else:
                    ls = _labelset(fam.labelnames, key)
                    out.append(
                        f"{fam.name}{ls} {_fmt_value(child.value)}")
        return "\n".join(out) + ("\n" if out else "")
