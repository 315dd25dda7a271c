"""Telemetry of the port: the metrics registry (and its strict exposition
parser), the span tracer, live telemetry, ``phase_medians`` and the flight
recorder (``blackbox``); export, inspect, ledger, the rest of aggregate and
memledger are not ported yet (ROADMAP A8)."""
