"""Telemetry of the port: the metrics registry and the span tracer (the part
of ``ddp_tpu/obs/`` that serving uses; export, inspect, ledger, live,
blackbox and memledger are not ported yet)."""
