"""Telemetry of the port (counterpart of ``ddp_tpu/obs/``): the metrics
registry and its strict exposition parser, the span tracer, the Perfetto
export and reports (``export``, ``python -m ddp_tpu_torch.obs``), live
telemetry, the per-epoch straggler record (``aggregate``), the efficiency
ledger, the flight recorder (``blackbox``) and the live inspect plane
(``inspect``); ``memledger`` is not ported yet (ROADMAP A13c)."""
