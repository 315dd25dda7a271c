"""Resilience of the port: the preemption guard's signal half (the rest of
``ddp_tpu/resilience/`` is not ported yet)."""
