"""Resilience of the port (counterpart of ``ddp_tpu/resilience/``): the
checkpoint lineage (``lineage``), the step health guard (``guard``), the
preemption guard and its stop decisions (``preemption``), the watchdog
(``watchdog``), the cross-replica drift audit (``drift``) and the drills'
fault injection (``faults``).  The storage half, the checkpoint mirror and
the supervisor, is not ported yet (ROADMAP A7b)."""
