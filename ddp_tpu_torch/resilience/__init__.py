"""Resilience of the port (counterpart of ``ddp_tpu/resilience/``): the
checkpoint lineage (``lineage``), the step health guard (``guard``), the
preemption guard and its stop decisions (``preemption``), the watchdog
(``watchdog``), the cross-replica drift audit (``drift``), the drills'
fault injection (``faults``), the checkpoint mirror's object store
(``store``) and the restart wrapper (``supervisor``, ``python -m
ddp_tpu_torch.supervise``)."""
