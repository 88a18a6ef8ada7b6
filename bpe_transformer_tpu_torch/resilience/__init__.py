"""Resilience (the port's counterparts of ``bpe_transformer_tpu/resilience``):
checkpoint integrity (``integrity``), graceful preemption (``signals``), the
NaN-rollback crash-loop breaker (``rollback``), checkpoint retention
(``retention``), the respawning training supervisor (``supervisor``) and
deterministic fault injection (``faults``).  Every module imports no torch
(``faults.FaultInjector.poison_params`` imports the tree helpers when
called)."""
