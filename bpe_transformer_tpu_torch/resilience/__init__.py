"""Resilience (the port's counterparts of ``bpe_transformer_tpu/resilience``):
checkpoint integrity (``integrity``), graceful preemption (``signals``), the
NaN-rollback crash-loop breaker (``rollback``), checkpoint retention
(``retention``), the respawning training supervisor (``supervisor``) and
deterministic fault injection (``faults``).  Every module imports no torch
(``faults.FaultInjector.poison_params`` imports the tree helpers when
called)."""

from bpe_transformer_tpu_torch.resilience.faults import FaultInjector, FaultPlan, corrupt_file
from bpe_transformer_tpu_torch.resilience.integrity import (
    VerifyResult,
    atomic_write_json,
    latest_valid_checkpoint,
    quarantine,
    verify_checkpoint,
)
from bpe_transformer_tpu_torch.resilience.retention import gc_checkpoints
from bpe_transformer_tpu_torch.resilience.rollback import RollbackBudget, RollbackExhausted
from bpe_transformer_tpu_torch.resilience.signals import EXIT_PREEMPTED, GracefulShutdown
from bpe_transformer_tpu_torch.resilience.supervisor import supervise

__all__ = [
    "EXIT_PREEMPTED",
    "FaultInjector",
    "FaultPlan",
    "GracefulShutdown",
    "RollbackBudget",
    "RollbackExhausted",
    "VerifyResult",
    "atomic_write_json",
    "corrupt_file",
    "gc_checkpoints",
    "latest_valid_checkpoint",
    "quarantine",
    "supervise",
    "verify_checkpoint",
]
