"""``repro_torch.resilience`` — the failure layer, with the reference's
names and fault points:

* **Deterministic fault injection** (:mod:`~repro_torch.resilience.faults`,
  a copy of the reference's numpy-only module): named injection points at
  the hot seams (backend execute/execute_batch, the serving launch,
  checkpoint save/restore), driven by a seedable :class:`FaultPlan`.
* **Numerical health guards** (:mod:`~repro_torch.resilience.health`):
  :class:`HealthPolicy` NaN/Inf/amplitude checks reduced on the device;
  structured :class:`NumericalFault` / :class:`LaunchFailed` errors.
* **Retries and circuit breaking** (:mod:`~repro_torch.resilience.retry`):
  capped-exponential :class:`RetryPolicy`, per-bucket
  :class:`CircuitBreaker`.
* **Checkpointed long runs**
  (:mod:`~repro_torch.resilience.checkpoint_run`):
  ``StencilPlan.run(..., checkpoint_every=, checkpoint_dir=)`` chunked
  over the atomic ``repro_torch.checkpoint`` substrate.
"""
from repro_torch.resilience.checkpoint_run import (CheckpointedRun,
                                                   run_checkpointed)
from repro_torch.resilience.faults import (FaultPlan, FaultSpec,
                                           InjectedFault, active_plan,
                                           corrupt_point, fault_point,
                                           register_point,
                                           registered_points)
from repro_torch.resilience.health import (CheckpointMismatch, HealthPolicy,
                                           LaunchFailed, NumericalFault,
                                           ResilienceError)
from repro_torch.resilience.retry import (BreakerConfig, CircuitBreaker,
                                          RetryPolicy)

__all__ = [
    "BreakerConfig", "CheckpointMismatch", "CheckpointedRun",
    "CircuitBreaker", "FaultPlan", "FaultSpec", "HealthPolicy",
    "InjectedFault", "LaunchFailed", "NumericalFault", "ResilienceError",
    "RetryPolicy", "active_plan", "corrupt_point", "fault_point",
    "register_point", "registered_points", "run_checkpointed",
]
