"""Deterministic fault injection, copied from the reference's numpy-only
``resilience/faults.py`` with the same point names, so that its chaos
matrix can carry over.  Health guards, retries and checkpointed stencil
runs are not ported yet (ROADMAP A13)."""
from repro_torch.resilience.faults import (FaultPlan, FaultSpec,
                                           InjectedFault, active_plan,
                                           corrupt_point, fault_point,
                                           register_point,
                                           registered_points)

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "active_plan",
           "corrupt_point", "fault_point", "register_point",
           "registered_points"]
