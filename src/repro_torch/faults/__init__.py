"""Fault injection and recovery policy (DESIGN.md §14), counterpart of
``repro.faults`` (copies of its modules)."""

from repro_torch.faults.plan import (FaultPlan, FaultSpec, RecoveryPolicy,
                                     ReplicaFaults, RequestFaults,
                                     attach_faults, parse_fault)

__all__ = ["FaultPlan", "FaultSpec", "RecoveryPolicy", "ReplicaFaults",
           "RequestFaults", "attach_faults", "parse_fault"]
