"""Fault injection — the public surface of the reliability subsystem's
kill/stall/crash schedule layer (implementation in
:mod:`repro_torch.core.faults`; the port's copy of ``repro.faults``)."""
from repro_torch.core.faults import (ALL_OPS, CLUSTER_OPS, ENGINE_OPS,
                                     SIM_OPS, FaultAction, FaultInjector,
                                     inject, parse_fault_spec)

__all__ = ["ALL_OPS", "CLUSTER_OPS", "ENGINE_OPS", "SIM_OPS", "FaultAction",
           "FaultInjector", "inject", "parse_fault_spec"]
