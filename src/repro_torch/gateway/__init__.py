"""The port's invocation gateway: one ``invoke()`` path over the
calibrated cluster simulation (the sim backend; a real ``fn`` runs inside
virtual time) and real execution on the card's worker threads (the engine
backend), plus the workflow composition layer (chains / fan-out / fan-in
as one submission) and at-least-once delivery (lease-based requeue,
worker supervision, workflow resume)."""
from repro_torch.gateway.backends import (Backend, CapacityHooks,
                                          EngineBackend, EngineCapacityHooks,
                                          SimBackend, SimCapacityHooks)
from repro_torch.gateway.future import (InvocationError, InvocationFuture,
                                        InvocationRejected,
                                        InvocationRetriesExhausted)
from repro_torch.gateway.gateway import Gateway
from repro_torch.gateway.workflow import (Step, Workflow, WorkflowFuture,
                                          WorkflowRunner, WorkflowStepError)

__all__ = ["Backend", "CapacityHooks", "EngineBackend",
           "EngineCapacityHooks", "SimBackend", "SimCapacityHooks", "Gateway",
           "InvocationError", "InvocationFuture", "InvocationRejected",
           "InvocationRetriesExhausted",
           "Step", "Workflow", "WorkflowFuture", "WorkflowRunner",
           "WorkflowStepError"]
