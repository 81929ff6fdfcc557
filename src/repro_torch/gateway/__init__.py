"""The port's invocation gateway: one ``invoke()`` path over real
execution on the card's worker threads (the engine backend), plus the
workflow composition layer (chains / fan-out / fan-in as one submission)
and at-least-once delivery past a worker's death. The simulated cluster
backend of ``repro.gateway`` is not ported yet."""
from repro_torch.gateway.backends import Backend, EngineBackend
from repro_torch.gateway.future import (InvocationError, InvocationFuture,
                                        InvocationRejected,
                                        InvocationRetriesExhausted)
from repro_torch.gateway.gateway import Gateway
from repro_torch.gateway.workflow import (Step, Workflow, WorkflowFuture,
                                          WorkflowRunner, WorkflowStepError)

__all__ = ["Backend", "EngineBackend", "Gateway",
           "InvocationError", "InvocationFuture", "InvocationRejected",
           "InvocationRetriesExhausted",
           "Step", "Workflow", "WorkflowFuture", "WorkflowRunner",
           "WorkflowStepError"]
