"""Observability: per-invocation distributed tracing (docs/observability.md).

The module-level :data:`TRACER` is the process's tracer — disabled (and
therefore free) until :func:`enable` is called.  Instrumented hot paths
gate on ``TRACER.enabled`` before touching anything else.

    from repro_torch import obs
    obs.enable(clock=backend.now, metrics=backend.metrics)
    ... run traffic ...
    obs.export("trace.json")            # load at https://ui.perfetto.dev

The port's copy of ``repro.obs``, with :func:`torch_profile` (a
``torch.profiler`` / NVTX range) in place of ``jax_profile``. It resolves
on first use, so a process that only traces (a cluster worker serving a
runtime without a model) does not import torch.
"""
from repro_torch.obs.export import to_trace_events, write_trace
from repro_torch.obs.tracer import (ABANDONED, ERROR, OK, REJECTED,
                                    SPAN_NAMES, Span, Tracer)
from repro_torch.obs.validate import validate_trace, validate_trace_file

TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer singleton."""
    return TRACER


def enable(**kwargs) -> Tracer:
    """Enable the process tracer (see :meth:`Tracer.enable`)."""
    return TRACER.enable(**kwargs)


def disable() -> None:
    """Stop emitting; collected spans are kept."""
    TRACER.disable()


def reset() -> None:
    """Back to pristine: disabled, empty, wall clock."""
    TRACER.reset()


def __getattr__(name):
    if name == "torch_profile":
        from repro_torch.obs.profile import torch_profile
        return torch_profile
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def export(path: str) -> int:
    """Write the process tracer's spans as Perfetto trace_event JSON."""
    return write_trace(path, TRACER.spans())


__all__ = [
    "ABANDONED", "ERROR", "OK", "REJECTED", "SPAN_NAMES", "Span", "Tracer",
    "TRACER", "get_tracer", "enable", "disable", "reset", "export",
    "to_trace_events", "write_trace", "validate_trace",
    "validate_trace_file", "torch_profile",
]
