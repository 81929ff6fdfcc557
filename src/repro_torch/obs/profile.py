"""Profiler ranges for engine steps (the port's ``jax_profile``).

:func:`torch_profile` names a region for the profilers: a
``torch.profiler.record_function`` range, so the region shows in a
``torch.profiler`` trace, and on a machine with a card also an NVTX range,
so it shows in Nsight. It is a no-op while the process tracer is off, so
an untraced engine step pays nothing but the check.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def torch_profile(name: str) -> Iterator[None]:
    """Annotate the enclosed region in any active profiler capture."""
    from repro_torch.obs import TRACER
    if not TRACER.enabled:
        yield
        return
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
