"""K5: the RG-LRU scan — the port of the Pallas ``_rglru_kernel``
(``src/repro/kernels/rglru_scan.py:26``).

``h_t = a_t * h_{t-1} + b_t`` over (B, S, D), from ``h0`` or zeros, in
float32. For a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/rglru_scan.cu`` on the current stream and counts the launch; for a
CPU tensor it runs the plain PyTorch version. There is no fallback: a
CUDA operand the kernel does not take, or a failed build or launch,
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch version (the CPU path, and what the kernel is held
# against on the card: bit for bit)
rglru_scan_plain = ref.rglru_scan

CH_CHOICES = (16, 32, 64)      # channels a block
VEC_CHOICES = (16, 8, 4, 2)    # bytes a copy
# the default channel count, from timing every choice at recurrentgemma-2b's
# prefill (B=1 S=3000 D=2560 float32) in one chip_smoke.py run (PERF.md)
DEFAULT_CH = 16


class ScanPlan(NamedTuple):
    ch: int          # channels a block: grid (ceil(D / ch), B)
    vec: int         # bytes a copy of a and b


def scan_plan(D: int, itemsize: int, *ptrs: int,
              ch: Optional[int] = None) -> ScanPlan:
    """The kernel instance for rows of ``D`` elements of ``itemsize`` bytes
    at addresses ``ptrs``: the widest copy every row start is aligned to,
    and ``ch`` channels a block (the default where None)."""
    align = math.gcd(D * itemsize, *ptrs)
    vec = next(v for v in VEC_CHOICES if v >= itemsize and align % v == 0)
    ch = DEFAULT_CH if ch is None else ch
    if ch not in CH_CHOICES:
        raise ValueError(f"no K5 instance for ch={ch}")
    return ScanPlan(ch, vec)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               plan: Optional[ScanPlan] = None) -> torch.Tensor:
    """a, b: (B, S, D) float32 or bfloat16, one dtype; h0: (B, D) or None.
    Returns h: (B, S, D) float32. ``plan`` overrides the kernel instance
    (``scan_plan`` with explicit choices; the card only)."""
    if not a.is_cuda:
        return rglru_scan_plain(a, b, h0)
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must share one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError("a and b must share one dtype")
    B, S, D = a.shape
    if h0 is not None:
        if h0.shape != (B, D) or h0.dtype != torch.float32:
            raise ValueError(f"h0 must be float32 of shape {(B, D)}, got "
                             f"{h0.dtype} {tuple(h0.shape)}")
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    operands = dict(a=a, b=b, out=out)
    if h0 is not None:
        operands["h0"] = h0
    # the plan takes the copy width from the rows' own alignment
    build.check_operands(a.device, align=1, **operands)
    code = build.dtype_code(a)
    if plan is None:
        plan = scan_plan(D, a.element_size(), a.data_ptr(), b.data_ptr())
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _launcher()(a.data_ptr(), b.data_ptr(),
                     h0.data_ptr() if h0 is not None else None,
                     out.data_ptr(), B, S, D, code, plan.ch, plan.vec, stream)
    build.check_launch("rglru_scan", rc)
    build.count_launch(rglru_scan)
    return out


rglru_scan.launches = 0
rglru_scan.kernel = "K5"  # its bodies: build.BODIES
