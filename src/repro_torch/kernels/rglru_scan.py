"""K5: the RG-LRU scan — the port of the Pallas ``_rglru_kernel``
(``src/repro/kernels/rglru_scan.py:26``).

``h_t = a_t * h_{t-1} + b_t`` over (B, S, D), from ``h0`` or zeros, in
float32. For a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/rglru_scan.cu`` on the current stream and counts the launch; for a
CPU tensor it runs the plain PyTorch version. There is no fallback: a
CUDA operand the kernel does not take, or a failed build or launch,
raises.

Under autograd (grad enabled and an operand that requires grad) the
wrapper goes through ``RGLRUScanFn``: the same forward kernel, and for the
gradients of ``a``, ``b`` and ``h0`` the reverse scan of
``csrc/rglru_scan_bwd.cu`` (``rglru_scan_bwd``, the counterpart of the
gradient the reference takes through its XLA path, the associative scan
of ``ops.rglru_scan(impl="xla")``; the Pallas kernel has no VJP). On CPU
tensors the Function runs the plain forward and ``ref.rglru_scan_bwd``.

FakeTensor operands take the shape-only path (``build.is_fake``), forward
and backward: the checks, the outputs, the cost recorded (``cost``,
``bwd_cost``), no launch (a fake tensor has no address to plan copies
by).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch versions (the CPU path, and what the kernels are held
# against on the card: bit for bit)
rglru_scan_plain = ref.rglru_scan
rglru_scan_bwd_plain = ref.rglru_scan_bwd

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


def cost(a, b, h0, out):
    """(FLOPs, HBM bytes) of one forward call: a, b and h0 read once, h
    written once; a multiply and an add an element."""
    return 2 * a.numel(), build.nbytes(a, b, h0, out)


def bwd_cost(a, h, dh, h0, da, db, dh0):
    """(FLOPs, HBM bytes) of one backward call: a, h, dh and h0 read once,
    the gradients written once; three operations an element."""
    return 3 * a.numel(), build.nbytes(a, h, dh, h0, da, db, dh0)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("rglru_scan_bwd").rglru_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               plan: Optional[ScanPlan] = None) -> torch.Tensor:
    """a, b: (B, S, D) float32 or bfloat16, one dtype; h0: (B, D) or None.
    Returns h: (B, S, D) float32. ``plan`` overrides the kernel instance
    (``scan_plan`` with explicit choices; the card only). Differentiable
    (``RGLRUScanFn``) where autograd asks."""
    build.refuse_dtensor("rglru_scan", a, b, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0, plan)
    fake = build.is_fake(a, b, h0)
    if not a.is_cuda and not fake:
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
    if fake:
        build.record_cost(rglru_scan, *cost(a, b, h0, out))
        return out
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


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   plan: Optional[ScanPlan] = None):
    """The gradients (da, db, dh0) of ``rglru_scan`` from ``a``, the
    forward's output ``h`` and its gradient ``dh`` (all (B, S, D) float32)
    and ``h0`` ((B, D) float32 or None; dh0 is None then): float32,
    equal bit for bit to ``ref.rglru_scan_bwd``. On the card one launch of
    the reverse scan (the forward's channel-parallel layout and copy plan,
    time running backwards); on the CPU the plain version."""
    build.refuse_dtensor("rglru_scan_bwd", a, h, dh, h0)
    fake = build.is_fake(a, h, dh, h0)
    if not a.is_cuda and not fake:
        return rglru_scan_bwd_plain(a, h, dh, h0)
    B, S, D = a.shape
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        if t.shape != (B, S, D) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(B, S, D)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if h0 is not None and (h0.shape != (B, D) or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be float32 of shape {(B, D)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    operands = dict(a=a, h=h, dh=dh, da=da, db=db)
    if h0 is not None:
        operands.update(h0=h0, dh0=dh0)
    build.check_operands(a.device, align=1, **operands)
    if fake:
        build.record_cost(rglru_scan_bwd, *bwd_cost(a, h, dh, h0, da, db, dh0))
        return da, db, dh0
    if plan is None:
        plan = scan_plan(D, 4, *(t.data_ptr() for t in operands.values()))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _bwd_launcher()(a.data_ptr(), h.data_ptr(), dh.data_ptr(), ptr(h0),
                         da.data_ptr(), db.data_ptr(), ptr(dh0), B, S, D,
                         plan.ch, plan.vec, stream)
    build.check_launch("rglru_scan_bwd", rc)
    build.count_launch(rglru_scan_bwd)
    return da, db, dh0


rglru_scan_bwd.launches = 0
rglru_scan_bwd.kernel = "K5 bwd"  # its bodies: build.BODIES


class RGLRUScanFn(torch.autograd.Function):
    """K5 under autograd: the forward scan, and the reverse scan for the
    gradients of a, b and h0 (the plain versions of both on CPU tensors).
    Saves a, h0 and the float32 output h."""

    @staticmethod
    def forward(ctx, a, b, h0, plan):
        h = rglru_scan(a, b, h0, plan=plan)     # grad is off in here
        ctx.save_for_backward(a, h, h0)
        ctx.dtypes = (a.dtype, b.dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        if a.is_cuda or build.is_fake(a):
            da, db, dh0 = rglru_scan_bwd(a.float().contiguous(), h,
                                         dh.float().contiguous(), h0)
        else:
            da, db, dh0 = rglru_scan_bwd(a, h, dh, h0)
        da_t, db_t = ctx.dtypes
        return da.to(da_t), db.to(db_t), dh0, None
