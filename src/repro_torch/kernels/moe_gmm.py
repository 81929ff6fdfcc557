"""K4: the grouped (expert) matmul — the port of the Pallas ``_gmm_kernel``
(``src/repro/kernels/moe_gmm.py:26``), forward and backward.

``jax.lax.ragged_dot`` semantics: rows of x (T, K) are sorted by expert,
the ``group_sizes[e]`` rows of expert e multiply w[e] (K, N), products
accumulate in float32, and the output (T, N) is ``x.dtype``; rows past the
last group are zero. For a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/moe_gmm.cu`` on the current stream and
counts the launch (bf16 on the tensor cores, float32 with exact FMA on
the CUDA cores); the group sizes stay on the card (the host never reads
them). For a CPU tensor it runs the plain PyTorch version. There is no
fallback: a CUDA operand the kernel does not take, or a failed build or
launch, raises.

Under autograd (grad enabled and x or w requiring grad) the wrapper goes
through ``MoeGmmFn``: the same forward kernel, and for the gradients
dX = dY W[e]^T and dW[e] = X_e^T dY_e the kernels of
``csrc/moe_gmm_bwd.cu`` (``moe_gmm_bwd``, the counterpart of the gradient
the reference takes through its XLA path, ``jax.lax.ragged_dot``; the
Pallas kernel has no VJP). On CPU tensors the Function runs the plain
forward and ``ref.moe_gmm_bwd``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch versions (the CPU path, and what the kernels are held
# against on the card)
moe_gmm_plain = ref.moe_gmm
moe_gmm_bwd_plain = ref.moe_gmm_bwd

BN = 64              # the float32 kernel's column tile (grid.y = ceil(N / BN);
                     # bf16's is 256, so its grid.y is smaller)
MAX_EXPERTS = 256    # group offsets live in one block's shared memory
DW_ROWS = 64         # the dW kernels' K tile: grid.y = E * ceil(K / DW_ROWS)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("moe_gmm").moe_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("moe_gmm_bwd").moe_gmm_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    """Raise on operands the kernels do not take."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] or \
            group_sizes.shape != (w.shape[0],):
        raise ValueError(f"x {tuple(x.shape)} must be (T, K), w "
                         f"{tuple(w.shape)} (E, K, N) and group_sizes "
                         f"{tuple(group_sizes.shape)} (E,)")
    if w.dtype != x.dtype:
        raise TypeError(f"w ({w.dtype}) must share x's dtype ({x.dtype})")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    E, K, N = w.shape
    if not 1 <= E <= MAX_EXPERTS or K % 8 or N % 8 or -(-N // BN) > 65535:
        raise ValueError(f"E={E} must be in [1, {MAX_EXPERTS}], K={K} and "
                         f"N={N} multiples of 8 (16-byte row loads), "
                         f"N <= {65535 * BN}")


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, K) float32 or bfloat16; w: (E, K, N) in x's dtype;
    group_sizes: (E,) int32, summing to at most T. Returns (T, N) in
    x.dtype. Differentiable in x and w (``MoeGmmFn``) where autograd
    asks."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmmFn.apply(x, w, group_sizes)
    if not x.is_cuda:
        return moe_gmm_plain(x, w, group_sizes)
    _check(x, w, group_sizes)
    T, K = x.shape
    E, _, N = w.shape
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    build.check_operands(x.device, x=x, w=w, out=out, group_sizes=group_sizes)
    if T == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                     out.data_ptr(), T, K, N, E, build.dtype_code(x), stream)
    build.check_launch("moe_gmm", rc)
    build.count_launch(moe_gmm)
    return out


moe_gmm.launches = 0
moe_gmm.kernel = "K4"  # its bodies: build.BODIES


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                dout: torch.Tensor, *, need_dx: bool = True,
                need_dw: bool = True):
    """The gradients (dx, dw) of ``moe_gmm`` for the output's gradient
    ``dout`` (T, N) in x's dtype: dx (T, K), zero in rows no group covers,
    and dw (E, K, N), zero for an empty group; either is None where its
    ``need_`` flag is False. On the card one call of the backward
    launcher: the dX kernel, the dW kernel or both (no atomics, so a
    backward repeats bit for bit; the group sizes stay on the card); on
    the CPU ``ref.moe_gmm_bwd``."""
    if not x.is_cuda:
        return moe_gmm_bwd_plain(x, w, group_sizes, dout, need_dx=need_dx,
                                 need_dw=need_dw)
    _check(x, w, group_sizes)
    T, K = x.shape
    E, _, N = w.shape
    if dout.shape != (T, N) or dout.dtype != x.dtype:
        raise ValueError(f"dout must be {x.dtype} {(T, N)}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    if K == 0 or N == 0 or E * -(-K // DW_ROWS) > 65535:
        raise ValueError(f"K={K} and N={N} must be positive and E={E} x "
                         f"ceil(K / {DW_ROWS}) dW tiles at most 65535")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    operands = dict(x=x, w=w, group_sizes=group_sizes, dout=dout)
    operands.update({k: t for k, t in (("dx", dx), ("dw", dw)) if t is not None})
    build.check_operands(x.device, **operands)
    if not (need_dx or need_dw):
        return dx, dw
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _bwd_launcher()(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                         dout.data_ptr(), ptr(dx), ptr(dw), T, K, N, E,
                         build.dtype_code(x), stream)
    build.check_launch("moe_gmm_bwd", rc)
    build.count_launch(moe_gmm_bwd)
    return dx, dw


moe_gmm_bwd.launches = 0
moe_gmm_bwd.kernel = "K4 bwd"  # its bodies: build.BODIES


class MoeGmmFn(torch.autograd.Function):
    """K4 under autograd: the forward kernel, and the backward kernels for
    the gradients of x and w, each skipped where autograd needs none (the
    plain versions of both on CPU tensors). Saves x, w and the group
    sizes; group_sizes gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        out = moe_gmm(x, w, group_sizes)     # grad is off in here
        ctx.save_for_backward(x, w, group_sizes)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, group_sizes = ctx.saved_tensors
        need_dx, need_dw, _ = ctx.needs_input_grad
        dx, dw = moe_gmm_bwd(x, w, group_sizes, dout.contiguous(),
                             need_dx=need_dx, need_dw=need_dw)
        return dx, dw, None
