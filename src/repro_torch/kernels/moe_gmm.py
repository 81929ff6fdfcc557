"""K4: the grouped (expert) matmul — the port of the Pallas ``_gmm_kernel``
(``src/repro/kernels/moe_gmm.py:26``), forward and backward.

``jax.lax.ragged_dot`` semantics: rows of x (T, K) are sorted by expert,
the ``group_sizes[e]`` rows of expert e multiply w[e] (K, N), products
accumulate in float32, and the output (T, N) is ``x.dtype``; rows past the
last group are zero. For a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/moe_gmm.cu`` on the current stream and
counts the launch (bf16 on the tensor cores: the persistent wgmma body or
the mma.sync body, as ``forward_body`` picks by shape; float32 with exact
FMA on the CUDA cores); the group sizes stay on the card (the host never reads
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

FakeTensor operands take the shape-only path (``build.is_fake``), forward
and backward: the checks, the outputs, the cost recorded (``cost``,
``bwd_cost``), no launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch versions (the CPU path, and what the kernels are held
# against on the card)
moe_gmm_plain = ref.moe_gmm
moe_gmm_bwd_plain = ref.moe_gmm_bwd

BN = 64              # the float32 kernel's column tile (grid.y = ceil(N / BN);
                     # bf16's is 256, so its grid.y is smaller)
MAX_EXPERTS = 256    # group offsets live in one block's shared memory
DW_ROWS = 64         # the float32 dW kernel's K tile: grid.y = E * ceil(K / DW_ROWS)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("moe_gmm").moe_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("moe_gmm_bwd").moe_gmm_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------
# the forward's bodies and launch geometry (csrc/moe_gmm.cu), which the
# wrapper passes to the launcher and the launcher checks against its build
# ----------------------------------------------------------------------
# bf16 has two bodies: "wgmma" (moe_gmm_wgmma_kernel: persistent, one block
# an SM, a TMA producer warpgroup and two wgmma consumers on tiles of
# FWD_ROWS rows of one expert x W_COLS columns) and "mma"
# (moe_gmm_mma_kernel: a grid of 64-row tiles on mma.sync); float32 runs
# "fma" (moe_gmm_kernel).
FWD_ROWS = 128        # the wgmma forward's rows of one expert a tile
WGMMA_MIN_ROWS = 64   # rows T from which bf16 runs the wgmma body
FWD_KERNELS = {"wgmma": "moe_gmm_wgmma_kernel", "mma": "moe_gmm_mma_kernel",
               "fma": "moe_gmm_kernel"}


def forward_body(dtype, T: int, K: int, N: int) -> str:
    """The body the forward runs for these shapes (``FWD_KERNELS``): float32
    "fma"; bf16 "wgmma" from ``WGMMA_MIN_ROWS`` rows on (prefill, training),
    "mma" below (decode) or where K is 0 (the rule csrc/moe_gmm.cu's
    header states). Shapes alone decide: never a failed build or launch,
    and never the group sizes, which stay on the card."""
    if dtype != torch.bfloat16:
        return "fma"
    return "wgmma" if T >= WGMMA_MIN_ROWS and K > 0 else "mma"


def forward_kernel(x, w) -> str:
    """The device kernel K4's forward launches for operands x and w."""
    return FWD_KERNELS[forward_body(x.dtype, x.shape[0], x.shape[1], w.shape[2])]


def fwd_smem_bytes() -> int:
    """Dynamic shared memory bytes of the wgmma forward (FwdLayout): the
    ring of x and w stages, the two consumers' epilogue tiles, the scanned
    group offsets, the barriers and 1024 bytes to align the base."""
    stage = (FWD_ROWS + W_COLS) * W_DEPTH * 2
    return W_STAGES * stage + 2 * 64 * (W_COLS + 8) * 2 + MAX_EXPERTS * (8 + 4) + \
        2 * W_STAGES * 8 + 1024


def expert_tiles(group_sizes, T: int, cols: int, rows: int = FWD_ROWS):
    """A persistent wgmma body's static tile order (moe_common.cuh
    expert_tile): [(expert, column tile of ``cols``, first row, rows)],
    experts slowest, then column tiles of W_COLS, then the expert's row
    tiles of ``rows`` (so the tiles that read one slab of w[e] are
    adjacent); tiles past T have rows <= 0 and compute nothing."""
    n_ct, out, start = -(-cols // W_COLS), [], 0
    for e, g in enumerate(group_sizes):
        g = min(max(int(g), 0), T)
        for c in range(n_ct):
            for m in range(-(-g // rows)):
                row0 = start + m * rows
                out.append((e, c, row0, min(rows, min(start + g, T) - row0)))
        start += g
    return out


def fwd_uncovered(group_sizes, T: int) -> range:
    """The rows no group covers, which the wgmma forward's producer warps
    zero: from the groups' end (clamped to T) to T."""
    return range(min(sum(min(max(int(g), 0), T) for g in group_sizes), T), T)


# ----------------------------------------------------------------------
# the backward's launch geometry (csrc/moe_gmm_bwd.cu), which the wrapper
# passes to the launcher and the launcher checks against its build
# ----------------------------------------------------------------------
# bf16 runs the wgmma body (persistent, warp-specialised: a TMA producer
# warpgroup, two wgmma consumer warpgroups), float32 its FMA body (a grid
# of tiles).
W_STAGES = 3       # the wgmma body's ring
W_DEPTH = 64       # reduction a stage
W_COLS = 256       # output columns a tile (dX: of K, dW: of N)
DX_ROWS = 128      # dX: rows of one expert a tile (64 a consumer warpgroup)
DW_KROWS = 128     # dW: rows of K a tile (64 a consumer warpgroup)
SMEM_LIMIT = 232448   # bytes of shared memory a block may take on the H100


def check_strides(K: int, N: int, dtype) -> None:
    """Raise unless K and N are multiples of 8: the rows of x (K), w and
    dout (N) are then whole 16-byte units in bf16, which TMA's strides and
    the other bodies' 16-byte loads need (the float32 bodies' too). No
    fallback."""
    for name, n in (("K", K), ("N", N)):
        if n % 8:
            raise ValueError(f"{name}={n} must be a multiple of 8: a {dtype} row of "
                             f"{n} is not a whole number of 16-byte units")


def wgmma_smem_bytes():
    """(dX, dW) dynamic shared memory bytes of the wgmma body (DxLayout,
    DwLayout): the ring, the two consumers' epilogue tiles, the scanned
    group offsets, the barriers and 1024 bytes to align the base."""
    scan, bars = MAX_EXPERTS * (8 + 4), 2 * W_STAGES * 8 + 1024
    dx_stage = (DX_ROWS + W_COLS) * W_DEPTH * 2
    dx = W_STAGES * dx_stage + 2 * 64 * (W_COLS + 8) * 2 + scan + bars
    dw_stage = (DW_KROWS + W_COLS) * W_DEPTH * 2
    dw = W_STAGES * dw_stage + 2 * 64 * W_COLS * 2 + scan + bars
    return dx, dw


def dx_tiles(group_sizes, T: int, K: int):
    """The wgmma dX kernel's static tile order: ``expert_tiles`` over K's
    columns in row tiles of DX_ROWS."""
    return expert_tiles(group_sizes, T, K, DX_ROWS)


def dw_tiles(E: int, K: int, N: int):
    """The wgmma dW kernel's static tile order: [(expert, K tile of
    DW_KROWS, N tile of W_COLS)], experts slowest, N tiles fastest."""
    return [(e, kt, nt) for e in range(E) for kt in range(-(-K // DW_KROWS))
            for nt in range(-(-N // W_COLS))]


def cost(x, w, group_sizes, out):
    """(FLOPs, HBM bytes) of one forward call: x, the used experts' W and
    the group sizes read once, the output written once; every row's
    product. Fake group sizes hold no values: every row is counted in a
    group and min(E, T) experts as used (the most the call can read)."""
    T, K = x.shape
    E, _, N = w.shape
    used = min(E, T)
    return 2 * T * K * N, \
        build.nbytes(x, out, group_sizes) + used * K * N * w.element_size()


def bwd_cost(x, w, group_sizes, dout, need_dx: bool, need_dw: bool):
    """(FLOPs, HBM bytes) of one backward call, as ``cost``: dX reads dY
    and the used experts' W and writes dX; dW reads X and dY and writes
    every expert's dW; each a product of every row."""
    T, K = x.shape
    E, _, N = w.shape
    isz, flops, n_bytes = x.element_size(), 0, 0
    if need_dx:
        flops += 2 * T * K * N
        n_bytes += isz * (T * N + min(E, T) * K * N + T * K) + build.nbytes(group_sizes)
    if need_dw:
        flops += 2 * T * K * N
        n_bytes += isz * (T * K + T * N + E * K * N) + build.nbytes(group_sizes)
    return flops, n_bytes


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
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"E={E} must be in [1, {MAX_EXPERTS}]")
    check_strides(K, N, x.dtype)


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, K) float32 or bfloat16; w: (E, K, N) in x's dtype;
    group_sizes: (E,) int32, summing to at most T. Returns (T, N) in
    x.dtype. Differentiable in x and w (``MoeGmmFn``) where autograd
    asks."""
    build.refuse_dtensor("moe_gmm", x, w, group_sizes)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmmFn.apply(x, w, group_sizes)
    fake = build.is_fake(x, w, group_sizes)
    if not x.is_cuda and not fake:
        return moe_gmm_plain(x, w, group_sizes)
    return _forward(x, w, group_sizes)


def _forward(x, w, group_sizes, body: Optional[str] = None) -> torch.Tensor:
    """One launch of the forward kernel. ``body`` names a bf16 body to run
    ("wgmma" or "mma"; a measurement's choice), else ``forward_body``
    picks it."""
    _check(x, w, group_sizes)
    T, K = x.shape
    E, _, N = w.shape
    body = body or forward_body(x.dtype, T, K, N)
    if (body == "fma") != (x.dtype != torch.bfloat16) or body not in FWD_KERNELS:
        raise ValueError(f"no {body!r} body for {x.dtype}")
    if -(-N // BN) > 65535:
        raise ValueError(f"N={N} must be at most {65535 * BN}")
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    build.check_operands(x.device, x=x, w=w, out=out, group_sizes=group_sizes)
    if T == 0 or N == 0:
        return out
    if build.is_fake(x, w, group_sizes):
        build.record_cost(moe_gmm, *cost(x, w, group_sizes, out))
        return out
    geo = (build.sm_count(x.device.index), fwd_smem_bytes()) if body == "wgmma" else (0, 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                     out.data_ptr(), T, K, N, E, build.dtype_code(x), *geo, stream)
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
    build.refuse_dtensor("moe_gmm_bwd", x, w, group_sizes, dout)
    fake = build.is_fake(x, w, group_sizes, dout)
    if not x.is_cuda and not fake:
        return moe_gmm_bwd_plain(x, w, group_sizes, dout, need_dx=need_dx,
                                 need_dw=need_dw)
    _check(x, w, group_sizes)
    T, K = x.shape
    E, _, N = w.shape
    if dout.shape != (T, N) or dout.dtype != x.dtype:
        raise ValueError(f"dout must be {x.dtype} {(T, N)}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    if K == 0 or N == 0:
        raise ValueError(f"K={K} and N={N} must be positive")
    if x.dtype == torch.float32 and E * -(-K // DW_ROWS) > 65535:
        raise ValueError(f"float32: E={E} x ceil(K / {DW_ROWS}) dW tiles must be "
                         f"at most 65535")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    operands = dict(x=x, w=w, group_sizes=group_sizes, dout=dout)
    operands.update({k: t for k, t in (("dx", dx), ("dw", dw)) if t is not None})
    build.check_operands(x.device, **operands)
    if not (need_dx or need_dw):
        return dx, dw
    if fake:
        build.record_cost(moe_gmm_bwd, *bwd_cost(x, w, group_sizes, dout, need_dx,
                                                 need_dw))
        return dx, dw
    geo = (build.sm_count(x.device.index), *wgmma_smem_bytes())   # one block an SM
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _bwd_launcher()(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                         dout.data_ptr(), ptr(dx), ptr(dw), T, K, N, E,
                         build.dtype_code(x), *geo, stream)
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
