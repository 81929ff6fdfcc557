"""K4: the grouped (expert) matmul — the port of the Pallas ``_gmm_kernel``
(``src/repro/kernels/moe_gmm.py:26``).

``jax.lax.ragged_dot`` semantics: rows of x (T, K) are sorted by expert,
the ``group_sizes[e]`` rows of expert e multiply w[e] (K, N), products
accumulate in float32, and the output (T, N) is ``x.dtype``; rows past the
last group are zero. For a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/moe_gmm.cu`` on the current stream and
counts the launch; the group sizes stay on the card (the host never reads
them). For a CPU tensor it runs the plain PyTorch version. There is no
fallback: a CUDA operand the kernel does not take, or a failed build or
launch, raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch version (the CPU path, and what the kernel is held
# against on the card)
moe_gmm_plain = ref.moe_gmm

BN = 64              # the kernel's column tile (grid.y = ceil(N / BN))
MAX_EXPERTS = 256    # group offsets live in one block's shared memory


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("moe_gmm").moe_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, K) float32 or bfloat16; w: (E, K, N) in x's dtype;
    group_sizes: (E,) int32, summing to at most T. Returns (T, N) in
    x.dtype."""
    if not x.is_cuda:
        return moe_gmm_plain(x, w, group_sizes)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] or \
            group_sizes.shape != (w.shape[0],):
        raise ValueError(f"x {tuple(x.shape)} must be (T, K), w "
                         f"{tuple(w.shape)} (E, K, N) and group_sizes "
                         f"{tuple(group_sizes.shape)} (E,)")
    if w.dtype != x.dtype:
        raise TypeError(f"w ({w.dtype}) must share x's dtype ({x.dtype})")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    T, K = x.shape
    E, _, N = w.shape
    if not 1 <= E <= MAX_EXPERTS or K % 8 or N % 8 or -(-N // BN) > 65535:
        raise ValueError(f"E={E} must be in [1, {MAX_EXPERTS}], K={K} and "
                         f"N={N} multiples of 8 (16-byte row loads), "
                         f"N <= {65535 * BN}")
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    build.check_operands(x.device, x=x, w=w, out=out, group_sizes=group_sizes)
    if T == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                     out.data_ptr(), T, K, N, E, build.dtype_code(x), stream)
    build.check_launch("moe_gmm", rc)
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
