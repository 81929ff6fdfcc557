"""K1: paged attention — the port of the Pallas ``_paged_kernel``
(``src/repro/kernels/decode_attention.py:135``).

Wrappers for the serving engine's decode step (``paged_decode_attention``,
one query token per sequence) and chunked-prefill step
(``paged_prefill_attention``). For a CUDA tensor each launches the
hand-written kernel in ``csrc/paged_attention.cu`` on the current stream
and counts the launch (one query token per sequence takes the split-KV
body of ``csrc/decode_common.cuh``, shared with K3, and its merge; a
chunk the tiled body); for a CPU tensor it runs the plain PyTorch version
below. There is no fallback: a CUDA operand the kernel does not take, or a
failed build or launch, raises. An int8 pool (``model.paged_cache_specs(...,
kv_dtype="int8")``) is read as its integer values, unit scales, as the
reference's body upcasts it, with bf16 or float32 queries: decode through
the split body's int8 FMA instance, bf16 chunks through the tensor-core
body staging int8 tiles and widening them in shared memory, float32 chunks
through the tiled body with an int8 load; any other mix of dtypes raises.
K1 has no backward kernel: on the card,
under autograd with an operand that requires grad, both wrappers raise
``NotImplementedError`` (``build.refuse_grad``) rather than return an
output that cuts the gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as da

# plain PyTorch versions of the same functions (the CPU path, and what the
# kernel is held against on the card)
paged_decode_plain = ref.paged_decode_attention
paged_prefill_plain = ref.paged_prefill_attention


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, block_tables, kv_len, q_offset,
            softmax_scale: Optional[float]) -> torch.Tensor:
    """Launch K1; ``q_offset`` None means decode (C == 1, the causal limit
    is kv_len)."""
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, C, H, hd) and the "
                         f"pools (num_pages, page, KV, hd), got k "
                         f"{tuple(k_pool.shape)}, v {tuple(v_pool.shape)}")
    B, C, H, hd = q.shape
    _, page, KV, hd_k = k_pool.shape
    if hd_k != hd or hd not in build.HEAD_DIMS or H % KV:
        raise ValueError(f"head_dim {hd} (pool {hd_k}) must be one of "
                         f"{build.HEAD_DIMS} and H={H} a multiple of KV={KV}")
    kv_int8 = k_pool.dtype == torch.int8
    if v_pool.dtype != k_pool.dtype or not (kv_int8 or k_pool.dtype == q.dtype):
        raise TypeError(f"the pools must share q's dtype {q.dtype} or be int8, "
                        f"got {k_pool.dtype} and {v_pool.dtype}")
    if q_offset is None and C != 1:
        raise ValueError("a chunk (C > 1) needs q_offset")
    for name, t, shape in (("block_tables", block_tables, (B, None)),
                           ("kv_len", kv_len, (B,)),
                           ("q_offset", q_offset, (B,))):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != len(shape) or t.shape[0] != B:
            raise ValueError(f"{name} must be int32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    P = block_tables.shape[1]
    out = torch.empty_like(q)
    operands = dict(q=q, k_pool=k_pool, v_pool=v_pool,
                    block_tables=block_tables, kv_len=kv_len, out=out)
    if q_offset is not None:
        operands["q_offset"] = q_offset
    build.check_operands(q.device, **operands)
    n_split = da.split_plan(B, KV, H // KV, P * page,
                            build.sm_count(q.device.index)) if C == 1 else 1
    ws = da.workspace(q, n_split)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), kv_len.data_ptr(),
                     q_offset.data_ptr() if q_offset is not None else None,
                     out.data_ptr(), ws.data_ptr() if ws is not None else None,
                     B, C, H, KV, hd, P, page, n_split, scale,
                     build.dtype_code(q), int(kv_int8), stream)
    build.check_launch("paged_attention", rc)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           softmax_scale: Optional[float] = None):
    """One query token per sequence against a paged KV pool.

    q: (B, 1, H, hd) float32 or bfloat16; pools: (num_pages, page, KV, hd)
    in q's dtype or int8; block_tables: (B, P) int32 physical page ids
    (0 = reserved scratch page); kv_len: (B,) int32.
    """
    if not q.is_cuda:
        return paged_decode_plain(q, k_pool, v_pool, block_tables, kv_len,
                                  softmax_scale=softmax_scale)
    build.refuse_grad("paged_decode_attention (K1)", q, k_pool, v_pool)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode takes q of shape (B, 1, H, hd), got {tuple(q.shape)}")
    out = _launch(q, k_pool, v_pool, block_tables, kv_len, None,
                  softmax_scale)
    build.count_launch(paged_decode_attention)
    return out


def paged_prefill_attention(q, k_pool, v_pool, block_tables, kv_len,
                            q_offset, *, softmax_scale: Optional[float] = None):
    """Chunked-prefill attention against a paged pool: q (B, C, H, hd) at
    positions ``q_offset + [0, C)``, the chunk's own K/V already scattered
    into the pool, so ``kv_len = q_offset + C``."""
    if not q.is_cuda:
        return paged_prefill_plain(q, k_pool, v_pool, block_tables, kv_len,
                                   q_offset, softmax_scale=softmax_scale)
    build.refuse_grad("paged_prefill_attention (K1)", q, k_pool, v_pool)
    out = _launch(q, k_pool, v_pool, block_tables, kv_len, q_offset,
                  softmax_scale)
    build.count_launch(paged_prefill_attention)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.kernel = "K1"  # its bodies: build.BODIES
paged_prefill_attention.launches = 0
paged_prefill_attention.kernel = "K1"  # its bodies: build.BODIES
