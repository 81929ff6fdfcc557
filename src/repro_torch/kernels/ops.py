"""Kernel entry points with implementation dispatch (mirrors
``repro.kernels.ops``).

``impl``:
  * ``None`` — the kernel wrapper: the hand-written CUDA kernel for a CUDA
    tensor, its plain PyTorch version for a CPU tensor.
  * ``"ref"`` — the plain PyTorch version explicitly, on any device (the
    counterpart of the JAX ``impl="ref"``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rs


def _use_ref(impl: Optional[str]) -> bool:
    if impl not in (None, "ref"):
        raise ValueError(f"impl must be None or 'ref', got {impl!r}")
    return impl == "ref"


def flash_attention(q, k, v, *, causal=True, window=0, chunk=0,
                    softmax_scale=None, impl: Optional[str] = None):
    if _use_ref(impl):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk, softmax_scale=softmax_scale)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              chunk=chunk, softmax_scale=softmax_scale)


def decode_attention(q, k, v, kv_len, *, softmax_scale=None, k_scale=None,
                     v_scale=None, return_lse=False,
                     impl: Optional[str] = None):
    """Single-step attention over a dense per-slot cache (ring caches of
    local/chunked attention, and the dense serving layout); with
    ``return_lse`` also each row's log-sum-exp (B, H) float32."""
    if _use_ref(impl):
        return ref.decode_attention(q, k, v, kv_len,
                                    softmax_scale=softmax_scale,
                                    k_scale=k_scale, v_scale=v_scale,
                                    return_lse=return_lse)
    return da.decode_attention(q, k, v, kv_len, softmax_scale=softmax_scale,
                               k_scale=k_scale, v_scale=v_scale,
                               return_lse=return_lse)


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           softmax_scale=None, impl: Optional[str] = None):
    """Single-step attention through per-sequence block tables (the paged
    serving engine's decode hot path)."""
    if _use_ref(impl):
        return ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          kv_len, softmax_scale=softmax_scale)
    return pa.paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len,
                                     softmax_scale=softmax_scale)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, kv_len,
                            q_offset, *, softmax_scale=None,
                            impl: Optional[str] = None):
    """Chunked-prefill attention through block tables (chunk K/V already
    scattered into the pool before the call)."""
    if _use_ref(impl):
        return ref.paged_prefill_attention(q, k_pool, v_pool, block_tables,
                                           kv_len, q_offset,
                                           softmax_scale=softmax_scale)
    return pa.paged_prefill_attention(q, k_pool, v_pool, block_tables,
                                      kv_len, q_offset,
                                      softmax_scale=softmax_scale)


def rglru_scan(a, b, h0=None, *, impl: Optional[str] = None):
    """The RG-LRU recurrence h_t = a_t * h_{t-1} + b_t, float32 out."""
    if _use_ref(impl):
        return ref.rglru_scan(a, b, h0)
    return rs.rglru_scan(a, b, h0)


def moe_gmm(x, w, group_sizes, *, impl: Optional[str] = None):
    """Grouped (expert) matmul, ``ragged_dot`` semantics: rows of x sorted
    by expert, x.dtype out."""
    if _use_ref(impl):
        return ref.moe_gmm(x, w, group_sizes)
    return gm.moe_gmm(x, w, group_sizes)
