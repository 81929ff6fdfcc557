"""K2: flash attention — the port of the Pallas ``_attn_kernel``
(``src/repro/kernels/flash_attention.py:27``), forward and backward.

Whole-prompt prefill attention: GQA, queries are the last ``Sq`` of ``Skv``
positions, masks causal / sliding ``window`` / same-``chunk`` / none. For a
CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` on the current stream and counts the launch
(bf16 on the tensor cores, float32 with exact FMA on the CUDA cores);
for a CPU tensor it runs the plain PyTorch version. There is no fallback:
a CUDA operand the kernel does not take, or a failed build or launch,
raises.

Under autograd (grad enabled and an operand that requires grad) the
wrapper goes through ``FlashAttentionFn``: its forward is the same kernel
with the per-row log-sum-exp stored beside the output, its backward the
kernel of ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``, the
counterpart of the gradient the reference takes through its XLA path,
``ops.flash_attention(impl="xla")``; the Pallas kernel has no VJP). On CPU
tensors the Function runs the plain forward and ``ref.flash_attention_bwd``,
the formula the kernel implements.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch versions (the CPU path, and the kernels' yardsticks)
flash_attention_plain = ref.flash_attention
flash_attention_bwd_plain = ref.flash_attention_bwd


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v, window: int, chunk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, H, hd) and k, v "
                         f"(B, Skv, KV, hd), got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, hd_k = k.shape
    if hd_k != hd or hd not in build.HEAD_DIMS or H % KV:
        raise ValueError(f"head_dim {hd} (k {hd_k}) must be one of "
                         f"{build.HEAD_DIMS} and H={H} a multiple of KV={KV}")
    if Skv == 0 or Sq == 0:
        raise ValueError("flash_attention needs at least one query and key")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("q, k and v must share one dtype")
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")


def _forward(q, k, v, causal, window, chunk, softmax_scale, with_lse: bool):
    """One launch of the forward kernel; (out, lse or None)."""
    _check_shapes(q, k, v, window, chunk)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    build.check_operands(q.device, q=q, k=k, v=v, out=out)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     B, Sq, Skv, H, KV, hd, int(causal), int(window),
                     int(chunk), scale, build.dtype_code(q), stream)
    build.check_launch("flash_attention", rc)
    build.count_launch(flash_attention)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd)
    in q.dtype. Differentiable (``FlashAttentionFn``) where autograd asks."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, chunk,
                                      softmax_scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk, softmax_scale=softmax_scale)
    return _forward(q, k, v, causal, window, chunk, softmax_scale, False)[0]


flash_attention.launches = 0
flash_attention.kernel = "K2"  # its bodies: build.BODIES


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, chunk: int = 0,
                        softmax_scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of ``flash_attention`` from its output
    ``out``, its log-sum-exp ``lse`` (B, H, Sq) float32 and the output's
    gradient ``dout``, in the operands' dtype. On the card one launch of
    the backward kernel (a dQ pass that also stores D = rowsum(dout * out),
    then a dK/dV pass; no atomics, so a backward repeats bit for bit); on
    the CPU ``ref.flash_attention_bwd``."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         chunk=chunk,
                                         softmax_scale=softmax_scale)
    _check_shapes(q, k, v, window, chunk)
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype} {tuple(q.shape)}, "
                         f"got {out.dtype} {tuple(out.shape)} and "
                         f"{dout.dtype} {tuple(dout.shape)}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    build.check_operands(q.device, q=q, k=k, v=v, out=out, dout=dout, lse=lse,
                         delta=delta, dq=dq, dk=dk, dv=dv)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), B, Sq, Skv, H, KV, hd, int(causal),
                         int(window), int(chunk), scale, build.dtype_code(q),
                         stream)
    build.check_launch("flash_attention_bwd", rc)
    build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.kernel = "K2 bwd"  # its bodies: build.BODIES


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd: the forward kernel with its log-sum-exp, the
    backward kernel for the gradients (the plain versions of both on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, softmax_scale):
        if q.is_cuda:
            out, lse = _forward(q, k, v, causal, window, chunk, softmax_scale,
                                True)
        else:
            out, lse = flash_attention_plain(
                q, k, v, causal=causal, window=window, chunk=chunk,
                softmax_scale=softmax_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, chunk=chunk,
                        softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
