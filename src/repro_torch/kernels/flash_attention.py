"""K2: flash attention — the port of the Pallas ``_attn_kernel``
(``src/repro/kernels/flash_attention.py:27``).

Whole-prompt prefill attention: GQA, queries are the last ``Sq`` of ``Skv``
positions, masks causal / sliding ``window`` / same-``chunk`` / none. For a
CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` on the current stream and counts the launch
(bf16 on the tensor cores, float32 with exact FMA on the CUDA cores);
for a CPU tensor it runs the plain PyTorch version. There is no fallback:
a CUDA operand the kernel does not take, or a failed build or launch,
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch version (the CPU path, and the kernel's yardstick)
flash_attention_plain = ref.flash_attention


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd)
    in q.dtype."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk, softmax_scale=softmax_scale)
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
    out = torch.empty_like(q)
    build.check_operands(q.device, q=q, k=k, v=v, out=out)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Sq, Skv, H, KV, hd, int(causal), int(window),
                     int(chunk), scale, build.dtype_code(q), stream)
    build.check_launch("flash_attention", rc)
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
flash_attention.kernel = "K2"  # its bodies: build.BODIES
