"""K3: decode attention over a dense per-slot cache — the port of the
Pallas ``_decode_kernel`` (``src/repro/kernels/decode_attention.py:31``).

One query token per sequence against k, v (B, S, KV, hd) of which the
first ``kv_len[b]`` slots are valid: recurrentgemma's sliding-window ring
caches and the dense per-slot layout (``page_size=0``). An int8 cache takes
(B, KV) float32 ``k_scale`` / ``v_scale``; a scale that is not given is
1.0, as the reference's ``decode_attention`` defaults both to ones (the
model's int8 caches pass none). The kernel reads a null scale as 1.0, which
is the product by a ones tensor. For a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/decode_attention.cu`` (the
split-KV body of ``csrc/decode_common.cuh`` and, with more than one split,
its merge) on the current stream and counts the launch; for a CPU tensor it
runs the plain PyTorch version. There is no fallback: a CUDA operand the
kernel does not take, or a failed build or launch, raises. K3 has no
backward kernel: on the card, under autograd with an operand that requires
grad, the wrapper raises ``NotImplementedError`` (``build.refuse_grad``).

``split_plan`` fixes the number of key splits from shapes alone, and the
kernel reads ``kv_len`` on the device, so neither wrapper of the split body
(this one and K1's decode) reads ``kv_len`` on the host: the call can be
captured in a CUDA graph.

A row's ``kv_len`` may be 0: it reads no key and its output is 0. With
``return_lse=True`` the wrapper also returns each row's log-sum-exp of
its scaled scores, (B, H) float32 in natural log (-inf for a row with no
key), written by the same kernels as the output, which is bit for bit
that of the call without it. Under a mesh a rank holds one range of a
cache's slots (``models/blocks.py``, the sequence-split cache): each rank
runs K3 on its range and the ranks merge their outputs by these weights.

FakeTensor operands take the shape-only path (``build.is_fake``): the
checks, the outputs and the split workspace, the cost recorded
(``cost``), no launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# the plain PyTorch version (the CPU path, and what the kernel is held
# against on the card)
decode_attention_plain = ref.decode_attention

ROWS_PER_GROUP = 16  # query heads per block (one m16 row group)


def split_plan(B: int, KV: int, G: int, capacity: int, n_sm: int) -> int:
    """Key splits per (sequence, kv head, row group) of the split-KV decode
    body: enough blocks for about two per SM, and never more splits than
    64-key tiles in the cache's ``capacity``. Shapes only, never kv_len, so
    the grid is the same for every call at these shapes."""
    blocks = B * KV * -(-G // ROWS_PER_GROUP)
    want = -(-2 * n_sm // blocks)
    return max(1, min(want, -(-capacity // ref.SPLIT_KEYS)))


def workspace(q: torch.Tensor, n_split: int) -> Optional[torch.Tensor]:
    """The float32 partials (acc, m, l) of ``n_split`` splits of every query
    head, or None with one split (the body then writes out directly)."""
    if n_split == 1:
        return None
    B, _, H, hd = q.shape
    return torch.empty(n_split * B * H * (hd + 2), dtype=torch.float32,
                       device=q.device)


def cost(q, k, v, kv_len, out, *extra):
    """(FLOPs, HBM bytes) of one call: every operand read once and the
    outputs written once, and the scores and weighted sum of every slot of
    the cache (a fake ``kv_len`` holds no lengths, so a full cache is
    counted: the most the call can read)."""
    B, _, H, hd = q.shape
    return 4 * B * H * k.shape[1] * hd, build.nbytes(q, k, v, kv_len, out, *extra)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     softmax_scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     return_lse: bool = False):
    """q: (B, 1, H, hd) float32 or bfloat16; k, v: (B, S, KV, hd) in q's
    dtype or int8 (scales optional, 1.0 where None); kv_len: (B,) int32 in
    [0, S] (a row of 0 reads no key: output 0). Returns (B, 1, H, hd) in
    q.dtype, and with ``return_lse`` (out, lse), lse (B, H) float32 in
    natural log (-inf for a row of kv_len 0)."""
    build.refuse_dtensor("decode_attention", q, k, v, kv_len)
    fake = build.is_fake(q, k, v, kv_len)
    if not q.is_cuda and not fake:
        return decode_attention_plain(q, k, v, kv_len,
                                      softmax_scale=softmax_scale,
                                      k_scale=k_scale, v_scale=v_scale,
                                      return_lse=return_lse)
    build.refuse_grad("decode_attention (K3)", q, k, v)
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or \
            k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} must be (B, 1, H, hd) and k, v "
                         f"(B, S, KV, hd), got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, _, H, hd = q.shape
    _, S, KV, hd_k = k.shape
    if hd_k != hd or hd not in build.HEAD_DIMS or H % KV:
        raise ValueError(f"head_dim {hd} (cache {hd_k}) must be one of "
                         f"{build.HEAD_DIMS} and H={H} a multiple of KV={KV}")
    if S == 0:
        raise ValueError("decode_attention needs a cache of at least one slot")
    kv_int8 = k.dtype == torch.int8
    if v.dtype != k.dtype or not (kv_int8 or k.dtype == q.dtype):
        raise TypeError(f"k and v must share q's dtype {q.dtype} or be int8, "
                        f"got {k.dtype} and {v.dtype}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (B, KV)):
            raise ValueError(f"{name} must be float32 of shape {(B, KV)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"kv_len must be int32 of shape {(B,)}, got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    operands = dict(q=q, k=k, v=v, kv_len=kv_len, out=out)
    operands.update({n: t for n, t in (("k_scale", k_scale),
                                        ("v_scale", v_scale)) if t is not None})
    build.check_operands(q.device, **operands)
    n_split = split_plan(B, KV, H // KV, S, build.n_sms(q))
    ws = workspace(q, n_split)
    if fake:
        build.record_cost(decode_attention, *cost(q, k, v, kv_len, out, k_scale,
                                                  v_scale, lse))
        return (out, lse) if return_lse else out
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     kv_len.data_ptr(),
                     k_scale.data_ptr() if k_scale is not None else None,
                     v_scale.data_ptr() if v_scale is not None else None,
                     out.data_ptr(), ws.data_ptr() if ws is not None else None,
                     lse.data_ptr() if lse is not None else None,
                     B, S, H, KV, hd, n_split, scale,
                     build.dtype_code(q), int(kv_int8), stream)
    build.check_launch("decode_attention", rc)
    build.count_launch(decode_attention)
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.kernel = "K3"  # its bodies: build.BODIES
