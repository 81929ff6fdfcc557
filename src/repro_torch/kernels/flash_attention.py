"""K2: flash attention — the port of the Pallas ``_attn_kernel``
(``src/repro/kernels/flash_attention.py:27``), forward and backward.

Whole-prompt prefill attention: GQA, queries are the last ``Sq`` of ``Skv``
positions, masks causal / sliding ``window`` / same-``chunk`` / none. For a
CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` on the current stream and counts the launch
(bf16 on the tensor cores: the warp-specialised wgmma body or the
mma.sync body, as ``forward_body`` picks by shape; float32 with exact
FMA on the CUDA cores);
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

FakeTensor operands take the shape-only path (``build.is_fake``), forward
and backward: the checks, the outputs (the backward's head-group
workspace too), the cost recorded (``cost``, ``bwd_cost``), no launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

# the plain PyTorch versions (the CPU path, and the kernels' yardsticks)
flash_attention_plain = ref.flash_attention
flash_attention_bwd_plain = ref.flash_attention_bwd


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
        [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------
# the forward's bodies and launch geometry (csrc/flash_attention.cu), which
# the wrapper passes to the launcher and the launcher checks against its
# build
# ----------------------------------------------------------------------
# bf16 has two bodies: "wgmma" (flash_attention_wgmma_kernel: a TMA
# producer warpgroup, two or three wgmma consumer warpgroups) and "mma"
# (flash_attention_mma_kernel, prefill_common.cuh's mma.sync body, which
# K1's chunks share); float32 runs "fma" (flash_attention_kernel). The
# wgmma body's tiles (FwdCfg<HD>): consumer warpgroups, query positions a
# block (64 a consumer; at hd 256 both consumers take the same 64 and split
# hd), keys a tile, its ring's stages
FWD_TILES = {
    64: dict(consumers=3, q_rows=192, keys=64, stages=4),
    128: dict(consumers=2, q_rows=128, keys=64, stages=4),
    256: dict(consumers=2, q_rows=64, keys=64, stages=3),
}
FWD_KERNELS = {"wgmma": "flash_attention_wgmma_kernel",
               "mma": "flash_attention_mma_kernel", "fma": "flash_attention_kernel"}


def forward_body(dtype, B: int, Sq: int, Skv: int, H: int, KV: int, hd: int) -> str:
    """The body the forward runs for these shapes (``FWD_KERNELS``): float32
    "fma"; bf16 "wgmma", which measured faster than "mma" at every shape
    timed in one process on the card (the rule csrc/flash_attention.cu's
    header states).
    Shapes alone decide: never a failed build or launch."""
    return "fma" if dtype != torch.bfloat16 else "wgmma"


def forward_kernel(q, k) -> str:
    """The device kernel K2's forward launches for operands q and k."""
    B, Sq, H, hd = q.shape
    return FWD_KERNELS[forward_body(q.dtype, B, Sq, k.shape[1], H, k.shape[2], hd)]


def fwd_smem_bytes(hd: int) -> int:
    """Dynamic shared memory bytes of the wgmma forward (FwdLayout): the
    block's Q, the ring of K and V, the barriers and 1024 bytes to align
    the base."""
    t = FWD_TILES[hd]
    return t["q_rows"] * hd * 2 + t["stages"] * 2 * t["keys"] * hd * 2 + \
        (1 + 2 * t["stages"]) * 8 + 1024


def fwd_blocks(B: int, Sq: int, H: int, hd: int) -> int:
    """Blocks of the wgmma forward's one-dimensional grid."""
    return -(-Sq // FWD_TILES[hd]["q_rows"]) * H * B


def q_block(i: int, B: int, H: int, Sq: int, rows: int, causal: bool):
    """(query block, head, batch) of block ``i`` of a grid of blocks of
    ``rows`` consecutive positions of one head (the forward and the
    backward's dQ pass; wgmma_attention.cuh q_walk): query blocks slowest;
    under a causal mask the last (heaviest) first."""
    n_qb = -(-Sq // rows)
    rank = i // (H * B)
    return (n_qb - 1 - rank if causal else rank), i % H, i // H % B


def q_walk(qb: int, Sq: int, Skv: int, rows: int, keys: int, causal: bool,
           window: int, chunk: int):
    """The key tiles of ``keys`` keys that query block ``qb`` of ``rows``
    positions walks, in order (one interval)."""
    qbase = Skv - Sq
    q_lo, q_hi = qbase + qb * rows, qbase + min(qb * rows + rows, Sq) - 1
    live = [kt for kt in range(-(-Skv // keys))
            if (not causal or kt <= q_hi // keys)
            and tiles_meet(kt * keys, kt * keys + keys - 1, q_lo, q_hi, causal, window, chunk)]
    return list(range(live[0], live[-1] + 1)) if live else []


def fwd_consumer_rows(hd: int):
    """The (first row, rows) of the block each wgmma forward consumer owns:
    64 each, or at hd 256 both the block's 64 (hd split in two)."""
    t = FWD_TILES[hd]
    if t["q_rows"] < 64 * t["consumers"]:
        return [(0, t["q_rows"])] * t["consumers"]
    return [(64 * c, 64) for c in range(t["consumers"])]


# ----------------------------------------------------------------------
# the backward's launch geometry (csrc/flash_attention_bwd.cu), which the
# wrapper passes to the launcher and the launcher checks against its build
# ----------------------------------------------------------------------
# bf16 runs the wgmma body (warp-specialised: a TMA producer warpgroup,
# two wgmma consumer warpgroups), float32 its FMA body. The wgmma body's
# tiles (WCfg<HD>): keys a dK/dV block (64 a consumer warpgroup at hd 64;
# at hd 128 and 256 both consumers take the same 64 keys and split hd),
# query positions a step of it, its ring's stages; query positions a dQ
# block (64 a consumer), keys a step of it, its ring's stages
WGMMA_TILES = {
    64: dict(kv_keys=128, kv_rows=64, kv_stages=4, q_rows=128, q_keys=64, q_stages=4),
    128: dict(kv_keys=64, kv_rows=64, kv_stages=4, q_rows=128, q_keys=64, q_stages=4),
    256: dict(kv_keys=64, kv_rows=32, kv_stages=4, q_rows=128, q_keys=32, q_stages=2),
}
SMEM_LIMIT = 232448   # bytes of shared memory a block may take on the H100


def wgmma_smem_bytes(hd: int):
    """(dQ pass, dK/dV pass) dynamic shared memory bytes of the wgmma body
    (DqLayout / DkvLayout): the operand boxes, the ring, lse and D, the
    barriers and 1024 bytes to align the base."""
    t = WGMMA_TILES[hd]
    kb, bq, st = t["kv_keys"], t["kv_rows"], t["kv_stages"]
    stage = -(-(2 * bq * hd * 2 + 2 * bq * 4) // 1024) * 1024
    dkv = 2 * kb * hd * 2 + st * stage + (1 + 2 * st) * 8 + 1024
    qr, bk, qs = t["q_rows"], t["q_keys"], t["q_stages"]
    dq = 2 * qr * hd * 2 + qs * 2 * bk * hd * 2 + qr * 4 + (1 + 2 * qs) * 8 + 1024
    return dq, dkv


def dkv_head_groups(B: int, Skv: int, H: int, KV: int, hd: int, n_sm: int) -> int:
    """Head groups HS of the wgmma dK/dV pass: 1 where its key blocks x kv
    heads x batches fill the card's ``n_sm`` SMs, else enough groups of each
    kv head's G query heads to fill it (at most G); each group sums its
    heads into a float32 workspace, then the groups are added in order."""
    blocks = -(-Skv // WGMMA_TILES[hd]["kv_keys"]) * KV * B
    return 1 if blocks >= n_sm else min(H // KV, -(-n_sm // blocks))


def wgmma_blocks(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int, hs: int = 1):
    """(dQ blocks, dK/dV blocks) of the wgmma body's one-dimensional grids,
    the dK/dV pass with ``hs`` head groups."""
    t = WGMMA_TILES[hd]
    return (-(-Sq // t["q_rows"]) * H * B, -(-Skv // t["kv_keys"]) * KV * B * hs)


def tiles_meet(k_lo, k_hi, q_lo, q_hi, causal, window, chunk) -> bool:
    """Whether keys [k_lo, k_hi] and query positions [q_lo, q_hi] can hold
    a visible pair (the kernels' ``tiles_meet``)."""
    ok = True
    if causal:
        ok = ok and k_lo <= q_hi
    if window:
        ok = ok and k_hi > q_lo - window
    if chunk:
        ok = ok and k_hi // chunk >= q_lo // chunk and k_lo // chunk <= q_hi // chunk
    return ok


def dkv_block(i: int, B: int, KV: int, hs: int = 1):
    """(key block, kv head, batch, head group) of the dK/dV pass's block
    ``i`` with ``hs`` head groups: key blocks slowest, so the first wave
    holds the first key block of every (head group, kv head, batch), under a
    causal mask the heaviest."""
    per = KV * B * hs
    return i // per, i % KV, i // KV % B, i % per // (KV * B)


def dkv_walk(kb: int, Sq: int, Skv: int, G: int, hd: int, causal: bool,
             window: int, chunk: int, group: int = 0, hs: int = 1):
    """The steps of key block ``kb`` for head group ``group`` of ``hs`` in
    order: (position tile, head of the kv head's G), the live position
    tiles (one interval) times the group's heads."""
    t = WGMMA_TILES[hd]
    kbn, bq, qbase = t["kv_keys"], t["kv_rows"], Skv - Sq
    k_lo, k_hi = kb * kbn, min(kb * kbn + kbn, Skv) - 1
    live = [pt for pt in range(-(-Sq // bq))
            if tiles_meet(k_lo, k_hi, qbase + pt * bq,
                          qbase + min(pt * bq + bq, Sq) - 1, causal, window, chunk)]
    if live:
        live = list(range(live[0], live[-1] + 1))
    heads = range(group * G // hs, (group + 1) * G // hs)
    return [(pt, g) for pt in live for g in heads]


def dq_block(i: int, B: int, H: int, Sq: int, hd: int, causal: bool):
    """(query block, head, batch) of the dQ pass's block ``i``: query
    blocks slowest; under a causal mask the last (heaviest) first."""
    return q_block(i, B, H, Sq, WGMMA_TILES[hd]["q_rows"], causal)


def dq_walk(qb: int, Sq: int, Skv: int, hd: int, causal: bool, window: int,
            chunk: int):
    """The key tiles query block ``qb`` walks, in order (one interval)."""
    t = WGMMA_TILES[hd]
    return q_walk(qb, Sq, Skv, t["q_rows"], t["q_keys"], causal, window, chunk)


@functools.lru_cache(maxsize=None)
def visible_pairs(Sq: int, Skv: int, causal: bool, window: int, chunk: int) -> int:
    """The (query, key) pairs the mask lets through, the queries being the
    last Sq of Skv positions (``ref.attention_mask``'s count)."""
    p = np.arange(Skv - Sq, Skv, dtype=np.int64)
    hi = p if causal else np.full_like(p, Skv - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    if chunk:
        lo = np.maximum(lo, p // chunk * chunk)
        hi = np.minimum(hi, (p // chunk + 1) * chunk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q, k, v, out, lse, causal, window, chunk):
    """(FLOPs, HBM bytes) of one forward call: q, k and v read once, the
    output (and lse) written once; the scores and the weighted sum of every
    visible pair (``PERF.md``'s bound column)."""
    B, Sq, H, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window, chunk) * H * B
    return 4 * hd * pairs, build.nbytes(q, k, v, out, lse)


def bwd_cost(q, k, v, out, lse, dout, dq, dk, dv, causal, window, chunk):
    """(FLOPs, HBM bytes) of one backward call: each operand read once and
    each gradient written once; the five products of every visible pair
    (S = QK^T again, dP = dO V^T, dV += P^T dO, dQ += dS K, dK += dS^T Q)."""
    B, Sq, H, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window, chunk) * H * B
    return 10 * hd * pairs, build.nbytes(q, k, v, out, lse, dout, dq, dk, dv)


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


def _forward(q, k, v, causal, window, chunk, softmax_scale, with_lse: bool,
             body: Optional[str] = None):
    """One launch of the forward kernel; (out, lse or None). ``body``
    names a bf16 body to run ("wgmma" or "mma"; a measurement's choice),
    else ``forward_body`` picks it."""
    _check_shapes(q, k, v, window, chunk)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    body = body or forward_body(q.dtype, B, Sq, Skv, H, KV, hd)
    if (body == "fma") != (q.dtype != torch.bfloat16) or body not in FWD_KERNELS:
        raise ValueError(f"no {body!r} body for {q.dtype}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    build.check_operands(q.device, q=q, k=k, v=v, out=out)
    if build.is_fake(q, k, v):
        build.record_cost(flash_attention, *cost(q, k, v, out, lse, causal, window,
                                                 chunk))
        return out, lse
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    geo = (fwd_blocks(B, Sq, H, hd), fwd_smem_bytes(hd)) if body == "wgmma" else (0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     B, Sq, Skv, H, KV, hd, int(causal), int(window),
                     int(chunk), scale, build.dtype_code(q), int(body == "wgmma"),
                     *geo, stream)
    build.check_launch("flash_attention", rc)
    build.count_launch(flash_attention)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd)
    in q.dtype. Differentiable (``FlashAttentionFn``) where autograd asks."""
    build.refuse_dtensor("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, chunk,
                                      softmax_scale)
    if not q.is_cuda and not build.is_fake(q, k, v):
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
    build.refuse_dtensor("flash_attention_bwd", q, k, v, out, lse, dout)
    fake = build.is_fake(q, k, v, out, lse, dout)
    if not q.is_cuda and not fake:
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
    hs = dkv_head_groups(B, Skv, H, KV, hd, build.n_sms(q)) \
        if q.dtype == torch.bfloat16 else 1
    ws = torch.empty(2 * hs * B * Skv * KV * hd, dtype=torch.float32,
                     device=q.device) if hs > 1 else None
    build.check_operands(q.device, q=q, k=k, v=v, out=out, dout=dout, lse=lse,
                         delta=delta, dq=dq, dk=dk, dv=dv)
    if fake:
        build.record_cost(flash_attention_bwd, *bwd_cost(
            q, k, v, out, lse, dout, dq, dk, dv, causal, window, chunk))
        return dq, dk, dv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    geo = (*wgmma_blocks(B, Sq, Skv, H, KV, hd, hs), *wgmma_smem_bytes(hd), hs)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), ws.data_ptr() if ws is not None else None,
                         B, Sq, Skv, H, KV, hd, int(causal), int(window),
                         int(chunk), scale, build.dtype_code(q), *geo, stream)
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
        if q.is_cuda or build.is_fake(q, k, v):
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
