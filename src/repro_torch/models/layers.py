"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, cross-entropy.

Each follows ``repro.models.layers`` op for op, including where values are
upcast to float32 and cast back, so the port's logits match the reference
on the same weights.

Two casts of the int8 configurations live here too: ``dequantize``, an
integer weight leaf at its use (the reference's forward,
``repro/models/model.py:276-285``), and ``saturate_cast``, every write of
K/V into a cache of another dtype (XLA's convert, which the reference's
``astype`` is).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels.build import is_fake
from repro_torch.models.param import Spec

WEIGHT_STEP = 0.01   # the value of one step of an integer weight


def dequantize(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An integer weight leaf upcast at its use, as the reference's
    ``leaf.astype(dtype) * asarray(0.01, dtype)``: the step rounded to
    ``dtype`` first, then one product rounded to ``dtype``. One
    elementwise pass (int8 in, ``dtype`` out, the product in float32): an
    int8 value and a bf16 step multiply exactly in float32, so rounding
    once gives the reference's bits, on the CPU and on the card. A
    floating leaf is returned as it is, uncopied."""
    if w.is_floating_point():
        return w
    step = float(torch.tensor(WEIGHT_STEP, dtype=dtype))
    return torch.mul(w, step, out=torch.empty(w.shape, dtype=dtype, device=w.device))


def saturate_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` for a store into a cache of that dtype, as XLA's
    convert: to an integer dtype it maps NaN to 0, saturates to the
    dtype's range and truncates toward zero, where ``Tensor.to`` wraps
    (bf16 127.9 rounds to 128, which ``.to(torch.int8)`` makes -128). The
    same elementwise ops on the CPU and on the card. To a floating dtype
    it is ``Tensor.to``."""
    if x.dtype == dtype or dtype.is_floating_point or not x.is_floating_point():
        return x.to(dtype)
    info = torch.iinfo(dtype)
    x = torch.nan_to_num(x, nan=0.0).clamp(info.min, info.max)
    return x.trunc().to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """theta ** (-i / half) in float32, computed once per (width, device):
    building it per call from a Python scalar on the card would block the
    host on the stream."""
    exponent = -torch.arange(0, half, dtype=torch.float32) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32),
                     exponent).to(device)


def rope_tables(pos: torch.Tensor, hd: int, theta: float):
    """(cos, sin) of shape (..., S, 1, hd // 2) in float32 for positions
    ``pos`` (..., S); one pair serves every layer of a forward."""
    # a fake tensor's table (the dry run's trace) is not kept in the cache,
    # which real calls on the same device read
    freq = (_rope_freq.__wrapped__ if is_fake(pos) else _rope_freq)(
        hd // 2, float(theta), pos.device)
    angles = pos[..., None, None].float() * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd) with pos broadcasting against
    the sequence dims (..., S); frequencies and rotation in float32."""
    return apply_rope(x, *rope_tables(pos, x.shape[-1], theta))


def mlp_specs(d: int, f: int) -> Dict[str, Spec]:
    return {"wg": Spec((d, f), ("embed", "ff")),
            "wu": Spec((d, f), ("embed", "ff")),
            "wd": Spec((f, d), ("ff", "embed"))}


def mlp_hidden(params, x: torch.Tensor) -> torch.Tensor:
    """The gated hidden activations silu(x wg) * (x wu), before ``wd``."""
    g = x @ params["wg"]
    u = x @ params["wu"]
    return torch.nn.functional.silu(g.float()).to(x.dtype) * u


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    return mlp_hidden(params, x) @ params["wd"]


def embed_specs(vocab: int, d: int, tie: bool) -> Dict[str, Spec]:
    specs = {"tok": Spec((vocab, d), ("vocab", "embed"), scale=0.02)}
    if not tie:
        specs["head"] = Spec((d, vocab), ("embed", "vocab"))
    return specs


def embed(params, tokens: torch.Tensor, d: int,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tokens' rows of the table times sqrt(d). An integer table is
    dequantized to ``dtype`` (the model's) in the gathered rows only."""
    out = params["tok"][tokens]
    if not out.is_floating_point():
        out = dequantize(out, dtype)
    # sqrt(d) rounded to the table's dtype, as the reference multiplies by
    # jnp.asarray(d ** 0.5, dtype); rounded on the host, so no device sync
    scale = float(torch.tensor(d ** 0.5, dtype=out.dtype))
    return out * scale


UNEMBED_CHUNK = 8192    # vocab columns a float32 product of the backward


class _UnembedFn(torch.autograd.Function):
    """The card's bf16 unembedding under autograd (``aten::mm.dtype`` has
    no derivative). Forward: the ``out_dtype`` product. Backward as the
    reference's transpose of a ``preferred_element_type=float32`` product
    (``jax.vjp`` of ``layers.unembed``): the float32 cotangent g is NOT
    rounded to bf16; ``dx = g w^T`` and ``dw = x^T g`` are float32 products
    (the bf16 operand widened exactly) rounded once to bf16. They run as
    plain ``torch.mm`` over vocab chunks of ``UNEMBED_CHUNK`` columns, so no
    float32 copy of the table (or of its gradient) is made: one chunk's at
    a time."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        chunks = range(0, w.shape[1], UNEMBED_CHUNK)
        if ctx.needs_input_grad[0]:
            acc = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
            for c in chunks:
                acc.addmm_(g[:, c:c + UNEMBED_CHUNK],
                           w[:, c:c + UNEMBED_CHUNK].float().t())
            dx = acc.to(x2.dtype)
        if ctx.needs_input_grad[1]:
            xt = x2.float().t()
            dw = torch.empty_like(w)
            for c in chunks:
                dw[:, c:c + UNEMBED_CHUNK] = xt @ g[:, c:c + UNEMBED_CHUNK]
        return dx, dw


def unembed(params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    """Logits in float32, as the reference's ``preferred_element_type``: no
    bf16 rounding of the logits happens. On the card with bf16 operands,
    one product of the bf16 operands with float32 accumulation and output
    (``out_dtype``): exact products and no float32 copy of the vocab table
    (the tied table is read transposed, in place); under autograd through
    ``_UnembedFn``. Elsewhere the operands are upcast (``aten::mm.dtype``
    is CUDA-only), the same exact products, which autograd differentiates
    as the reference does. An integer table is dequantized to x's dtype
    at this use."""
    w = dequantize(params["tok"], x.dtype).t() if tie else \
        dequantize(params["head"], x.dtype)
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            logits = _UnembedFn.apply(x2, w)
        else:
            logits = torch.mm(x2, w, out_dtype=torch.float32)
        return logits.reshape(x.shape[:-1] + (w.shape[-1],))
    return x.float() @ w.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy (the reference's ``cross_entropy``, op for
    op): float32 ``logsumexp`` minus the gold logit; with ``mask``, the
    masked mean over at least one token. logits (..., V), labels (...,)
    int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
