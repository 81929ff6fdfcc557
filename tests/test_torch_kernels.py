"""The port's kernels (K1 paged, K2 flash, K3 decode attention, K5 RG-LRU
scan) against the JAX package's; K4 (``moe_gmm``) is held in
``tests/test_torch_moe.py`` and its backward's plain version in
``tests/test_torch_moe_train.py`` (its kernels' ``gpu`` case is here).

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against JAX's ``ref`` oracles and its Pallas kernels in interpret mode
on the same numpy inputs. Tolerances are the JAX suite's own: float32
``2e-5`` (summation order), bfloat16 ``2e-2`` (both sides round q*scale and
p to bf16 at the same places, then the output once).

Cases marked ``gpu`` hold the hand-written CUDA kernels against the plain
versions on the card and skip where there is none. JAX is imported inside
the comparison helpers so those cases also run where JAX is not installed
(``python -m pytest -m gpu tests/test_torch_kernels.py``).
"""
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rs

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}

# B, Sq, H, KV, hd, causal, window, chunk, dtype (tests/test_kernels.py)
FLASH_CASES = [
    (1, 256, 4, 2, 64, True, 0, 0, F32),
    (2, 300, 4, 4, 128, True, 0, 0, F32),
    (1, 256, 8, 2, 64, True, 64, 0, F32),
    (1, 512, 4, 1, 64, True, 0, 128, F32),
    (2, 128, 6, 6, 64, False, 0, 0, F32),
    (1, 256, 4, 2, 128, True, 0, 0, BF16),
    (1, 130, 2, 2, 256, True, 0, 0, F32),
]


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _torch(x, dtype, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device,
                                               dtype=getattr(torch, dtype))


def _jnp(x, dtype):
    import jax.numpy as jnp
    return jnp.asarray(x, getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------------
# flash attention (K2): plain port vs JAX ref and Pallas interpret
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,H,KV,hd,causal,window,chunk,dtype", FLASH_CASES)
def test_flash_plain_matches_jax(B, Sq, H, KV, hd, causal, window, chunk, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    rng = np.random.default_rng(Sq + hd)
    q, k, v = _np(rng, (B, Sq, H, hd)), _np(rng, (B, Sq, KV, hd)), \
        _np(rng, (B, Sq, KV, hd))
    kw = dict(causal=causal, window=window, chunk=chunk)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Sq, H, hd)
    jq, jk, jv = _jnp(q, dtype), _jnp(k, dtype), _jnp(v, dtype)
    want_ref = jref.flash_attention(jq, jk, jv, **kw)
    want_pallas = pallas_flash(jq, jk, jv, interpret=True, block_q=128,
                               block_kv=128, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_pallas), atol=TOL[dtype])


def test_flash_queries_are_last_positions():
    """Sq < Skv: queries sit at the last Sq positions of the kv stream."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    q, k, v = _np(rng, (1, 40, 4, 64)), _np(rng, (1, 100, 2, 64)), \
        _np(rng, (1, 100, 2, 64))
    got = ops.flash_attention(_torch(q, F32), _torch(k, F32), _torch(v, F32))
    want = jref.flash_attention(_jnp(q, F32), _jnp(k, F32), _jnp(v, F32))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[F32])


# ----------------------------------------------------------------------
# paged attention (K1): decode and chunked prefill
# ----------------------------------------------------------------------
def _paged_inputs(rng, B, C, H, KV, hd, page, P, kv_len, dtype):
    """Random pools and block tables: sequence b maps pages_for(kv_len[b])
    distinct physical pages (never page 0), zero-padded to width P; a
    kv_len of 1 with an all-zeros table is an inactive engine row reading
    the scratch page."""
    n_pages = 1 + sum(-(-int(n) // page) for n in kv_len) + 2
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    used = 0
    for b, n in enumerate(kv_len):
        if n == 1 and b == B - 1:      # scratch-page row: table all zeros
            continue
        need = -(-int(n) // page)
        bt[b, :need] = perm[used:used + need]
        used += need
    q = _np(rng, (B, C, H, hd))
    kp = _np(rng, (n_pages, page, KV, hd))
    vp = _np(rng, (n_pages, page, KV, hd))
    return q, kp, vp, bt, np.asarray(kv_len, np.int32)


PAGED_CASES = [
    # G, hd, dtype
    (1, 64, F32), (2, 64, F32), (4, 64, F32), (4, 128, F32), (4, 64, BF16),
]


@pytest.mark.parametrize("G,hd,dtype", PAGED_CASES)
def test_paged_decode_plain_matches_jax(G, hd, dtype):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(G * 7 + hd)
    KV, page, P = 2, 8, 8
    kv_len = [13, 1, 40, 24, 1]             # ragged; last row is scratch
    q, kp, vp, bt, kl = _paged_inputs(rng, len(kv_len), 1, G * KV, KV, hd,
                                      page, P, kv_len, dtype)
    got = ops.paged_decode_attention(_torch(q, dtype), _torch(kp, dtype),
                                     _torch(vp, dtype), torch.from_numpy(bt),
                                     torch.from_numpy(kl))
    args = (_jnp(q, dtype), _jnp(kp, dtype), _jnp(vp, dtype), bt, kl)
    for impl in ("ref", "interpret"):
        want = jops.paged_decode_attention(*args, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   err_msg=impl)


@pytest.mark.parametrize("G,hd,dtype", PAGED_CASES)
def test_paged_prefill_plain_matches_jax(G, hd, dtype):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(G * 11 + hd)
    KV, page, P, C = 2, 8, 8, 6
    q_off = np.array([0, 9, 30], np.int32)
    kv_len = q_off + C
    q, kp, vp, bt, kl = _paged_inputs(rng, 3, C, G * KV, KV, hd, page, P,
                                      kv_len, dtype)
    got = ops.paged_prefill_attention(_torch(q, dtype), _torch(kp, dtype),
                                      _torch(vp, dtype), torch.from_numpy(bt),
                                      torch.from_numpy(kl),
                                      torch.from_numpy(q_off))
    args = (_jnp(q, dtype), _jnp(kp, dtype), _jnp(vp, dtype), bt, kl, q_off)
    for impl in ("ref", "interpret"):
        want = jops.paged_prefill_attention(*args, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   err_msg=impl)


def test_gather_and_dense_decode_match_jax():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(3)
    q, kp, vp, bt, kl = _paged_inputs(rng, 3, 1, 8, 2, 64, 4, 6,
                                      [5, 17, 2], F32)
    np.testing.assert_array_equal(
        ref.gather_pages(torch.from_numpy(kp), torch.from_numpy(bt)).numpy(),
        np.asarray(jref.gather_pages(kp, bt)))
    k = np.asarray(jref.gather_pages(kp, bt))
    v = np.asarray(jref.gather_pages(vp, bt))
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(kl))
    want = jref.decode_attention(q, k, v, kl)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[F32])


# ----------------------------------------------------------------------
# decode attention (K3): dense per-slot and ring caches
# ----------------------------------------------------------------------
def _decode_inputs(rng, G, hd, KV=2, S=40, kv_len=(1, 17, 40)):
    """Ragged valid lengths, the last a full (wrapped) ring."""
    B = len(kv_len)
    return (_np(rng, (B, 1, G * KV, hd)), _np(rng, (B, S, KV, hd)),
            _np(rng, (B, S, KV, hd)), np.asarray(kv_len, np.int32))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("G", [1, 4, 10])
def test_decode_plain_matches_jax(G, hd, dtype):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(G * 13 + hd)
    q, k, v, kl = _decode_inputs(rng, G, hd)
    got = ops.decode_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), torch.from_numpy(kl))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    args = (_jnp(q, dtype), _jnp(k, dtype), _jnp(v, dtype), kl)
    for impl in ("ref", "interpret"):
        want = jops.decode_attention(*args, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   err_msg=impl)


def _int8_cache(kf, vf):
    """Symmetric per-(sequence, kv head) int8 quantization
    (tests/test_kernels.py::test_decode_attention_int8_cache)."""
    ks = np.abs(kf).max(axis=(1, 3)) / 127.0
    vs = np.abs(vf).max(axis=(1, 3)) / 127.0
    k8 = np.round(kf / ks[:, None, :, None]).astype(np.int8)
    v8 = np.round(vf / vs[:, None, :, None]).astype(np.int8)
    return k8, v8, ks.astype(np.float32), vs.astype(np.float32)


def test_decode_int8_plain_matches_jax():
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention as pallas_dec
    rng = np.random.default_rng(8)
    q, kf, vf, _ = _decode_inputs(rng, 4, 64, S=256)
    kl = np.array([100, 256, 3], np.int32)
    k8, v8, ks, vs = _int8_cache(kf, vf)
    got = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(kl), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    want_ref = jref.decode_attention(q, k8, v8, kl, k_scale=ks, v_scale=vs)
    want_kernel = pallas_dec(q, k8, v8, kl, k_scale=ks, v_scale=vs,
                             interpret=True, block_kv=128)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=TOL[F32])
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=TOL[F32])
    # and within quantization error of the float cache
    np.testing.assert_allclose(
        _f32(got), _f32(ref.decode_attention(*map(torch.from_numpy, (
            q, kf, vf, kl)))), atol=0.05)


# ----------------------------------------------------------------------
# split-KV decode (the shared body of K1 decode and K3): the plain
# split-and-merge, and the host-side split plan
# ----------------------------------------------------------------------
# kv_len 1 (every split but the first empty), 64 and 65 (a 64-key split
# boundary at and across), 130 and the full cache of 200
SPLIT_KV_LEN = [1, 64, 65, 130, 200]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_decode_plain_matches_jax(n_split, int8):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(n_split + 40 * int8)
    q, k, v, kl = _decode_inputs(rng, 5, 64, S=200, kv_len=SPLIT_KV_LEN)
    scales = {}
    if int8:
        k, v, ks, vs = _int8_cache(k, v)
        scales = dict(k_scale=ks, v_scale=vs)
    tq, tk, tv, tkl = map(torch.from_numpy, (q, k, v, kl))
    tscales = {n: torch.from_numpy(x) for n, x in scales.items()}
    got = ref.split_decode_attention(tq, tk, tv, tkl, n_split, **tscales)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(
        _f32(got), _f32(ref.decode_attention(tq, tk, tv, tkl, **tscales)),
        atol=TOL[F32])
    if int8:
        from repro.kernels import ref as jref
        from repro.kernels.decode_attention import decode_attention as pallas_dec
        wants = {"ref": jref.decode_attention(q, k, v, kl, **scales),
                 "interpret": pallas_dec(q, k, v, kl, interpret=True,
                                         block_kv=128, **scales)}
    else:
        wants = {impl: jops.decode_attention(q, k, v, kl, impl=impl)
                 for impl in ("ref", "interpret")}
    for impl, want in wants.items():
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[F32],
                                   err_msg=impl)


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_paged_split_decode_plain_matches_jax(n_split):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(70 + n_split)
    kv_len = [13, 64, 65, 128, 1]           # last row: the scratch page
    q, kp, vp, bt, kl = _paged_inputs(rng, len(kv_len), 1, 10, 2, 64, 16, 10,
                                      kv_len, F32)
    args = list(map(torch.from_numpy, (q, kp, vp, bt, kl)))
    got = ref.split_decode_attention(args[0], ref.gather_pages(args[1], args[3]),
                                     ref.gather_pages(args[2], args[3]), args[4],
                                     n_split)
    np.testing.assert_allclose(_f32(got), _f32(ref.paged_decode_attention(*args)),
                               atol=TOL[F32])
    for impl in ("ref", "interpret"):
        want = jops.paged_decode_attention(q, kp, vp, bt, kl, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[F32],
                                   err_msg=impl)


def test_split_partials_of_empty_ranges():
    """An empty split carries m = NEG_INF and l = 0, and the non-empty
    ones start on 64-key boundaries and tile [0, kv_len) exactly."""
    rng = np.random.default_rng(9)
    q, k, v, kl = _decode_inputs(rng, 4, 64, S=200, kv_len=SPLIT_KV_LEN)
    m, l, acc = ref.split_decode_partials(*map(torch.from_numpy, (q, k, v, kl)), 8)
    assert m.shape == l.shape == (8, len(SPLIT_KV_LEN), 8)
    assert acc.shape == (8, len(SPLIT_KV_LEN), 8, 64)
    for b, n in enumerate(SPLIT_KV_LEN):
        per = -(-(-(-n // 8)) // 64) * 64
        live = [s for s in range(8) if s * per < n]
        assert live == list(range(-(-n // per)))
        for s in range(8):
            if s in live:
                assert (l[s, b] >= 1).all()     # the range's max key weighs 1
            else:
                assert (m[s, b] == ref.NEG_INF).all() and (l[s, b] == 0).all()
                assert (acc[s, b] == 0).all()


@pytest.mark.parametrize("B,KV,G,capacity,n_sm,want", [
    (8, 1, 10, 2048, 132, 32),     # recurrentgemma ring: 8 blocks without a split
    (8, 8, 4, 2048, 132, 5),       # granite decode, paged or dense
    (8, 8, 5, 8192, 132, 5),       # llama4-scout chunked-attention ring
    (8, 8, 5, 9216, 132, 5),       # llama4-scout paged global layers
    (1, 1, 10, 100, 132, 2),       # capped by the cache: one tile a split
    (1, 1, 1, 64, 132, 1),
    (64, 8, 4, 4096, 132, 1),      # 512 blocks already fill the card
    (33, 8, 1, 4096, 132, 1),      # 264 blocks: two an SM
    (8, 2, 64, 4096, 132, 5),      # G = 64: four row groups
    (8, 2, 17, 4096, 132, 9),      # G = 17: two row groups
])
def test_split_plan(B, KV, G, capacity, n_sm, want):
    n = da.split_plan(B, KV, G, capacity, n_sm)
    assert n == want
    blocks = B * KV * -(-G // 16)
    assert n <= -(-capacity // 64)                  # a tile at least a split
    if blocks >= 2 * n_sm:
        assert n == 1
    else:
        assert blocks * n >= min(2 * n_sm, blocks * -(-capacity // 64))


def test_split_plan_reads_no_kv_len():
    """The plan is a function of shapes alone; every kv_len up to the
    capacity splits into at most n_split 64-aligned ranges covering it."""
    import inspect
    assert list(inspect.signature(da.split_plan).parameters) == \
        ["B", "KV", "G", "capacity", "n_sm"]
    cap = 2048
    n = da.split_plan(8, 1, 10, cap, 132)
    for kvl in range(1, cap + 1):
        per = -(-(-(-kvl // n)) // 64) * 64
        ranges = [(s * per, min((s + 1) * per, kvl)) for s in range(n)]
        covered = [r for r in ranges if r[0] < r[1]]
        assert covered[0][0] == 0 and covered[-1][1] == kvl
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


# ----------------------------------------------------------------------
# RG-LRU scan (K5)
# ----------------------------------------------------------------------
def _scan_inputs(rng, B, S, D):
    """Decay a in (0.3, 0.99) and input b as the RG-LRU gates give them."""
    a = rng.uniform(0.3, 0.99, size=(B, S, D)).astype(np.float32)
    return a, _np(rng, (B, S, D)), _np(rng, (B, D))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(2, 37, 200), (1, 70, 130), (3, 5, 64)])
def test_rglru_plain_matches_jax(B, S, D, with_h0):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(S + D)
    a, b, h0 = _scan_inputs(rng, B, S, D)
    h0 = h0 if with_h0 else None
    got = ops.rglru_scan(*(torch.from_numpy(x) if x is not None else None
                           for x in (a, b, h0)))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    args = [_jnp(x, F32) if x is not None else None for x in (a, b, h0)]
    for impl in ("ref", "interpret"):
        want = jops.rglru_scan(*args, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-5, err_msg=impl)


def test_rglru_plain_is_the_sequential_recurrence():
    """One rounded multiply and one rounded add per step, in float32."""
    rng = np.random.default_rng(1)
    a, b, h0 = _scan_inputs(rng, 2, 33, 8)
    h = h0.copy()
    seq = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        seq.append(h.copy())
    got = ref.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0))
    np.testing.assert_array_equal(got.numpy(), np.stack(seq, axis=1))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_rglru_plan_covers_every_row_length(itemsize):
    """Every D the wrapper may be given, at every pointer alignment of its
    dtype, has a kernel instance: a copy width that divides every row
    start, and every explicit channel count honoured or refused."""
    for D in range(1, 3000):
        for base in (0, itemsize, 2 * itemsize, 8, 16):
            ptrs = (1 << 20, (1 << 21) + base)
            plan = rs.scan_plan(D, itemsize, *ptrs)
            assert plan.ch == rs.DEFAULT_CH in rs.CH_CHOICES
            assert plan.vec in rs.VEC_CHOICES and plan.vec >= itemsize
            assert (D * itemsize) % plan.vec == 0
            assert all(p % plan.vec == 0 for p in ptrs)
            if D % 8 == 0 and base % 16 == 0:
                assert plan.vec == 16
    for ch in rs.CH_CHOICES:
        assert rs.scan_plan(2560, 4, 0, 0, ch=ch) == rs.ScanPlan(ch, 16)
    with pytest.raises(ValueError):
        rs.scan_plan(2560, 4, 0, 0, ch=48)


def test_wrappers_run_plain_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    counters = (fa.flash_attention, pa.paged_decode_attention,
                pa.paged_prefill_attention, da.decode_attention,
                rs.rglru_scan, gm.moe_gmm)
    before = [f.launches for f in counters]
    q = _torch(_np(rng, (1, 8, 4, 64)), F32)
    k = _torch(_np(rng, (1, 8, 2, 64)), F32)
    out = fa.flash_attention(q, k, k)
    torch.testing.assert_close(out, ref.flash_attention(q, k, k))
    torch.testing.assert_close(ops.flash_attention(q, k, k, impl="ref"), out)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, impl="pallas")
    kl = torch.tensor([8], dtype=torch.int32)
    torch.testing.assert_close(da.decode_attention(q[:, :1], k, k, kl),
                               ref.decode_attention(q[:, :1], k, k, kl))
    a = torch.rand((1, 6, 16))
    torch.testing.assert_close(rs.rglru_scan(a, a), ops.rglru_scan(a, a, impl="ref"))
    gs = torch.tensor([4, 0, 2], dtype=torch.int32)
    w = torch.rand((3, 16, 8))
    torch.testing.assert_close(gm.moe_gmm(a[0], w, gs),
                               ops.moe_gmm(a[0], w, gs, impl="ref"))
    assert [f.launches for f in counters] == before


# ----------------------------------------------------------------------
# the backward of K2 and K5: plain versions vs jax.grad of the reference's
# XLA path (the Pallas kernels have no VJP), autograd and gradcheck
# ----------------------------------------------------------------------
# B, Sq, Skv, H, KV, hd, causal, window, chunk: every mask, G = 1, 4 and
# 5, Sq < Skv, ragged lengths (not multiples of the plain version's blocks)
FLASH_BWD_CASES = [
    (2, 40, 40, 8, 2, 64, True, 0, 0),      # G = 4, causal
    (1, 33, 33, 4, 4, 64, True, 0, 0),      # G = 1, ragged
    (1, 24, 57, 10, 2, 64, True, 0, 0),     # G = 5, Sq < Skv
    (1, 50, 50, 4, 1, 128, True, 16, 0),    # window
    (1, 37, 61, 5, 1, 64, True, 16, 0),     # window, Sq < Skv, G = 5
    (1, 45, 45, 8, 2, 64, True, 0, 16),     # chunk
    (2, 30, 30, 4, 4, 64, False, 0, 0),     # no mask
    (1, 19, 19, 2, 1, 256, True, 0, 0),     # hd 256, G = 2
]


def _flash_bwd_inputs(rng, B, Sq, Skv, H, KV, hd):
    return (_np(rng, (B, Sq, H, hd)), _np(rng, (B, Skv, KV, hd)),
            _np(rng, (B, Skv, KV, hd)), _np(rng, (B, Sq, H, hd)))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,chunk", FLASH_BWD_CASES)
def test_flash_bwd_plain_matches_jax_grad(B, Sq, Skv, H, KV, hd, causal,
                                          window, chunk):
    """``ref.flash_attention_bwd`` (from the forward's log-sum-exp) against
    ``jax.vjp`` of the reference's XLA attention and against torch autograd
    of the port's plain forward, float32 within 2e-5 of max |grad|."""
    import jax
    from repro.kernels import ref as jref
    rng = np.random.default_rng(Sq * Skv + H)
    q, k, v, do = _flash_bwd_inputs(rng, B, Sq, Skv, H, KV, hd)
    kw = dict(causal=causal, window=window, chunk=chunk)
    out, lse = ref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   **kw, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                  out, lse, torch.from_numpy(do), **kw)
    jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(q, k, v, **kw),
                        *(_jnp(x, F32) for x in (q, k, v)))
    np.testing.assert_allclose(_f32(out), _f32(jout), atol=2e-5)
    want = vjp(_jnp(do, F32))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(ref.flash_attention(*ts, **kw), ts,
                               torch.from_numpy(do))
    for name, g, w, a in zip("qkv", got, want, auto):
        w = _f32(w)
        tol = 2e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_f32(g), w, atol=tol, err_msg=f"d{name} vs jax")
        np.testing.assert_allclose(_f32(g), _f32(a), atol=tol, err_msg=f"d{name} vs autograd")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(2, 37, 24), (1, 70, 13)])
def test_rglru_bwd_plain_matches_jax_grad(B, S, D, with_h0):
    """``ref.rglru_scan_bwd`` (the reverse walk) against ``jax.vjp`` of the
    reference's associative scan, float32 within 2e-5 (the scan's sums run
    in another order)."""
    import jax
    from repro.kernels import ref as jref
    rng = np.random.default_rng(S + D)
    a, b, h0 = _scan_inputs(rng, B, S, D)
    dh = _np(rng, (B, S, D))
    h0 = h0 if with_h0 else None
    ta = [torch.from_numpy(x) if x is not None else None for x in (a, b, h0)]
    h = ref.rglru_scan(*ta)
    da, db, dh0 = ref.rglru_scan_bwd(ta[0], h, torch.from_numpy(dh), ta[2])
    if with_h0:
        _, vjp = jax.vjp(jref.rglru_scan, *(_jnp(x, F32) for x in (a, b, h0)))
        wa, wb, wh0 = vjp(_jnp(dh, F32))
        np.testing.assert_allclose(_f32(dh0), _f32(wh0), rtol=2e-5, atol=2e-5)
    else:
        _, vjp = jax.vjp(lambda a, b: jref.rglru_scan(a, b),
                         *(_jnp(x, F32) for x in (a, b)))
        wa, wb = vjp(_jnp(dh, F32))
        assert dh0 is None
    np.testing.assert_allclose(_f32(da), _f32(wa), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_f32(db), _f32(wb), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window,chunk,Sq,Skv", [
    (True, 0, 0, 6, 6), (True, 3, 0, 5, 9), (True, 0, 4, 8, 8),
    (False, 0, 0, 4, 7)])
def test_flash_function_gradcheck(causal, window, chunk, Sq, Skv):
    """``FlashAttentionFn`` on CPU tensors (the plain forward and
    ``ref.flash_attention_bwd``) against finite differences, float64."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, Sq, 4, 16), (1, Skv, 2, 16), (1, Skv, 2, 16)))
    fn = lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                            window=window, chunk=chunk)
    assert fn(q, k, v).grad_fn.name().startswith("FlashAttentionFn")
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_function_gradcheck(with_h0):
    """``RGLRUScanFn`` on CPU tensors (the plain scan and
    ``ref.rglru_scan_bwd``) against finite differences, float64; gradients
    reach a, b and h0."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.3, 0.99, (2, 11, 5))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 11, 5))).requires_grad_()
    h0 = torch.from_numpy(rng.standard_normal((2, 5))).requires_grad_() \
        if with_h0 else None
    args = (a, b, h0) if with_h0 else (a, b)
    assert rs.rglru_scan(*args).grad_fn.name().startswith("RGLRUScanFn")
    assert torch.autograd.gradcheck(lambda *x: rs.rglru_scan(*x), args)


def test_backward_wrappers_run_plain_on_cpu_without_counting():
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(x) for x in
                   _flash_bwd_inputs(rng, 1, 9, 9, 4, 2, 64))
    out, lse = ref.flash_attention(q, k, v, return_lse=True)
    n = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
         rs.rglru_scan.launches, rs.rglru_scan_bwd.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    for g, w in zip(got, ref.flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(g, w)
    a = torch.rand((1, 6, 16))
    h = rs.rglru_scan(a, a)
    got = rs.rglru_scan_bwd(a, h, h)
    assert got[2] is None and torch.equal(got[0], ref.rglru_scan_bwd(a, h, h)[0])
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
            rs.rglru_scan.launches, rs.rglru_scan_bwd.launches) == n


# ----------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(got, want, dtype):
    """bf16 kernels compute in float32 internally: hold them against the
    plain version run in float32 on the same bf16 inputs, rounded once."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err} > {TOL[dtype]}"


def _up(*ts):
    return [t.float() for t in ts]


# the bf16 kernel's fragment edges: Sq of 1, 17 and 1000 (not multiples
# of its 16-row warp tile or 64-row block), G of 1, 4, 5 and 10 (a block's
# 64 rows cut across query positions), window and chunk edges inside a
# 64-key tile; k and v always hold Sq + 3 positions (Skv > Sq)
GPU_FLASH_CASES = FLASH_CASES + [
    (1, 1000, 32, 8, 64, True, 0, 0, BF16),     # granite prefill width
    (1, 1000, 32, 8, 64, True, 0, 0, F32),
    (2, 77, 8, 8, 256, False, 0, 0, BF16),
    (1, 1, 8, 8, 64, True, 0, 0, BF16),         # G=1, one query
    (2, 17, 20, 4, 128, True, 0, 0, BF16),      # G=5
    (1, 17, 10, 1, 256, True, 0, 0, BF16),      # G=10
    (1, 1, 10, 1, 256, True, 0, 0, BF16),
    (1, 17, 4, 1, 64, False, 0, 0, BF16),       # G=4, no mask
    (1, 1000, 40, 8, 128, True, 0, 0, BF16),    # llama4 width
    (1, 1000, 16, 4, 64, True, 100, 0, BF16),   # window edge inside a tile
    (1, 1000, 10, 1, 256, True, 300, 0, BF16),
    (1, 1000, 20, 4, 128, True, 0, 200, BF16),  # chunk edge inside a tile
    (1, 1000, 10, 1, 256, True, 0, 200, BF16),
    (1, 1000, 8, 8, 256, False, 0, 0, BF16),
    (1, 1000, 20, 4, 128, False, 0, 200, BF16),
    (1, 1000, 20, 4, 128, True, 0, 200, F32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,H,KV,hd,causal,window,chunk,dtype",
                         GPU_FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, Sq, H, KV, hd, causal, window,
                                    chunk, dtype):
    rng = np.random.default_rng(Sq)
    q = _torch(_np(rng, (B, Sq, H, hd)), dtype, cuda)
    k = _torch(_np(rng, (B, Sq + 3, KV, hd)), dtype, cuda)
    v = _torch(_np(rng, (B, Sq + 3, KV, hd)), dtype, cuda)
    kw = dict(causal=causal, window=window, chunk=chunk)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    want = ref.flash_attention(*_up(q, k, v), **kw).to(q.dtype)
    _held(got, want, dtype)


# decode's split body at G past one m16 row group (16, 17, 64) and between
# (5, 10), every head dim, both dtypes
GPU_PAGED_CASES = PAGED_CASES + [(4, 256, BF16), (5, 128, BF16), (10, 256, BF16),
                                 (10, 64, F32), (16, 128, BF16), (17, 64, BF16),
                                 (17, 256, F32), (64, 128, BF16)]


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,dtype", GPU_PAGED_CASES)
@pytest.mark.parametrize("C", [1, 5, 70])
def test_paged_kernel_matches_plain(cuda, G, hd, dtype, C):
    """Pages out of order, tables wider than a sequence needs; decode
    kv_len 64 / 65 at and across a 64-key split boundary, 256 = the table's
    capacity, 1 (all but one split empty, and the scratch-page row)."""
    rng = np.random.default_rng(C * 13 + G + hd)
    KV, page, P = 2, 16, 16
    if C == 1:
        kv_len = np.array([13, 200, 1, 64, 65, 256, 129, 1], np.int32)
    else:
        kv_len = np.array([C, C + 9, C + 100], np.int32)
    q_off = np.maximum(kv_len - C, 0).astype(np.int32)
    q, kp, vp, bt, kl = _paged_inputs(rng, len(kv_len), C, G * KV, KV, hd,
                                      page, P, kv_len, dtype)
    args = [_torch(q, dtype, cuda), _torch(kp, dtype, cuda),
            _torch(vp, dtype, cuda),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(kl).to(cuda)]
    if C == 1:
        got = pa.paged_decode_attention(*args)
        want = ref.paged_decode_attention(*_up(*args[:3]), *args[3:])
    else:
        qo = torch.from_numpy(q_off).to(cuda)
        got = pa.paged_prefill_attention(*args, qo)
        want = ref.paged_prefill_attention(*_up(*args[:3]), *args[3:], qo)
    torch.cuda.synchronize()
    _held(got, want.to(got.dtype), dtype)


def _chunk_args(rng, dtype, device, G, KV, hd, C, q_off, page=16, P=96):
    """Chunk operands for sequences at q_off: pages shuffled, tables wider
    than a sequence needs (zero-padded: the scratch page 0), and page 0
    filled with large values that would show if a valid key read it."""
    kv_len = np.asarray(q_off, np.int32) + C
    q, kp, vp, bt, kl = _paged_inputs(rng, len(kv_len), C, G * KV, KV, hd,
                                      page, P, kv_len, dtype)
    kp[0], vp[0] = 300.0, -300.0
    return ([_torch(q, dtype, device), _torch(kp, dtype, device),
             _torch(vp, dtype, device), torch.from_numpy(bt).to(device),
             torch.from_numpy(kl).to(device)],
            torch.from_numpy(np.asarray(q_off, np.int32)).to(device))


# bf16 chunks run the tensor-core prefill body K2 runs: every head dim, G
# of 1, 4, 5 and 10 (64-row blocks cut across query positions), C not a
# multiple of 64, q_offset not a multiple of 64 or of the page
@pytest.mark.gpu
@pytest.mark.parametrize("hd,G,KV", [(64, 4, 8), (64, 1, 2), (128, 5, 8),
                                     (256, 10, 1), (256, 4, 2)])
@pytest.mark.parametrize("C", [37, 256])
def test_paged_chunk_bf16_matches_plain(cuda, hd, G, KV, C):
    rng = np.random.default_rng(C + hd + G)
    args, qo = _chunk_args(rng, BF16, cuda, G, KV, hd, C,
                           [0, 23, 256, 777, 1200])
    n = pa.paged_prefill_attention.launches
    got = pa.paged_prefill_attention(*args, qo)
    torch.cuda.synchronize()
    assert pa.paged_prefill_attention.launches == n + 1
    want = ref.paged_prefill_attention(*_up(*args[:3]), *args[3:], qo)
    _held(got, want.to(got.dtype), BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_paged_chunk_replays_in_cuda_graph(cuda, dtype):
    """K1's chunk path reads q_offset and kv_len on the card only and
    launches a grid fixed by shapes: captured once in a CUDA graph, a
    replay after new values are written into the captured tensors gives
    what the plain version gives for the new values."""
    rng = np.random.default_rng(22)
    C, G, KV, hd = 100, 4, 8, 64
    # tables sized for the largest offsets the replays write
    args, qo = _chunk_args(rng, dtype, cuda, G, KV, hd, C, [1150, 700, 1100, 300])
    qo.copy_(torch.tensor([0, 300, 700, 100], dtype=torch.int32))
    args[4].copy_(qo + C)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up: build and first launch
        pa.paged_prefill_attention(*args, qo)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_prefill_attention(*args, qo)
    for q_new in ([1150, 0, 64, 9], [5, 700, 1100, 300], [0, 0, 0, 0]):
        qo.copy_(torch.tensor(q_new, dtype=torch.int32))
        args[4].copy_(torch.tensor(q_new, dtype=torch.int32) + C)
        graph.replay()
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention(*_up(*args[:3]), *args[3:], qo)
        _held(out, want.to(out.dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("G,KV,hd", [(1, 2, 64), (4, 8, 64), (4, 2, 128),
                                     (5, 8, 128), (10, 1, 256), (10, 2, 64),
                                     (16, 1, 128), (17, 2, 256), (24, 1, 64),
                                     (64, 1, 128)])
def test_decode_kernel_matches_plain(cuda, G, KV, hd, dtype):
    """kv_len 1 (all but one split empty), 63 / 64 / 65 and 129 at and
    across 64-key split boundaries, 1000 = the cache's capacity."""
    rng = np.random.default_rng(G * 31 + hd)
    kv_len = np.array([1, 31, 63, 64, 65, 129, 300, 1000], np.int32)
    q, k, v, kl = _decode_inputs(rng, G, hd, KV=KV, S=1000, kv_len=kv_len)
    args = [_torch(x, dtype, cuda) for x in (q, k, v)] + \
        [torch.from_numpy(kl).to(cuda)]
    n = da.decode_attention.launches
    got = da.decode_attention(*args)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == n + 1
    want = ref.decode_attention(*_up(*args[:3]), args[3]).to(got.dtype)
    _held(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("G,hd", [(4, 64), (5, 128), (10, 256), (17, 64)])
def test_decode_kernel_int8_matches_plain(cuda, G, hd, dtype):
    rng = np.random.default_rng(G + hd)
    q, kf, vf, kl = _decode_inputs(rng, G, hd, KV=2, S=512,
                                   kv_len=(512, 7, 260, 1, 65))
    k8, v8, ks, vs = _int8_cache(kf, vf)
    args = [_torch(q, dtype, cuda)] + [torch.from_numpy(x).to(cuda)
                                       for x in (k8, v8, kl)]
    scales = dict(k_scale=torch.from_numpy(ks).to(cuda),
                  v_scale=torch.from_numpy(vs).to(cuda))
    got = da.decode_attention(*args, **scales)
    want = ref.decode_attention(args[0].float(), *args[1:], **scales)
    torch.cuda.synchronize()
    _held(got, want.to(got.dtype), dtype)


def _held_rel(got, want, dtype):
    """Outputs of int8 values: each sequence (row b) held to its own scale,
    its max abs error within the dtype's tolerance of its largest output
    and its relative Frobenius error within the same tolerance (a row of
    one key returns a V row, up to 127; a row of a thousand keys averages
    to a few units, and an error there must not hide under the first)."""
    for b, (g, w) in enumerate(zip(got.float(), want.float())):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        rel = (g - w).norm().item() / max(w.norm().item(), 1e-30)
        assert err <= TOL[dtype] * scale and rel <= TOL[dtype], \
            f"row {b}: max abs err {err} > {TOL[dtype]} x {scale} or relative error {rel}"


def _int8_kv(rng, shape):
    """K/V drawn N(0, 40^2) and narrowed as the model's cache writes are
    (``saturate_cast``): the whole int8 range, some values saturated."""
    from repro_torch.models.layers import saturate_cast
    return saturate_cast(torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 40),
                         torch.int8).numpy()


# an int8 pool (kv_dtype="int8") through K1's int8 instances: decode (the
# split body's FMA instance) and chunks (bf16: the tensor-core body staging
# int8 tiles; float32: the tiled body), at granite's and qwen's widths and
# recurrentgemma's head dim
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("G,KV,hd", [(4, 8, 64), (5, 8, 128), (10, 1, 256)])
@pytest.mark.parametrize("C", [1, 37, 256])
def test_paged_kernel_int8_pool_matches_plain(cuda, G, KV, hd, dtype, C):
    rng = np.random.default_rng(C + 7 * G + hd)
    page, P = 16, 80
    kv_len = np.array([1, 64, 65, 300, 1024, 1], np.int32) if C == 1 else \
        np.array([C, C + 23, C + 256, C + 768], np.int32)
    q, kp, _, bt, kl = _paged_inputs(rng, len(kv_len), C, G * KV, KV, hd, page, P,
                                     kv_len, dtype)
    q = q * 0.02     # scores over int8 keys a few units wide
    k8, v8 = _int8_kv(rng, kp.shape), _int8_kv(rng, kp.shape)
    args = [_torch(q, dtype, cuda)] + [torch.from_numpy(x).to(cuda)
                                       for x in (k8, v8, bt, kl)]
    if C == 1:
        n = pa.paged_decode_attention.launches
        got = pa.paged_decode_attention(*args)
        want = ref.paged_decode_attention(args[0].float(), *args[1:])
        assert pa.paged_decode_attention.launches == n + 1
    else:
        qo = torch.from_numpy(kv_len - C).to(cuda)
        n = pa.paged_prefill_attention.launches
        got = pa.paged_prefill_attention(*args, qo)
        want = ref.paged_prefill_attention(args[0].float(), *args[1:], qo)
        assert pa.paged_prefill_attention.launches == n + 1
    torch.cuda.synchronize()
    _held_rel(got, want.to(got.dtype), dtype)
    with pytest.raises(TypeError):          # an int8 K with a bf16 V pool
        pa.paged_decode_attention(args[0][:, :1].contiguous(), args[1],
                                  args[2].bfloat16(), *args[3:])


# K3 on an int8 cache with no scales (the model's int8 rings and dense
# caches pass none): ones, as the reference's decode_attention defaults
# them, bit for bit the launch with ones tensors
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("G,KV,hd,S", [(10, 1, 256, 2048), (4, 8, 64, 1024)])
def test_decode_kernel_int8_without_scales(cuda, G, KV, hd, S, dtype):
    rng = np.random.default_rng(G + S)
    kv_len = np.array([1, 63, 64, 65, 700, S, S // 2, 2], np.int32)
    q, _, _, kl = _decode_inputs(rng, G, hd, KV=KV, S=S, kv_len=kv_len)
    k8, v8 = (_int8_kv(rng, (len(kv_len), S, KV, hd)) for _ in range(2))
    args = [_torch(q * 0.02, dtype, cuda)] + [torch.from_numpy(x).to(cuda)
                                              for x in (k8, v8, kl)]
    got = da.decode_attention(*args)
    ones = torch.ones((len(kv_len), KV), dtype=torch.float32, device=cuda)
    with_ones = da.decode_attention(*args, k_scale=ones, v_scale=ones)
    want = ref.decode_attention(args[0].float(), *args[1:])
    torch.cuda.synchronize()
    _held_rel(got, want.to(got.dtype), dtype)
    assert torch.equal(got, with_ones)


# the full-width instances of the dense catalogue's two served archs:
# deepseek-7b (32 heads over 32 kv heads, G = 1, hd 128) through K2 and K1
# decode; qwen2.5-14b (40 over 8, G = 5, hd 128) through K1's 256-token
# chunks at q_offset 256 and 768 and K3 on the dense layout
CATALOGUE_CASES = ["k2_deepseek", "k1_decode_deepseek", "k1_chunk_qwen", "k3_dense_qwen"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", CATALOGUE_CASES)
def test_catalogue_instances_match_plain(cuda, case, dtype):
    rng = np.random.default_rng(CATALOGUE_CASES.index(case))
    if case == "k2_deepseek":
        q, k, v = (_torch(_np(rng, (1, 1024, 32, 128)), dtype, cuda) for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention(*_up(q, k, v), causal=True)
    elif case == "k1_decode_deepseek":
        kv_len = np.array([1, 37, 128, 255, 512, 700, 999, 1024], np.int32)
        q, kp, vp, bt, kl = _paged_inputs(rng, 8, 1, 32, 32, 128, 16, 64, kv_len, dtype)
        args = [_torch(x, dtype, cuda) for x in (q, kp, vp)] + \
            [torch.from_numpy(bt).to(cuda), torch.from_numpy(kl).to(cuda)]
        got = pa.paged_decode_attention(*args)
        want = ref.paged_decode_attention(*_up(*args[:3]), *args[3:])
    elif case == "k1_chunk_qwen":
        args, qo = _chunk_args(rng, dtype, cuda, 5, 8, 128, 256, [256, 768])
        got = pa.paged_prefill_attention(*args, qo)
        want = ref.paged_prefill_attention(*_up(*args[:3]), *args[3:], qo)
    else:
        q, k, v, kl = _decode_inputs(rng, 5, 128, KV=8, S=2048,
                                     kv_len=(1, 100, 511, 1024, 1500, 2000, 2047, 2048))
        args = [_torch(x, dtype, cuda) for x in (q, k, v)] + [torch.from_numpy(kl).to(cuda)]
        got = da.decode_attention(*args)
        want = ref.decode_attention(*_up(*args[:3]), args[3])
    torch.cuda.synchronize()
    _held(got, want.to(got.dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_kernels_replay_in_cuda_graph(cuda, dtype):
    """K1 decode and K3 read kv_len on the card only and launch a grid
    fixed by shapes: captured once in a CUDA graph, a replay after new
    kv_len values are written into the captured tensors gives what the
    plain versions give for the new values."""
    rng = np.random.default_rng(21)
    G, hd, page, P = 5, 128, 16, 32
    kv0 = [1, 100, 512, 300]
    q, kp, vp, bt, kl = _paged_inputs(rng, 4, 1, 8 * G, 8, hd, page, P,
                                      [P * page] * 4, dtype)
    pa_args = [_torch(q, dtype, cuda), _torch(kp, dtype, cuda),
               _torch(vp, dtype, cuda), torch.from_numpy(bt).to(cuda),
               torch.tensor(kv0, dtype=torch.int32, device=cuda)]
    dq, dk, dv, _ = _decode_inputs(rng, 10, 256, KV=1, S=2048, kv_len=kv0)
    da_args = [_torch(x, dtype, cuda) for x in (dq, dk, dv)] + \
        [torch.tensor(kv0, dtype=torch.int32, device=cuda)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up: build and first launch
        pa.paged_decode_attention(*pa_args)
        da.decode_attention(*da_args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_pa = pa.paged_decode_attention(*pa_args)
        out_da = da.decode_attention(*da_args)
    for kv_new in ([512, 1, 65, 2], [7, 511, 64, 129], [64, 64, 1, 512]):
        pa_args[4].copy_(torch.tensor(kv_new, dtype=torch.int32))
        da_args[3].copy_(torch.tensor([n * 4 for n in kv_new], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _held(out_pa, ref.paged_decode_attention(*_up(*pa_args[:3]), *pa_args[3:])
              .to(out_pa.dtype), dtype)
        _held(out_da, ref.decode_attention(*_up(*da_args[:3]), da_args[3])
              .to(out_da.dtype), dtype)


# ring-stage tails (S = 1, 31, 32, 33 around the kernel's 32-step stage,
# and 3000), channel tails (D = 16, 100, 2560, 2561 against 16, 32 and 64
# channels a block) and row alignments (float32 rows of 2561 take 4-byte
# copies; bf16 rows of 100 8-byte and of 2561 2-byte ones)
SCAN_TAIL_CASES = [(3, S, D) for S in (1, 31, 32, 33, 3000)
                   for D in (16, 100, 2560, 2561)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(1, 1, 100), (2, 13, 300), (1, 1000, 2560)]
                         + SCAN_TAIL_CASES)
def test_rglru_kernel_equals_plain(cuda, B, S, D, with_h0, dtype):
    """Bit for bit, at every channel count the plan offers and for rows
    one element off 16-byte alignment: the kernel's multiplies and adds are
    not contracted, and widening bf16 inputs to float32 is exact."""
    rng = np.random.default_rng(S + D)
    a, b, h0 = _scan_inputs(rng, B, S, D)
    a, b = _torch(a, dtype, cuda), _torch(b, dtype, cuda)
    h0 = _torch(h0, F32, cuda) if with_h0 else None
    want = ref.rglru_scan(a, b, h0)
    n = rs.rglru_scan.launches
    got = rs.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rs.rglru_scan.launches == n + 1 and got.dtype == torch.float32
    assert torch.equal(got, want)
    for ch in rs.CH_CHOICES:
        plan = rs.scan_plan(D, a.element_size(), a.data_ptr(), b.data_ptr(), ch=ch)
        assert torch.equal(rs.rglru_scan(a, b, h0, plan=plan), want), plan
    # the same rows one element past an aligned address
    off = []
    for x in (a, b):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        off.append(buf[1:].view(x.shape).copy_(x))
    plan = rs.scan_plan(D, a.element_size(), *(x.data_ptr() for x in off))
    assert plan.vec == a.element_size()
    assert torch.equal(rs.rglru_scan(*off, h0), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,chunk", FLASH_BWD_CASES + [
    (1, 1000, 1000, 32, 8, 64, True, 0, 0),      # granite's widths, ragged
    (1, 700, 700, 10, 1, 256, True, 300, 0),     # recurrentgemma's, window
    (1, 500, 500, 20, 4, 128, True, 0, 100),     # G = 5 at hd 128, chunk
    (1, 500, 520, 20, 4, 128, True, 0, 100),     # the same with Sq < Skv
    (2, 77, 77, 8, 8, 256, False, 0, 0),         # hd 256, G = 1, no mask
    (1, 1, 3, 4, 1, 128, True, 0, 0)])           # one query, three keys
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, hd, causal,
                                        window, chunk, dtype):
    """The backward kernel against ``ref.flash_attention_bwd`` on the same
    inputs (the bf16 ones widened to float32), float32 2e-5 and bf16 2e-2
    of max |grad|, and each 64-row block of the sequence within the same
    tolerance by its own relative error (late keys' dK and dV are far
    smaller than the first keys' under a causal mask); the forward with
    its log-sum-exp against the plain forward (output and log-sum-exp);
    a second launch gives the same bits (no atomics)."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v, do = (_torch(x, dtype, cuda) for x in
                   _flash_bwd_inputs(rng, B, Sq, Skv, H, KV, hd))
    kw = dict(causal=causal, window=window, chunk=chunk)
    out, lse = fa._forward(q, k, v, causal, window, chunk, None, True)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    want_out, want_lse = ref.flash_attention(*_up(q, k, v), **kw, return_lse=True)
    _held(out, want_out.to(q.dtype), dtype)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    n = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n + 2
    want = ref.flash_attention_bwd(*_up(q, k, v, out), lse, do.float(), **kw)
    for name, g, g2, w in zip("qkv", got, again, want):
        assert g.dtype == q.dtype and torch.equal(g, g2), name
        err = float((g.float() - w).abs().max() / w.abs().max())
        assert err <= TOL[dtype], f"d{name}: {err}"
        for i, (gb, wb) in enumerate(zip(g.float().split(64, dim=1), w.split(64, dim=1))):
            err = float((gb - wb).norm() / wb.norm().clamp(min=1e-30))
            assert err <= TOL[dtype], f"d{name} rows {64 * i}..: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(1, 1, 100), (2, 13, 300), (1, 1000, 2560),
                                   (1, 77, 2558)])
def test_rglru_bwd_kernel_equals_plain(cuda, B, S, D, with_h0):
    """The reverse scan kernel equals ``ref.rglru_scan_bwd`` bit for bit
    at every channel count of the plan (the same rounded multiplies and
    adds in the same order)."""
    rng = np.random.default_rng(S + D)
    a, _, h0 = _scan_inputs(rng, B, S, D)
    a, h, dh = (_torch(x, F32, cuda) for x in (a, _np(rng, (B, S, D)),
                                                _np(rng, (B, S, D))))
    h0 = _torch(h0, F32, cuda) if with_h0 else None
    want = ref.rglru_scan_bwd(a, h, dh, h0)
    n = rs.rglru_scan_bwd.launches
    got = rs.rglru_scan_bwd(a, h, dh, h0)
    torch.cuda.synchronize()
    assert rs.rglru_scan_bwd.launches == n + 1
    for ch in rs.CH_CHOICES:
        plan = rs.scan_plan(D, 4, a.data_ptr(), h.data_ptr(), ch=ch)
        for g, w in zip(rs.rglru_scan_bwd(a, h, dh, h0, plan=plan), want):
            assert (g is None and w is None) or torch.equal(g, w), plan
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


# group sizes, T, K, N: the edges of K4's backward (an empty group, a
# one-row group, rows past the total, one expert, K and N off the tiles)
# and llama4-scout's training shapes (4096 rows top-1 over 16 experts)
GPU_GMM_BWD_CASES = [
    ([0, 1, 300, 0, 77, 5], 400, 1000, 1000),
    ([200], 256, 264, 520),
    ([3, 0, 2], 6, 16, 8),
    ([256] * 16, 4096, 5120, 8192),
    ([240, 272] * 8, 4096, 8192, 5120),
    ([100, 0, 156], 300, 512, 768),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sizes,T,K,N", GPU_GMM_BWD_CASES)
def test_moe_gmm_bwd_kernel_matches_plain(cuda, sizes, T, K, N, dtype):
    """K4's backward kernels (dX and dW) against ``ref.moe_gmm_bwd`` on the
    same inputs: dX within float32 2e-5 and bf16 2**-7 (one bf16 ulp) of
    max |ref|, each expert's dW within the same share of its own max (an
    expert with few rows has a small dW), an empty group's dW and the
    uncovered rows' dX exactly zero; a second launch gives the same bits;
    either gradient alone equals the pair's."""
    rng = np.random.default_rng(T + K)
    x = _torch(_np(rng, (T, K)), dtype, cuda)
    w = _torch(_np(rng, (len(sizes), K, N)) / np.sqrt(K), dtype, cuda)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    dout = _torch(_np(rng, (T, N)), dtype, cuda)
    n = gm.moe_gmm_bwd.launches
    dx, dw = gm.moe_gmm_bwd(x, w, gs, dout)
    dx2, dw2 = gm.moe_gmm_bwd(x, w, gs, dout)
    only_dx, none = gm.moe_gmm_bwd(x, w, gs, dout, need_dw=False)
    none2, only_dw = gm.moe_gmm_bwd(x, w, gs, dout, need_dx=False)
    torch.cuda.synchronize()
    assert gm.moe_gmm_bwd.launches == n + 4 and none is None and none2 is None
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert torch.equal(dx, only_dx) and torch.equal(dw, only_dw)
    want_dx, want_dw = ref.moe_gmm_bwd(x, w, gs, dout)
    tol = 2e-5 if dtype == F32 else 2.0 ** -7
    assert dx.dtype == dw.dtype == x.dtype
    assert float((dx.float() - want_dx.float()).abs().max()) <= \
        tol * float(want_dx.float().abs().max())
    assert not dx[sum(sizes):].any()
    for e, g in enumerate(sizes):
        got, want = dw[e].float(), want_dw[e].float()
        if g == 0:
            assert not got.any(), e
        else:
            assert float((got - want).abs().max()) <= tol * float(want.abs().max()), e


# ----------------------------------------------------------------------
# the wgmma bodies of K2's and K4's backward: their launch geometry (plain
# functions the wrappers pass to the launchers) on the CPU, each body on
# the card
# ----------------------------------------------------------------------
# Sq, Skv, H, KV, causal, window, chunk
BWD_WALK_CASES = [
    (300, 300, 4, 2, True, 0, 0),
    (200, 520, 4, 2, True, 0, 0),      # Sq < Skv
    (300, 300, 2, 1, True, 100, 0),    # window
    (300, 300, 2, 2, True, 0, 96),     # chunk
    (300, 300, 2, 2, False, 0, 96),    # chunk alone
    (130, 130, 3, 3, False, 0, 0),     # no mask
    (1, 1, 10, 1, True, 0, 0),
]


def _visible(Sq, Skv, causal, window, chunk):
    qp, kp = np.arange(Skv - Sq, Skv)[:, None], np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if chunk:
        ok &= kp // chunk == qp // chunk
    return ok


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("Sq,Skv,H,KV,causal,window,chunk", BWD_WALK_CASES)
def test_flash_bwd_wgmma_walks_each_visible_tile_once(hd, Sq, Skv, H, KV, causal,
                                                      window, chunk):
    """Each pass of the wgmma body walks every (query tile, key tile) pair
    that holds a visible pair exactly once, for every head and batch, and
    no pair twice, the dK/dV pass with its heads in one group and in as
    many groups as fill the card; every block of its grid is a distinct
    tile."""
    B, G, t = 2, H // KV, fa.WGMMA_TILES[hd]
    vis = _visible(Sq, Skv, causal, window, chunk)
    n_dq, n_dkv = fa.wgmma_blocks(B, Sq, Skv, H, KV, hd)

    kbn, bq = t["kv_keys"], t["kv_rows"]
    # head groups: one, and as many as fill 132 SMs (at most G)
    for hs in sorted({1, fa.dkv_head_groups(B, Skv, H, KV, hd, 132)}):
        n_dkv = fa.wgmma_blocks(B, Sq, Skv, H, KV, hd, hs)[1]
        blocks = [fa.dkv_block(i, B, KV, hs) for i in range(n_dkv)]
        assert len(set(blocks)) == n_dkv == -(-Skv // kbn) * KV * B * hs
        seen = {}
        for kb, kvh, b, grp in blocks:
            for pt, g in fa.dkv_walk(kb, Sq, Skv, G, hd, causal, window, chunk, grp, hs):
                key = (b, kvh, g, kb, pt)
                assert key not in seen, key
                seen[key] = 1
        for kb in range(-(-Skv // kbn)):
            for pt in range(-(-Sq // bq)):
                if vis[pt * bq:pt * bq + bq, kb * kbn:kb * kbn + kbn].any():
                    assert all((b, kvh, g, kb, pt) in seen for b in range(B)
                               for kvh in range(KV) for g in range(G)), (kb, pt)

    qr, bk = t["q_rows"], t["q_keys"]
    blocks = [fa.dq_block(i, B, H, Sq, hd, causal) for i in range(n_dq)]
    assert len(set(blocks)) == n_dq == -(-Sq // qr) * H * B
    for qb, h, b in blocks:
        walk = fa.dq_walk(qb, Sq, Skv, hd, causal, window, chunk)
        assert len(set(walk)) == len(walk)
        for kt in range(-(-Skv // bk)):
            if vis[qb * qr:qb * qr + qr, kt * bk:kt * bk + bk].any():
                assert kt in walk, (qb, kt)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("Sq,Skv", [(2048, 2048), (512, 2048), (1000, 1000)])
def test_flash_bwd_wgmma_causal_order_is_heaviest_first(hd, Sq, Skv):
    """Under a causal mask both passes launch their blocks in order of
    falling work (live steps), so the heavy blocks start in the first
    wave."""
    B, H, KV = 2, 8, 2
    n_dq, n_dkv = fa.wgmma_blocks(B, Sq, Skv, H, KV, hd)
    work = [len(fa.dkv_walk(fa.dkv_block(i, B, KV)[0], Sq, Skv, H // KV, hd, True, 0, 0))
            for i in range(n_dkv)]
    assert work == sorted(work, reverse=True) and work[0] > work[-1]
    hs = 3          # head groups: key blocks still slowest
    n_dkv = fa.wgmma_blocks(B, Sq, Skv, H, KV, hd, hs)[1]
    work = [len(fa.dkv_walk(kb, Sq, Skv, H // KV, hd, True, 0, 0, grp, hs))
            for kb, _, _, grp in (fa.dkv_block(i, B, KV, hs) for i in range(n_dkv))]
    work = [sum(work[i:i + KV * B * hs]) for i in range(0, n_dkv, KV * B * hs)]
    assert work == sorted(work, reverse=True) and work[0] > work[-1]
    work = [len(fa.dq_walk(fa.dq_block(i, B, H, Sq, hd, True)[0], Sq, Skv, hd, True, 0, 0))
            for i in range(n_dq)]
    assert work == sorted(work, reverse=True) and work[0] > work[-1]


def test_wgmma_bodies_fit_shared_memory():
    """Every wgmma instance's dynamic shared memory (its operand boxes,
    ring, epilogue, barriers and alignment) is at most the 227 KB a block
    may take, and holds at least its operand tiles."""
    for hd, t in fa.WGMMA_TILES.items():
        dq, dkv = fa.wgmma_smem_bytes(hd)
        assert dq <= fa.SMEM_LIMIT and dkv <= fa.SMEM_LIMIT, hd
        assert dq > 2 * (t["q_rows"] + t["q_stages"] * t["q_keys"]) * hd * 2
        assert dkv > 2 * (t["kv_keys"] + t["kv_stages"] * t["kv_rows"]) * hd * 2
    dx, dw = gm.wgmma_smem_bytes()
    assert max(dx, dw) <= gm.SMEM_LIMIT
    assert min(dx, dw) > gm.W_STAGES * (gm.DX_ROWS + gm.W_COLS) * gm.W_DEPTH * 2


@pytest.mark.parametrize("sizes,T,K", [
    ([0, 1, 300, 0, 77, 5], 400, 1000), ([200], 256, 264), ([3, 0, 2], 6, 16),
    ([256] * 16, 4096, 5120), ([500, 500], 600, 512)])
def test_moe_gmm_bwd_wgmma_dx_tiles_cover_each_row_once(sizes, T, K):
    """The dX kernel's static order computes every row a group covers for
    every column tile of K exactly once, inside its group, in tiles of at
    most DX_ROWS rows; rows past the groups (or past T) are in no tile; an
    expert's row tiles of one column tile are adjacent."""
    tiles = gm.dx_tiles(sizes, T, K)
    n_ct = -(-K // gm.W_COLS)
    hits = np.zeros((T, n_ct), int)
    starts = np.concatenate([[0], np.cumsum([min(max(g, 0), T) for g in sizes])])
    for e, c, row0, rows in tiles:
        assert rows <= gm.DX_ROWS and row0 >= starts[e]
        if rows > 0:
            assert row0 + rows <= starts[e + 1]
            hits[row0:row0 + rows, c] += 1
    covered = min(starts[-1], T)
    assert (hits[:covered] == 1).all() and not hits[covered:].any()
    keys = [(e, c) for e, c, _, _ in tiles]
    assert keys == sorted(keys)


@pytest.mark.parametrize("E,K,N", [(16, 5120, 8192), (6, 1000, 1000), (1, 16, 8)])
def test_moe_gmm_bwd_wgmma_dw_tiles_cover_each_output_once(E, K, N):
    """The dW kernel's static order holds every (expert, K tile, N tile)
    once, experts slowest."""
    tiles = gm.dw_tiles(E, K, N)
    assert len(set(tiles)) == len(tiles) == \
        E * -(-K // gm.DW_KROWS) * -(-N // gm.W_COLS)
    assert tiles == sorted(tiles)


def test_moe_gmm_bwd_refuses_strides_tma_cannot_take():
    """TMA needs rows of a multiple of 16 bytes: the K4 backward's check
    raises for a bf16 K or N that is not a multiple of 8 (no fallback)."""
    for K, N in ((12, 8), (16, 4), (1000, 1001), (6, 6)):
        with pytest.raises(ValueError):
            gm.check_strides(K, N, torch.bfloat16)
    for K, N in ((16, 8), (264, 520), (1000, 1000), (5120, 8192)):
        gm.check_strides(K, N, torch.bfloat16)
        gm.check_strides(K, N, torch.float32)


@pytest.mark.gpu
def test_no_wrapper_cuts_the_gradient_on_the_card(cuda):
    """Under autograd on the card K2, K4 and K5 go through their Functions
    (gradients from the backward kernels reach every operand, each
    backward counted once), and K1 and K3, which have no backward kernel,
    raise instead of returning a detached output; under
    ``torch.no_grad()`` they run."""
    rng = np.random.default_rng(0)
    q, k, v, do = (_torch(x, BF16, cuda).requires_grad_() for x in
                   _flash_bwd_inputs(rng, 1, 64, 64, 8, 2, 64))
    n = fa.flash_attention_bwd.launches
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do.detach())
    assert fa.flash_attention_bwd.launches == n + 1
    assert all(float(g.float().abs().max()) > 0 for g in grads)
    a = torch.rand((1, 40, 64), device=cuda, requires_grad=True)
    b = torch.rand((1, 40, 64), device=cuda, requires_grad=True)
    h0 = torch.rand((1, 64), device=cuda, requires_grad=True)
    n = rs.rglru_scan_bwd.launches
    grads = torch.autograd.grad(rs.rglru_scan(a, b, h0).sum(), (a, b, h0))
    assert rs.rglru_scan_bwd.launches == n + 1
    assert all(float(g.abs().max()) > 0 for g in grads)
    x = q.reshape(-1, 64)[:48].detach().requires_grad_()
    w = (torch.randn((2, 64, 64), device=cuda) * 0.1).to(torch.bfloat16).requires_grad_()
    gs = torch.tensor([16, 32], dtype=torch.int32, device=cuda)
    n = gm.moe_gmm_bwd.launches
    out = gm.moe_gmm(x, w, gs)
    assert out.grad_fn.name() == "MoeGmmFnBackward"
    grads = torch.autograd.grad(out.float().square().sum(), (x, w))
    assert gm.moe_gmm_bwd.launches == n + 1
    assert all(float(g.float().abs().max()) > 0 for g in grads)
    qd = q[:, :1]
    kv_len = torch.tensor([64], dtype=torch.int32, device=cuda)
    pool = k.reshape(4, 16, 2, 64)
    tables = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    calls = {
        "decode_attention (K3)": lambda: da.decode_attention(qd, k, v, kv_len),
        "paged_decode_attention (K1)": lambda: pa.paged_decode_attention(
            qd, pool, pool, tables, kv_len),
        "paged_prefill_attention (K1)": lambda: pa.paged_prefill_attention(
            q[:, :16], pool, pool, tables, kv_len,
            torch.tensor([48], dtype=torch.int32, device=cuda)),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=re.escape(name)):
            call()
        with torch.no_grad():
            call()


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """granite ``.reduced()`` in float32: the step through the kernels on
    the card against the plain path on the CPU, the same weights and
    batch (losses within 1e-5, every leaf's gradient within 1e-4 x max|g|)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as TM
    from repro_torch.models.param import iter_leaves
    from repro_torch.train.train_loop import loss_and_grads
    tcfg = get_config("granite-3-2b").reduced()
    tp = TM.init_model_params(tcfg, 0, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in TokenPipeline(PipelineConfig(
        vocab=tcfg.vocab, seq_len=64, global_batch=2)).next_batch().items()}
    n = fa.flash_attention_bwd.launches
    l0, g0 = loss_and_grads(tcfg, tp, tb)
    dev_p = bridge.from_jax(bridge.to_numpy(tp), device=cuda)
    l1, g1 = loss_and_grads(tcfg, dev_p, {k: v.to(cuda) for k, v in tb.items()})
    assert fa.flash_attention_bwd.launches == n + tcfg.n_layers
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    want = dict(iter_leaves(g0))
    for path, g in iter_leaves(g1):
        w = want[path]
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()), path


@pytest.mark.gpu
def test_moe_train_step_on_the_card_matches_the_cpu(cuda):
    """llama4-scout ``.reduced()`` in float32: the step through K2, K4 and
    their backward kernels on the card against the plain path on the CPU,
    the same weights and batch (losses within 1e-5, every leaf's gradient
    within 1e-4 x max|g|), three K4 backward launches a layer."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as TM
    from repro_torch.models.param import iter_leaves
    from repro_torch.train.train_loop import loss_and_grads
    tcfg = get_config("llama4-scout-17b-a16e").reduced()
    tp = TM.init_model_params(tcfg, 0, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in TokenPipeline(PipelineConfig(
        vocab=tcfg.vocab, seq_len=80, global_batch=2)).next_batch().items()}
    l0, g0 = loss_and_grads(tcfg, tp, tb)
    dev_p = bridge.from_jax(bridge.to_numpy(tp), device=cuda)
    n = gm.moe_gmm_bwd.launches
    l1, g1 = loss_and_grads(tcfg, dev_p, {k: v.to(cuda) for k, v in tb.items()})
    assert gm.moe_gmm_bwd.launches == n + 3 * tcfg.n_layers
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    want = dict(iter_leaves(g0))
    for path, g in iter_leaves(g1):
        w = want[path]
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()), path


@pytest.mark.gpu
def test_remat_dots_on_the_card_equals_remat(cuda):
    """grok-1 ``.reduced()`` in float32 (top-2 MoE, two checkpointed
    periods): ``remat_policy="dots"`` on the card, selective checkpointing
    around the kernels' autograd Functions, gives the loss and gradients
    of plain ``remat=True`` (within 1e-6) and runs K2's and K4's backward."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as TM
    from repro_torch.models.param import iter_leaves
    from repro_torch.train.train_loop import loss_and_grads
    tcfg = get_config("grok-1-314b").reduced()
    tp = TM.init_model_params(tcfg, 0, cuda)
    tb = {k: torch.from_numpy(v).to(cuda) for k, v in TokenPipeline(PipelineConfig(
        vocab=tcfg.vocab, seq_len=64, global_batch=2)).next_batch().items()}
    l0, g0 = loss_and_grads(tcfg, tp, tb, remat=True)
    n = (fa.flash_attention_bwd.launches, gm.moe_gmm_bwd.launches)
    l1, g1 = loss_and_grads(tcfg, tp, tb, remat=True, remat_policy="dots")
    assert fa.flash_attention_bwd.launches > n[0] and gm.moe_gmm_bwd.launches > n[1]
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    want = dict(iter_leaves(g0))
    for path, g in iter_leaves(g1):
        torch.testing.assert_close(g, want[path], rtol=1e-6, atol=1e-7, msg=path)


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_operands(cuda):
    q = torch.zeros((1, 4, 4, 48), device=cuda)      # hd 48 not templated
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 4, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 1, 4, 64), device=cuda)
    k = torch.zeros((2, 8, 2, 64), device=cuda)
    kl = torch.ones((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # kv_len must be int32
        da.decode_attention(q, k, k, kl.long())
    with pytest.raises(TypeError):                    # int8 k, float32 v
        da.decode_attention(q, k.to(torch.int8), k, kl)
    with pytest.raises(TypeError):                    # bf16 cache, f32 q
        da.decode_attention(q, k.bfloat16(), k.bfloat16(), kl)
    a = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError):                   # h0 must be (B, D)
        rs.rglru_scan(a, a, torch.zeros((1, 4), device=cuda))
    with pytest.raises(TypeError):
        rs.rglru_scan(a, a.bfloat16())
    x, w = torch.zeros((4, 16), device=cuda), torch.zeros((2, 16, 8), device=cuda)
    gs = torch.tensor([2, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # dout must be (T, N)
        gm.moe_gmm_bwd(x, w, gs, torch.zeros((4, 16), device=cuda))
    with pytest.raises(ValueError):                   # dout in x's dtype
        gm.moe_gmm_bwd(x, w, gs, torch.zeros((4, 8), device=cuda).bfloat16())
    with pytest.raises(ValueError):                   # K = 12: no 16-byte rows
        gm.moe_gmm_bwd(x[:, :12].bfloat16().contiguous(), w[:, :12].bfloat16().contiguous(),
                       gs, torch.zeros((4, 8), device=cuda).bfloat16())


# ----------------------------------------------------------------------
# building and loading from several threads (a gateway's workers)
# ----------------------------------------------------------------------
def _run_together(n, fn):
    """Run ``fn`` on ``n`` threads released at once; their results."""
    barrier, got = threading.Barrier(n), []

    def work():
        barrier.wait(timeout=10.0)
        got.append(fn())
    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads) and len(got) == n
    return got


def test_concurrent_loads_share_one_handle(monkeypatch):
    """Two threads that reach a kernel's first launch together open its
    library once and get the same handle. The build is stubbed (no nvcc
    here) and both stubs are slow, so without the lock each thread would
    build and open a library of its own."""
    builds, opened = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.05)
        return {}

    def slow_open(path):
        time.sleep(0.05)
        opened.append(object())
        return opened[-1]
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", slow_open)
    a, b = _run_together(2, lambda: build.load("flash_attention"))
    assert a is b and opened == [a] and builds == [["flash_attention"]]
    assert build.load("flash_attention") is a and len(builds) == 1


@pytest.mark.gpu
def test_two_gateway_workers_build_a_kernel_once(cuda, tmp_path, monkeypatch):
    """Two EngineBackend workers launch K2 for the first time at once,
    into an empty build directory: one nvcc runs, both launches agree
    with the plain version."""
    from repro_torch.core.runtime import RuntimeDef
    from repro_torch.gateway import EngineBackend, Gateway
    compiles, popen = [], subprocess.Popen

    def counting_popen(cmd, *args, **kwargs):
        if str(cmd[0]).endswith("nvcc"):
            compiles.append(cmd[-1])
        return popen(cmd, *args, **kwargs)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(subprocess, "Popen", counting_popen)
    fa._launcher.cache_clear()
    rng = np.random.default_rng(0)
    q, k, v = (_torch(_np(rng, (1, 256, 32 if i == 0 else 8, 64)), BF16, cuda)
               for i in range(3))
    want = ref.flash_attention(*_up(q, k, v))
    barrier = threading.Barrier(2)

    def fn(data, config):
        barrier.wait(timeout=60.0)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        return (out.float() - want).abs().max().item()
    eb = EngineBackend(n_workers=2, batch_wait_s=0.0)
    try:
        gw = Gateway(eb)
        for rid in ("a", "b"):
            gw.register(RuntimeDef(rid, {}, fn=fn))
        futs = [gw.invoke(rid) for rid in ("a", "b")]
        errs = [f.result(extra_time_s=600.0) for f in futs]
    finally:
        eb.shutdown()
        fa._launcher.cache_clear()
    assert compiles == [str(build.CSRC / "flash_attention.cu")]
    assert {f.invocation.node for f in futs} == {"local/w0", "local/w1"}
    assert max(errs) <= TOL[BF16]


# ----------------------------------------------------------------------
# building from several processes (cluster workers on one card)
# ----------------------------------------------------------------------
RACE = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[2])
Path(sys.argv[3]).touch()                   # ready
go = Path(sys.argv[4])
while not go.exists():
    time.sleep(0.005)
print(json.dumps(build.build(["flash_attention"])))
"""


def test_two_processes_racing_to_build_compile_once(tmp_path):
    """Two processes released together call ``build()`` on an empty
    build directory, with ``nvcc`` replaced by a stub that logs each call
    and takes a second: one compiles, the other waits on the file lock
    and finds the library built. Without the lock both would compile."""
    bindir, out = tmp_path / "bin", tmp_path / "kernels"
    bindir.mkdir()
    calls = tmp_path / "nvcc.calls"
    stub = bindir / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$$" >> "{calls}"\n'
        "sleep 1\n"
        'prev=""; for a in "$@"; do [ "$prev" = "-o" ] && : > "$a"; '
        'prev="$a"; done\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src = str(Path(build.__file__).resolve().parents[2])
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACE, src, str(out), str(tmp_path / f"r{i}"),
         str(tmp_path / "go")], env=env, stdout=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        deadline = time.monotonic() + 60.0
        while not all((tmp_path / f"r{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline, "the racers never started"
            time.sleep(0.01)
        (tmp_path / "go").touch()
        results = [json.loads(p.communicate(timeout=60.0)[0]) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0]
    assert len(calls.read_text().split()) == 1            # one nvcc
    assert sorted(len(r) for r in results) == [0, 1]      # one built it
    built = [p for p in out.iterdir() if p.suffix == ".so"]
    assert [p.name for p in built] == [build.library_path(
        "flash_attention").name]
    assert (out / ".lock").exists()


CLUSTER_DRIVER = """
import json, sys, time
sys.path.insert(0, "src")
from repro_torch.cluster import start_cluster
from repro_torch.gateway import Gateway
h = start_cluster(2, lease_s=300.0, heartbeat_timeout_s=30.0, max_batch=4,
                  ready_timeout_s=60.0)
try:
    gw = Gateway(h.backend)
    rid = h.backend.register_spec("repro_torch.cluster.runtimes:serve_runtime",
                                  {"reduced": True, "max_batch": 4})
    run = {"max_new_tokens": 4}
    hooks = h.backend.capacity_hooks()
    assert hooks.prewarm(rid, run) and hooks.prewarm(rid, run)
    deadline = time.monotonic() + 300.0
    while sum(w["stats"].get("n_prewarms", 0)
              for w in h.backend.stats()["workers"].values()) < 2:
        assert time.monotonic() < deadline, "prewarms"
        time.sleep(0.05)
    futs = gw.map(rid, [{"prompts": [[5 + i, 9, 14] * (i + 1)]}
                        for i in range(8)], config=run)
    outs = [f.result(extra_time_s=600.0)["outputs"] for f in futs]
    print(json.dumps({"nodes": sorted({f.invocation.node for f in futs}),
                      "outputs": outs}))
finally:
    h.close()
"""


@pytest.mark.gpu
def test_two_cluster_workers_build_each_kernel_once(cuda, tmp_path):
    """Two cluster worker processes on one card, prewarmed, serve their
    first batches together from a fresh checkout whose build directory
    is empty: each kernel library on their path (K2, K1) is compiled
    once, by one process, and the other loads it."""
    checkout = tmp_path / "checkout"
    shutil.copytree(Path(build.__file__).resolve().parents[1],
                    checkout / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bindir, calls = tmp_path / "bin", tmp_path / "nvcc.calls"
    bindir.mkdir()
    stub = bindir / "nvcc"
    stub.write_text(f'#!/bin/sh\necho "$$ $@" >> "{calls}"\n'
                    f'exec "{build.nvcc_path()}" "$@"\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", CLUSTER_DRIVER], cwd=checkout,
                       env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stdout + p.stderr
    seen = json.loads(p.stdout.strip().splitlines()[-1])
    assert seen["nodes"] == ["w0", "w1"]
    assert all(len(o) >= 1 for out in seen["outputs"] for o in out)
    sources = sorted(Path(line.split()[-1]).name
                     for line in calls.read_text().splitlines())
    assert sources == ["flash_attention.cu", "paged_attention.cu"]
