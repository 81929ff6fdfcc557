"""The port's kernels (K1 paged, K2 flash, K3 decode attention, K5 RG-LRU
scan) against the JAX package's; K4 (``moe_gmm``) is held in
``tests/test_torch_moe.py``.

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
import numpy as np
import pytest
import torch

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


GPU_FLASH_CASES = FLASH_CASES + [
    (1, 1000, 32, 8, 64, True, 0, 0, BF16),     # granite prefill width
    (1, 1000, 32, 8, 64, True, 0, 0, F32),
    (2, 77, 8, 8, 256, False, 0, 0, BF16),
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


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,dtype", PAGED_CASES + [(4, 256, BF16)])
@pytest.mark.parametrize("C", [1, 5, 70])
def test_paged_kernel_matches_plain(cuda, G, hd, dtype, C):
    rng = np.random.default_rng(C * 13 + G + hd)
    KV, page, P = 2, 16, 16
    if C == 1:
        kv_len = np.array([13, 200, 1, 64, 1], np.int32)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("G,KV,hd", [(1, 2, 64), (4, 8, 64), (4, 2, 128),
                                     (10, 1, 256), (10, 2, 64), (24, 1, 64),
                                     (64, 1, 128)])
def test_decode_kernel_matches_plain(cuda, G, KV, hd, dtype):
    rng = np.random.default_rng(G * 31 + hd)
    kv_len = np.array([1, 31, 32, 33, 300, 1000], np.int32)   # 1000 = full
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
@pytest.mark.parametrize("G,hd", [(4, 64), (10, 256)])
def test_decode_kernel_int8_matches_plain(cuda, G, hd, dtype):
    rng = np.random.default_rng(G + hd)
    q, kf, vf, kl = _decode_inputs(rng, G, hd, KV=2, S=512,
                                   kv_len=(512, 7, 260))
    k8, v8, ks, vs = _int8_cache(kf, vf)
    args = [_torch(q, dtype, cuda)] + [torch.from_numpy(x).to(cuda)
                                       for x in (k8, v8, kl)]
    scales = dict(k_scale=torch.from_numpy(ks).to(cuda),
                  v_scale=torch.from_numpy(vs).to(cuda))
    got = da.decode_attention(*args, **scales)
    want = ref.decode_attention(args[0].float(), *args[1:], **scales)
    torch.cuda.synchronize()
    _held(got, want.to(got.dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(1, 1, 100), (2, 13, 300), (1, 1000, 2560)])
def test_rglru_kernel_equals_plain(cuda, B, S, D, with_h0, dtype):
    """Bit for bit: the kernel's multiplies and adds are not contracted,
    and widening bf16 inputs to float32 is exact."""
    rng = np.random.default_rng(S + D)
    a, b, h0 = _scan_inputs(rng, B, S, D)
    a, b = _torch(a, dtype, cuda), _torch(b, dtype, cuda)
    h0 = _torch(h0, F32, cuda) if with_h0 else None
    n = rs.rglru_scan.launches
    got = rs.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rs.rglru_scan.launches == n + 1 and got.dtype == torch.float32
    assert torch.equal(got, ref.rglru_scan(a, b, h0))


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
    with pytest.raises(ValueError):                   # int8 needs scales
        da.decode_attention(q, k.to(torch.int8), k.to(torch.int8), kl)
    with pytest.raises(TypeError):                    # bf16 cache, f32 q
        da.decode_attention(q, k.bfloat16(), k.bfloat16(), kl)
    a = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError):                   # h0 must be (B, D)
        rs.rglru_scan(a, a, torch.zeros((1, 4), device=cuda))
    with pytest.raises(TypeError):
        rs.rglru_scan(a, a.bfloat16())
