"""The split decode body's tensor-core instance over an int8 cache (K1's
decode and K3 with bf16 queries, ``csrc/decode_common.cuh``), modelled
plainly and held against the JAX package on the CPU.

The CUDA kernel runs only on the card (its ``gpu`` cases are in
``tests/test_torch_kernels.py``). Here a plain model of its arithmetic,
written below, goes through the same numpy inputs as the reference's
Pallas bodies in interpret mode: bf16 queries, the int8 K/V widened
exactly, float32 scores multiplied by the softmax scale (times log2 e) and
the key scale after the product, each warp's 16 keys of a 64-key tile with
its own online softmax, P rounded to bf16 before P V, float32 sums, the
four warps merged at the end of a range and the key ranges (splits) merged
as the merge kernel does. The widening's bit arithmetic (a byte placed
under the exponent of 2^23, one float subtraction, the upper half kept) is
checked over all 256 int8 values, and the permuted fragment index maps
lane by lane. JAX is imported inside the tests.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

torch.set_num_threads(1)

NEG_INF = -1e30
LOG2E = 1.4426950408889634
TILE, WARP_KEYS = 64, 16       # keys per tile, keys per warp
# The model against the reference: both outputs round once to bf16 (2^-9
# relative each), and the model rounds P to bf16 before P V (2^-9 a term,
# of either sign, so it averages over a row's keys; the card's reading of
# the same departure against the float32 FMA instance is held to 2^-8).
# 2^-7 x max|ref| holds the three.
TOL_REL = 2.0 ** -7
# kv_len 0 (no key), 1, a 64-key tile boundary at and across (64, 65), two
# tiles and a part (130), and the full cache
S = 200
KV_LEN = [0, 1, 64, 65, 130, S]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _range_state(q, k, v, lo, hi, s_scale, p_bf16):
    """One block's range [lo, hi) of keys for the rows of q (R, hd): the
    tiles' warps, each with its own online softmax (log2 units), merged as
    the block's warp merge does. Returns (M, L, A) over the rows."""
    R, hd = q.shape
    ms, ls, accs = [], [], []
    for w in range(TILE // WARP_KEYS):
        m = torch.full((R,), NEG_INF)
        l = torch.zeros(R)
        acc = torch.zeros(R, hd)
        for t0 in range(lo, hi, TILE):
            k0 = t0 + w * WARP_KEYS
            keys = torch.arange(k0, k0 + WARP_KEYS)
            live = keys < hi
            kk = keys.clamp(max=k.shape[0] - 1)
            s = (q @ k[kk].T) * s_scale                    # float32 sums, then the scale
            s = torch.where(live[None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(dim=1).values)
            alpha = torch.exp2(m - m_new)
            p = torch.where(live[None], torch.exp2(s - m_new[:, None]), torch.zeros_like(s))
            l = l * alpha + p.sum(dim=1)
            acc = acc * alpha[:, None] + (_bf16(p) if p_bf16 else p) @ v[kk]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = m.max(dim=0).values
    wt = torch.exp2(m - M)
    return M, (wt * l).sum(0), (wt[:, :, None] * acc).sum(0)


def tensor_core_model(q, k, v, kv_len, n_split, *, k_scale=None, v_scale=None,
                      p_bf16=True):
    """The int8 instance's arithmetic: q (B, 1, H, hd) bf16, k and v (B, S,
    KV, hd) int8, kv_len (B,). Returns (out in q's dtype, lse (B, H) in
    natural log, -inf for a row with no key). ``p_bf16=False`` keeps P in
    float32: the same schedule with the Pallas body's numerics."""
    B, _, H, hd = q.shape
    _, Sc, KV, _ = k.shape
    G = H // KV
    out = torch.zeros(B, H, hd)
    lse = torch.full((B, H), -math.inf)
    for b in range(B):
        kvl = min(int(kv_len[b]), Sc)
        per = -(-(-(-kvl // n_split)) // TILE) * TILE
        for h in range(KV):
            kf, vf = k[b, :, h].float(), v[b, :, h].float()     # exact widening
            ks = float(k_scale[b, h]) if k_scale is not None else 1.0
            vs = float(v_scale[b, h]) if v_scale is not None else 1.0
            s_scale = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32) * ks
            rows = q[b, 0, h * G:(h + 1) * G].float()
            parts = []
            for s in range(n_split):
                lo, hi = s * per, min(s * per + per, kvl)
                if lo < hi:
                    M, L, A = _range_state(rows, kf, vf, lo, hi, s_scale, p_bf16)
                    parts.append((M, L, A * vs))
            if not parts:
                continue
            M = torch.stack([p[0] for p in parts]).max(dim=0).values
            L = sum(torch.exp2(p[0] - M) * p[1] for p in parts)
            A = sum(torch.exp2(p[0] - M)[:, None] * p[2] for p in parts)
            out[b, h * G:(h + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
            lse[b, h * G:(h + 1) * G] = M * math.log(2) + torch.log(L)
    return out.reshape(B, 1, H, hd).to(q.dtype), lse


def _int8_kv(rng, shape):
    """K/V drawn N(0, 40^2) and narrowed as the model's cache writes are
    (saturating): the whole int8 range, some values saturated."""
    return np.clip(np.round(rng.standard_normal(shape) * 40), -128, 127).astype(np.int8)


def _inputs(seed, G, hd, KV=2, kv_len=KV_LEN, Sc=S):
    rng = np.random.default_rng(seed)
    B = len(kv_len)
    q = (rng.standard_normal((B, 1, G * KV, hd)) * 0.02).astype(np.float32)
    q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()    # bf16 values
    k8, v8 = _int8_kv(rng, (B, Sc, KV, hd)), _int8_kv(rng, (B, Sc, KV, hd))
    ks = rng.uniform(0.5, 1.5, (B, KV)).astype(np.float32)
    vs = rng.uniform(0.5, 1.5, (B, KV)).astype(np.float32)
    return q, k8, v8, np.asarray(kv_len, np.int32), ks, vs


def _held(got, want, tol=TOL_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * scale, f"max abs err {err} > {tol} x max|ref| {scale}"


def _bf16_np(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("scales", [False, True])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("G,hd", [(4, 64), (5, 128)])
def test_model_matches_pallas_decode(G, hd, n_split, scales):
    """The model against the reference's Pallas decode body in interpret
    mode on an int8 cache, with and without scales, bf16 queries."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as pallas_dec
    q, k8, v8, kl, ks, vs = _inputs(10 * G + hd + n_split, G, hd)
    kw = dict(k_scale=ks, v_scale=vs) if scales else {}
    got, lse = tensor_core_model(
        _bf16_np(q), torch.from_numpy(k8), torch.from_numpy(v8), kl, n_split,
        **{n: torch.from_numpy(x) for n, x in kw.items()})
    want = pallas_dec(jnp.asarray(q, jnp.bfloat16), k8, v8, kl, interpret=True,
                      block_kv=128, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _held(_f32(got), _f32(want))
    assert (got[0] == 0).all() and torch.isneginf(lse[0]).all()
    # the log-sum-exp of the scaled scores, as K3's return_lse gives it
    _, want_lse = ref.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(kl), return_lse=True,
        **{n: torch.from_numpy(x) for n, x in kw.items()})
    np.testing.assert_allclose(lse[1:].numpy(), want_lse[1:].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("G,hd", [(4, 64), (5, 128)])
def test_paged_model_matches_pallas_paged_decode(G, hd, n_split):
    """The paged twin: the model over the pages gathered through the block
    tables against the reference's paged Pallas body in interpret mode on
    an int8 pool (unit scales)."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import paged_decode_attention as pallas_paged
    rng = np.random.default_rng(70 + G + n_split)
    page, P, KV = 16, 16, 2
    kv_len = np.array([0, 1, 64, 65, 130, P * page], np.int32)
    n_pages = 1 + sum(-(-int(n) // page) for n in kv_len)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(kv_len), P), np.int32)
    used = 0
    for b, n in enumerate(kv_len):
        need = -(-int(n) // page)
        bt[b, :need] = perm[used:used + need]
        used += need
    q = torch.from_numpy((rng.standard_normal((len(kv_len), 1, G * KV, hd)) * 0.02)
                         .astype(np.float32)).to(torch.bfloat16)
    kp, vp = _int8_kv(rng, (n_pages, page, KV, hd)), _int8_kv(rng, (n_pages, page, KV, hd))
    tbt = torch.from_numpy(bt)
    got, _ = tensor_core_model(q, ref.gather_pages(torch.from_numpy(kp), tbt),
                               ref.gather_pages(torch.from_numpy(vp), tbt), kv_len, n_split)
    want = pallas_paged(jnp.asarray(q.float().numpy(), jnp.bfloat16), kp, vp, bt, kv_len,
                        interpret=True)
    _held(_f32(got), _f32(want))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("n_split", [1, 3])
def test_model_schedule_is_the_plain_version(n_split):
    """With P kept in float32 the model's schedule (warps, tiles, splits and
    both merges) is the plain version's arithmetic: float32 within 2e-5. P
    in bf16 moves it by under 2^-8 x max|ref|, the card's reading of the
    kernel against the float32 FMA instance."""
    q, k8, v8, kl, ks, vs = _inputs(5 + n_split, 4, 64)
    args = (torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8))
    scales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    exact, _ = tensor_core_model(*args, kl, n_split, p_bf16=False, **scales)
    want = ref.decode_attention(*args, torch.from_numpy(kl), **scales)
    np.testing.assert_allclose(exact.numpy(), want.numpy(), atol=2e-5 * np.abs(want.numpy()).max())
    bf16_p, _ = tensor_core_model(*args, kl, n_split, **scales)
    _held(bf16_p.numpy(), want.numpy(), tol=2.0 ** -8)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) on uint32 numpy arrays: byte n of the
    result is byte (s >> 4n) & 7 of the eight bytes y:x (x the lower four)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _widen_byte(u, k):
    """decode_common.cuh's widen_byte(u, k): byte k of u = w ^ 0x80808080
    under the exponent of 2^23, minus 2^23 + 128, as a float32."""
    f = _byte_perm(u, np.uint32(0x4B000000), 0x7440 + k).view(np.float32)
    return f - np.float32(8388736.0)


def _pack_exact(lo, hi):
    """decode_common.cuh's pack_exact: the upper halves of two floats."""
    return _byte_perm(lo.view(np.uint32), hi.view(np.uint32), 0x7632)


def test_widening_bit_arithmetic_is_exact_over_int8():
    """Every int8 value, in each byte position of a word, widens to itself
    exactly, and its bf16 is the float's upper half with nothing below it."""
    vals = np.arange(-128, 128, dtype=np.int32)
    for k in range(4):
        words = ((vals & 0xFF).astype(np.uint32) << np.uint32(8 * k)) | \
            np.uint32(0x5A5A5A5A & ~(0xFF << (8 * k)))
        f = _widen_byte(words ^ np.uint32(0x80808080), k)
        np.testing.assert_array_equal(f, vals.astype(np.float32))
        assert not (f.view(np.uint32) & np.uint32(0xFFFF)).any()


def test_widened_pairs_are_torch_bf16():
    """Four bytes of a word widened and packed in pairs (as the K
    fragments are: bytes 0, 1 then 2, 3, the lower byte in the lower half)
    give the bf16 bits torch gives the same int8 values."""
    rng = np.random.default_rng(0)
    b = rng.integers(-128, 128, size=(4096, 4)).astype(np.int8)
    w = b.view(np.uint32).reshape(-1)
    u = w ^ np.uint32(0x80808080)
    f = [_widen_byte(u, k) for k in range(4)]
    bits = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().astype(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(_pack_exact(f[0], f[1]), bits[:, 0] | (bits[:, 1] << 16))
    np.testing.assert_array_equal(_pack_exact(f[2], f[3]), bits[:, 2] | (bits[:, 3] << 16))


def _k_stride(hd):
    """The int8 K tile's row stride in bytes (MmaShape::KLD)."""
    return hd if hd % 128 else hd + 64


def _v_piece(hd):
    """The bytes a thread reads of a V row at once (VP) and the dim of
    output n-block nb's column c (v_dim)."""
    vp = min(hd // 8, 16)
    return vp, lambda nb, c: (nb // 16) * 128 + c * vp + nb % 16


def _q_column(d):
    """The column of Q's permuted shared-memory row that dim d (even) and
    d + 1 go to."""
    return (4 * (d // 64) + d % 16 // 4) * 16 + 2 * (d % 64 // 16) + 8 * (d % 4 // 2)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_fragment_index_maps(hd):
    """The int8 instance's index maps, lane by lane, for one warp's 16
    keys: Q stored in the permuted order and read by ldmatrix, K's bytes
    64c + 16t + 4e .. + 3 of key 8j + g as k-step 4c + e's B fragment, V's
    bytes of keys 2t, 2t + 1, 2t + 8, 2t + 9 at 128h + g VP + 4x + e as
    n-block 16h + 4x + e's, the output dims put back by v_dim: S = Q K^T and
    O = P V exactly (mma.sync m16n8k16's fragment layouts), every dim once;
    and the K and V reads free of bank conflicts (a quarter warp a phase for
    16-byte reads, a half warp for 8-byte ones)."""
    rng = np.random.default_rng(hd)
    Q = rng.standard_normal((16, hd))
    K = rng.integers(-128, 128, (16, hd)).astype(np.float64)
    V = rng.integers(-128, 128, (16, hd)).astype(np.float64)
    P = rng.standard_normal((16, 16))
    Qs = np.zeros((16, hd))
    for d in range(0, hd, 2):
        Qs[:, _q_column(d):_q_column(d) + 2] = Q[:, d:d + 2]
    S_ = np.zeros((16, 16))
    for c in range(hd // 64):
        for e in range(4):
            A = Qs[:, (4 * c + e) * 16:(4 * c + e + 1) * 16]
            for j in range(2):
                B = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    d = 64 * c + 16 * t + 4 * e
                    B[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], g] = K[8 * j + g, d:d + 4]
                S_[:, 8 * j:8 * j + 8] += A @ B
    np.testing.assert_allclose(S_, Q @ K.T, rtol=1e-12, atol=1e-9)
    vp, v_dim = _v_piece(hd)
    O = np.zeros((16, hd))
    for h in range(hd // 8 // vp):
        for x in range(vp // 4):
            for e in range(4):
                nb = 16 * h + 4 * x + e
                B = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    keys = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                    B[keys, g] = V[keys, 128 * h + g * vp + 4 * x + e]
                C = P @ B
                for n in range(8):
                    O[:, v_dim(nb, n)] += C[:, n]
    np.testing.assert_allclose(O, P @ V, rtol=1e-12, atol=1e-9)
    assert sorted(v_dim(nb, n) for nb in range(hd // 8) for n in range(8)) == list(range(hd))
    kld, vld = _k_stride(hd), hd + 16
    for c in range(hd // 64):
        for j in range(2):
            for phase in range(4):
                banks = [(((8 * j + (lane >> 2)) * kld + 64 * c + 16 * (lane & 3)) // 4 + i) % 32
                         for lane in range(8 * phase, 8 * phase + 8) for i in range(4)]
                assert len(set(banks)) == 32
    per = 128 // vp                     # lanes a phase
    for h in range(hd // 8 // vp):
        for kq in range(4):
            for phase in range(32 // per):
                banks = []
                for lane in range(per * phase, per * phase + per):
                    g, t = lane >> 2, lane & 3
                    row = 2 * t + (kq & 1) + 8 * (kq >> 1)
                    banks += [((row * vld + 128 * h + g * vp) // 4 + i) % 32
                              for i in range(vp // 4)]
                assert len(set(banks)) == 32
