// bf16 prefill attention on the tensor cores for Hopper (sm_90a), CUDA C++:
// the one body of K2 (flash_attention.cu, contiguous keys) and K1's chunks
// (paged_attention.cu, C > 1, block-table keys).
//
// Replaces the prefill schedule of the Pallas TPU kernels _attn_kernel /
// flash_attention (src/repro/kernels/flash_attention.py:27, :88) and
// _paged_kernel / _paged_attention (src/repro/kernels/decode_attention.py
// :135, :182) at C > 1: online-softmax GQA attention of a sequence's query
// rows against its keys, with causal, sliding-window, same-chunk or no
// mask, skipping key tiles the mask leaves empty.
//
// What bounds it on the H100: at prefill lengths (hundreds to thousands of
// tokens) attention does ~4*hd operations per (query, key) pair on inputs
// read once, far above the ~295 operations per byte where the tensor cores
// and not the 3.35 TB/s memory become the limit, so it is bound by the
// tensor cores' rate. Every intermediate stays out of device memory, and
// each K/V tile is read once per kv head and shared by the G query heads
// of its group: a block row is a (query position, head of the group) pair.
//
// FlashAttention-2 in shape. A block of 4 warps owns 64 query rows, 16 per
// warp (one m16 row block of mma.sync.m16n8k16, bf16 products summed in
// float32). Key tiles of 64 keys stream through a 2-stage ring of shared
// memory filled by 16-byte cp.async (zero-filled past the sequence's
// keys), the next tile in flight while this one computes. Where a key row
// lives is the Cache's business (attention_common.cuh): DenseCache for
// K2's (B, S, KV, hd), PagedCache for K1's pool, whose physical page is
// read from block_tables[b, kp / page] as each row's copy is issued, so
// pages are never gathered into a contiguous copy. Per sequence the caller
// gives the absolute position of the first query row (qbase: Skv - Sq for
// K2, q_offset[b] for K1) and the number of valid keys (kv_len: Skv for
// K2, min(kv_len[b], P * page) for K1), both read on the device, so the
// grid (ceil(Sq * G / 64), KV, B) depends on shapes only and a launch can
// be captured in a CUDA graph. The live key tiles form one interval, cut
// by the causal limit.
//
// Q goes global -> shared by cp.async and from there into A fragments
// (ldmatrix); K is stored row-major in hd, which is the .col B operand
// as stored (ldmatrix), V needs ldmatrix.trans. Rows are padded by 16 bytes
// so the 8 rows an ldmatrix phase reads fall in 8 different bank groups.
// Scores stay in float32 registers; the softmax scale (times log2 e) is
// applied to them, not to q, so q is not rounded twice; masks are applied
// per element on the accumulator fragment (row lane/4 (+8), column
// 2*(lane%4) (+1)) and only in tiles the mask cuts; row max and sum take
// two shuffles within the quad of lanes that share a row. P becomes the
// bf16 A fragment of P @ V in registers, with no trip through shared
// memory. That rounds p to bf16 where the Pallas body keeps it in float32:
// a relative error of at most 2^-9 per term, the one numeric departure
// (the running sum l is taken over the float32 p). At hd 256 a warp's
// 16 x 256 float32 accumulator is already 128 registers a thread, so Q's
// fragments are re-read from shared memory per k-step instead of held in
// registers (hd 64 and 128 hold them). wgmma, TMA and warp specialisation
// are the step beyond. Numerics follow the Pallas bodies: NEG_INF = -1e30
// rather than -inf, l clamped at 1e-30 and one division at the end.
//
// Given an lse pointer (K2 under autograd), each row's log-sum-exp of its
// scaled scores in natural-log units, m * ln 2 + log(l) from the running
// log2-domain max and sum, goes to lse (B, H, Sq) float32 for the
// backward; a null pointer (serving, K1's chunks) stores nothing, so those
// paths run as before.
//
// An int8 pool (K1's chunks over a pool from kv_dtype="int8", TKV =
// int8_t) is staged as int8: the cp.async ring carries 16 keys' bytes a
// copy, half the bf16 bytes, and once a tile has landed the block widens it
// into one bf16 tile (every int8 value is exact in bf16) behind one more
// barrier, so ldmatrix and the mma.sync products are those of the bf16 body
// on exact inputs, and the scores and output are the bf16 body's on the
// widened keys. The next tile's int8 copies are in flight meanwhile.
//
// 128 threads; dynamic shared memory 2 * (64 + 2 * 2 * 64) * (hd + 8)
// bytes (46 KB at hd 64, 87 KB at hd 128, 169 KB at hd 256); with an int8
// pool 2 * (64 + 2 * 64) * (hd + 8) + 2 * 2 * 64 * hd bytes (43, 83 and
// 163 KB).
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace pf {

using bf16 = __nv_bfloat16;
constexpr int MW = 4;          // warps per block
constexpr int MT = 32 * MW;    // threads per block
constexpr int MBQ = 16 * MW;   // query rows per block
constexpr int MBK = 64;        // keys per tile
constexpr int STAGES = 2;      // K/V tiles in the ring

template <int HD, typename TKV = bf16>
struct MmaTile {
  static constexpr int LD = HD + 8;   // padded row: ldmatrix free of bank conflicts
  static constexpr int Q_ELEMS = MBQ * LD;
  static constexpr int KV_ELEMS = MBK * LD;   // one bf16 K or V tile
  // an int8 pool: the ring holds int8 tiles (rows of HD bytes), widened
  // into one bf16 tile each of K and V; a bf16 pool: the ring is bf16
  static constexpr bool NARROW = !std::is_same_v<TKV, bf16>;
  static constexpr int BF_STAGES = NARROW ? 1 : STAGES;
  static constexpr int LDS = NARROW ? HD : LD;   // a ring row, in TKV elements
  static constexpr int ST_ELEMS = MBK * LDS;     // one ring tile of K or V
  static constexpr size_t SMEM = sizeof(bf16) * (Q_ELEMS + 2 * BF_STAGES * KV_ELEMS) +
                                 (NARROW ? sizeof(TKV) * 2 * STAGES * ST_ELEMS : 0);
  static constexpr bool Q_IN_REGS = HD <= 128;
};

// 16 int8 values widened to bf16 (exact), shared -> shared: byte j of the
// 16 is value j (little-endian words), values 2i and 2i + 1 one bf16 pair
__device__ __forceinline__ void widen16(const int8_t* src, bf16* dst) {
  const int4 u = *reinterpret_cast<const int4*>(src);
  const uint32_t w[4] = {(uint32_t)u.x, (uint32_t)u.y, (uint32_t)u.z, (uint32_t)u.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = w[i / 2] >> (16 * (i % 2));
    o[i] = mma::pack_bf16((float)(int8_t)(x & 0xffu), (float)(int8_t)((x >> 8) & 0xffu));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// The block (blockIdx.x: 64 query rows, .y: kv head, .z: sequence b) of a
// prefill. q and out are (B, Sq, H, HD); row r is query position r / G of
// head kvh * G + r % G, at absolute position qbase + r / G; keys [0,
// kv_len) of cache are valid. K and V are bf16, or int8 (TKV) widened.
template <int HD, class Cache, typename TKV = bf16>
__device__ __forceinline__ void prefill_mma(const bf16* __restrict__ q,
                                            const TKV* __restrict__ k,
                                            const TKV* __restrict__ v, bf16* __restrict__ out,
                                            int Sq, int H, int KV, int qbase, int kv_len,
                                            int causal, int window, int chunk, float scale_log2,
                                            const Cache& cache,
                                            float* __restrict__ lse = nullptr) {
  using Tile = MmaTile<HD, TKV>;
  constexpr int LD = Tile::LD, LDS = Tile::LDS;
  constexpr int KC = HD / 8;     // 16-byte chunks per bf16 row
  constexpr int KCS = HD * (int)sizeof(TKV) / 16;   // 16-byte chunks per ring row
  constexpr int ECS = 16 / (int)sizeof(TKV);        // elements per chunk
  constexpr int NKB = MBK / 8;   // n8 blocks of scores per tile
  constexpr int NDB = HD / 8;    // n8 blocks of the output
  static_assert(HD % 16 == 0 && (MBQ * KC) % MT == 0 && (MBK * KCS) % MT == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + Tile::Q_ELEMS;                    // [BF_STAGES][MBK][LD]
  bf16* Vs = Ks + Tile::BF_STAGES * Tile::KV_ELEMS;  // [BF_STAGES][MBK][LD]
  // the ring: the bf16 tiles themselves, or int8 tiles after them
  TKV* Kr = reinterpret_cast<TKV*>(Tile::NARROW ? Vs + Tile::KV_ELEMS : Ks);
  TKV* Vr = Tile::NARROW ? Kr + STAGES * Tile::ST_ELEMS : reinterpret_cast<TKV*>(Vs);

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = H / KV, rows = Sq * G, r0 = blockIdx.x * MBQ;
  const long long q_seq0 = (long long)b * Sq * H * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Q tile: block row lr is query position (r0 + lr) / G of head
  // kvh * G + (r0 + lr) % G; rows past the last are zero-filled
#pragma unroll
  for (int i = 0; i < MBQ * KC / MT; ++i) {
    const int c = tid + i * MT, lr = c / KC, d = (c % KC) * 8, r = r0 + lr;
    const bool ok = r < rows;
    const bf16* src =
        ok ? q + q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD + d : q;
    mma::cp_async16(Qs + lr * LD + d, src, ok ? 16 : 0);
  }
  mma::cp_async_commit();

  // the live key tiles (flash_attention.py:42-53) form one interval
  const int q_lo = qbase + r0 / G;
  const int q_hi = qbase + (min(r0 + MBQ, rows) - 1) / G;
  auto live = [&](int kt) {
    const int k_lo = kt * MBK, k_hi = k_lo + MBK - 1;
    bool ok = true;
    if (causal) ok = ok && k_lo <= q_hi;
    if (window) ok = ok && k_hi > q_lo - window;
    if (chunk) ok = ok && (k_hi / chunk >= q_lo / chunk) && (k_lo / chunk <= q_hi / chunk);
    return ok;
  };
  int kt1 = (kv_len + MBK - 1) / MBK - 1;
  if (causal) kt1 = min(kt1, q_hi / MBK);
  while (kt1 >= 0 && !live(kt1)) --kt1;
  int kt0 = 0;
  while (kt0 <= kt1 && !live(kt0)) ++kt0;
  const int n_live = kt1 - kt0 + 1;

  // a contiguous key row is address arithmetic, a block-table row a load:
  // holding all of a thread's lookups of a tile in flight (16 at hd 256)
  // spills, so the paged layout issues 4 at a time
  constexpr int N_KV = MBK * KCS / MT;   // 16-byte copies of K (and of V) a thread
  constexpr int U_KV = std::is_same_v<Cache, rt::PagedCache> && N_KV > 4 ? 4 : N_KV;
  auto load_kv = [&](int kt, int stage) {
    TKV* ks = Kr + stage * Tile::ST_ELEMS;
    TKV* vs = Vr + stage * Tile::ST_ELEMS;
    auto copy = [&](int i) {
      const int c = tid + i * MT, kr = c / KCS, d = (c % KCS) * ECS, kp = kt * MBK + kr;
      const bool ok = kp < kv_len;
      const long long o = ok ? cache.row(b, kvh, kp) * HD + d : 0;
      mma::cp_async16(ks + kr * LDS + d, k + o, ok ? 16 : 0);
      mma::cp_async16(vs + kr * LDS + d, v + o, ok ? 16 : 0);
    };
    if constexpr (U_KV == N_KV) {
#pragma unroll
      for (int i = 0; i < N_KV; ++i) copy(i);
    } else {
#pragma unroll 1
      for (int i0 = 0; i0 < N_KV; i0 += U_KV) {
#pragma unroll
        for (int i = i0; i < i0 + U_KV; ++i) copy(i);
      }
    }
  };
  if (n_live > 0) load_kv(kt0, 0);
  mma::cp_async_commit();

  // this thread's two rows (g and g + 8 of its warp's 16), their query
  // positions (padding rows take the last real row's) and chunk ids
  int qp[2], qc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = qbase + min(r0 + warp * 16 + g + 8 * h, rows - 1) / G;
    qc[h] = chunk ? qp[h] / chunk : 0;
  }

  mma::cp_async_wait<1>();   // Q has landed
  __syncthreads();
  const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[Tile::Q_IN_REGS ? HD / 16 : 1][4];
  if constexpr (Tile::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma::ldmatrix_x4(qf[kk], q_frag + kk * 16);
  }

  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  float o[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int kt = kt0 + i, stage = i % STAGES;
    mma::cp_async_wait<0>();   // tile kt has landed ...
    __syncthreads();           // ... for every thread, and the other stage is free
    if (i + 1 < n_live) load_kv(kt + 1, (i + 1) % STAGES);
    mma::cp_async_commit();
    if constexpr (Tile::NARROW) {
      // widen the landed int8 tile into the bf16 tile: every thread is past
      // the last tile's products (the barrier above), and the barrier below
      // holds the products until the whole tile is widened
      const TKV* k8 = Kr + stage * Tile::ST_ELEMS;
      const TKV* v8 = Vr + stage * Tile::ST_ELEMS;
#pragma unroll
      for (int j = 0; j < N_KV; ++j) {
        const int c = tid + j * MT, kr = c / KCS, d = (c % KCS) * 16;
        widen16(k8 + kr * LDS + d, Ks + kr * LD + d);
        widen16(v8 + kr * LDS + d, Vs + kr * LD + d);
      }
      __syncthreads();
    }
    const bf16* ks = Ks + (Tile::NARROW ? 0 : stage) * Tile::KV_ELEMS;
    const bf16* vs = Vs + (Tile::NARROW ? 0 : stage) * Tile::KV_ELEMS;

    // S = Q K^T: K rows are keys, hd contiguous, i.e. B (k = hd, n = key)
    // stored column-major; x4 = keys +0..7 / +8..15 by hd +0..7 / +8..15
    float s[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Tile::Q_IN_REGS) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        mma::ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int jn = 0; jn < NKB / 2; ++jn) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, ks + (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * jn], a, bk[0], bk[1]);
        mma::mma_bf16(s[2 * jn + 1], a, bk[2], bk[3]);
      }
    }

    // scale, then mask per element where the tile is not whole for the block
    const int k_lo = kt * MBK, k_hi = k_lo + MBK - 1;
    bool whole = k_hi < kv_len;
    if (causal) whole = whole && k_hi <= q_lo;
    if (window) whole = whole && k_lo > q_hi - window;
    if (chunk)
      whole = whole && k_lo / chunk == k_hi / chunk && k_lo / chunk == q_lo / chunk &&
              q_lo / chunk == q_hi / chunk;
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!whole) {
          const int kp = k_lo + j * 8 + 2 * t + (e & 1), h = e >> 1;
          bool ok = kp < kv_len;
          if (causal) ok = ok && kp <= qp[h];
          if (window) ok = ok && kp > qp[h] - window;
          if (chunk) ok = ok && kp / chunk == qc[h];
          if (!ok) x = rt::NEG_INF;
        }
        s[j][e] = x;
      }
    }

    // online softmax in the log2 domain; rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < NKB; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};   // this thread's share of the row sums
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A fragments of keys
    // 16kk..16kk+15; V rows are keys, hd contiguous, i.e. B (k = key,
    // n = hd) stored row-major: ldmatrix.trans, x4 = keys +0..7 / +8..15
    // by hd +0..7 / +8..15
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      const uint32_t a[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < HD / 16; ++jd) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       jd * 16 + (lane >> 4) * 8);
        mma::mma_bf16(o[2 * jd], a, bv[0], bv[1]);
        mma::mma_bf16(o[2 * jd + 1], a, bv[2], bv[3]);
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r >= rows) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + kvh * G + r % G) * Sq + r / G] =
          m[h] * 0.6931471805599453f + logf(lc);
    bf16* dst = out + q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < NDB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * h] / lc, o[j][2 * h + 1] / lc);
  }
}

// Launch kernel (a __global__ wrapper of prefill_mma<HD, Cache, TKV>) over
// the grid (ceil(Sq * G / 64), KV, B), with its dynamic shared memory
// allowed.
template <int HD, typename TKV = bf16, class Kernel, class... Args>
int launch(Kernel kernel, int B, int Sq, int H, int KV, cudaStream_t stream, Args... args) {
  constexpr size_t smem = MmaTile<HD, TKV>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq * (H / KV) + MBQ - 1) / MBQ), (unsigned)KV, (unsigned)B);
  kernel<<<grid, MT, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pf
