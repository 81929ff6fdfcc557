// Split-KV flash-decode for Hopper (sm_90a), CUDA C++: the one body of K3
// (decode_attention.cu, contiguous keys) and K1's decode path
// (paged_attention.cu, block-table keys).
//
// Replaces the decode schedule of the Pallas TPU kernels _decode_kernel /
// decode_attention (src/repro/kernels/decode_attention.py:31, :70) and
// _paged_kernel / _paged_attention (:135, :182) at C == 1: the G query heads
// of one kv head against the first kv_len[b] keys of a cache, online
// softmax, NEG_INF = -1e30, l clamped at 1e-30, one division at the end.
//
// What bounds it on the H100: decode does ~4 * G operations per 2 bytes of
// bf16 K/V it reads (G = 4 to 10 at the served widths), far under the
// ~295 operations per byte where the tensor cores become the limit, so it
// is bound by the bytes of K/V: each key row must be read once, and the
// card must have enough of them in flight to cover memory latency.
//
// What the design does about that:
// * Split the keys across blocks. Grid (n_split, row groups, B * KV): a
//   block owns one range of keys of one (sequence, kv head) for 16 query
//   heads (one m16 row group; G > 16 is more row groups). n_split comes
//   from static shapes and the SM count (kernels/decode_attention.py
//   split_plan), so the grid never depends on kv_len and the launch can be
//   captured in a CUDA graph. Each block reads kv_len[b] on the device and
//   takes [s * len, min((s + 1) * len, kv_len)), len = round_up(
//   ceil(kv_len / n_split), 64); an empty range writes m = NEG_INF, l = 0
//   and returns. Blocks write float32 partials (m, l, acc[hd]) per query
//   row to a workspace, and a second small kernel (split_decode_merge_
//   kernel) combines them: out = sum e^{m_s - M} acc_s / max(sum e^{m_s - M}
//   l_s, 1e-30). With n_split == 1 the body writes out directly. Partials
//   are in log2 units (scores times scale * log2 e), both bodies alike.
//   Where Params::lse is given (K3's return_lse), whichever kernel writes a
//   row's output also writes its log-sum-exp, M ln 2 + ln L in natural log
//   (-inf for a row with no key), so ranks that each hold a range of a
//   cache can merge their outputs; K1 passes none.
// * Stage K and V through shared memory asynchronously: tiles of keys in a
//   cp.async ring, 16-byte copies of neighbouring addresses, rows past the
//   range zero-filled by the src-size operand; a paged key's physical page
//   comes from block_tables[b, kp / page] as its copy is issued, so pages
//   are never gathered into a contiguous copy. Rows are padded (by 16
//   bytes but for the int8 K tile below) so the fragment reads (and the
//   float32 body's 16-byte row reads) are free of bank conflicts.
// * bf16 queries (split_decode_mma_kernel), over a bf16 or an int8 cache:
//   4 warps split each 64-key tile, 16 keys a warp; S = Q K^T and O += P V
//   on mma.sync m16n8k16 with the row group as the A operand (padded to 16
//   rows). Each warp keeps its own online-softmax state in fragment
//   registers; the four are merged through shared memory at the end of the
//   range. The scale goes on the float32 scores, as in K2, and P becomes
//   bf16 A fragments (the one numeric departure K2 documents, at most 2^-9
//   relative a term); the row sum stays float32.
//   - bf16 cache: K is the .col B operand as stored (ldmatrix), V goes
//     through ldmatrix.trans. 3 ring stages at hd <= 128, 2 at hd 256.
//   - int8 cache: the ring carries int8 tiles (half the bytes of a bf16
//     stage), so it holds as many stages as two blocks an SM leave room for
//     (6 at hd 64, 5 at hd 128, 2 at hd 256), and no block-wide barrier is
//     added a tile: each thread reads its own B fragments' bytes from the
//     int8 tile and widens them exactly to bf16 in registers (widen_byte:
//     the byte under the exponent of 2^23, then one float subtraction;
//     every int8 value is exact in bf16). For K each k-step's head dims are
//     permuted so that a thread's four bytes of a key are neighbours (one
//     16-byte read serves four k-steps), and Q is copied into shared memory
//     in the same order (4-byte cp.async copies), which leaves Q K^T
//     unchanged. For V each n-block of output dims is permuted so that a
//     thread reads hd / 8 neighbouring bytes of each of its four keys; the
//     warp merge puts the dims back.
//     S = Q K^T is exact products with float32 sums (both operands exact in
//     bf16), multiplied by scale * log2 e * k_scale; the finished
//     accumulator by v_scale (a null scale reads 1.0). P in bf16 departs
//     from the Pallas body, which keeps p in float32 against the float32
//     upcast of an int8 V (src/repro/kernels/decode_attention.py:61,
//     :173): at most 2^-9 relative a term, under the bf16 output's own
//     rounding.
// * float32 queries (split_decode_fma_kernel), over a float32 or an int8
//   cache: the same split, ring and merge with 32-key tiles, products in
//   float32 FMA on CUDA cores (exact, no TF32): lane = key for the scores,
//   lane = head dim for P V, each warp owning 4 of the group's 16 rows.
//   int8 keys and values are widened on read from shared memory; the key
//   scale is folded into q, the value scale into the finished accumulator.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace rt {
// 16-byte vector loads of a cache row: 4 floats or 16 int8 values, widened
// to float
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* f) {
    const int4 u = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)c[i];
  }
};
}  // namespace rt

namespace dec {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;            // warps per block
constexpr int NT = 32 * NW;      // threads per block
constexpr int RG = 16;           // query rows per row group
constexpr int SPLIT_KEYS = 64;   // a split's length is a multiple of this

template <typename TQ_, typename TKV_, class Cache>
struct Params {
  using TQ = TQ_;
  using TKV = TKV_;
  const TQ* q;                   // (B, 1, H, hd)
  const TKV* k;
  const TKV* v;
  const int* kv_len;             // (B,)
  const int* q_offset;           // (B,) or null: keys up to q_offset + 1 as well
  const float* k_scale;          // (B, KV) or null (1.0)
  const float* v_scale;
  TQ* out;                       // (B, 1, H, hd)
  float* ws;                     // n_split * B * H * (hd + 2) floats when n_split > 1
  Cache cache;
  int H, KV, n_split;
  float scale_log2;              // softmax scale * log2 e
  float* lse;                    // (B, H) natural-log log-sum-exp, or null
};

// The natural-log log-sum-exp of a row from its log2-unit max M and its sum
// L of 2^(s - M): M ln 2 + ln L, or -inf for a row that read no key.
__device__ __forceinline__ float row_lse(float M, float L) {
  return L > 0.f ? M * 0.6931471805599453f + logf(L) : __int_as_float((int)0xff800000);
}

// This block's (sequence, kv head, row group) and its key range [lo, hi).
struct Block {
  int b, kvh, head0, nrows, lo, hi;
};

template <class P>
__device__ __forceinline__ Block block_of(const P& p) {
  Block k;
  k.b = blockIdx.z / p.KV;
  k.kvh = blockIdx.z % p.KV;
  const int G = p.H / p.KV;
  k.head0 = k.kvh * G + blockIdx.y * RG;
  k.nrows = min(RG, G - (int)blockIdx.y * RG);
  int kvl = min(p.kv_len[k.b], p.cache.capacity());
  if (p.q_offset) kvl = min(kvl, p.q_offset[k.b] + 1);
  const int per = ((kvl + p.n_split - 1) / p.n_split + SPLIT_KEYS - 1) / SPLIT_KEYS * SPLIT_KEYS;
  k.lo = blockIdx.x * per;
  k.hi = min(k.lo + per, kvl);
  return k;
}

// One finished element of query head h: the output itself when there is one
// split, else this split's partials (acc always; m and l once per row).
template <int HD, class P>
__device__ __forceinline__ void store(const P& p, int b, int h, int d, float A, float M,
                                      float L) {
  const long long bh = (long long)b * p.H + h;
  if (p.n_split == 1) {
    p.out[bh * HD + d] = rt::from_f32<typename P::TQ>(A / fmaxf(L, 1e-30f));
    if (p.lse && d == 0) p.lse[bh] = row_lse(M, L);
    return;
  }
  const long long BH = (long long)(gridDim.z / p.KV) * p.H;
  const long long s = blockIdx.x;
  p.ws[(s * BH + bh) * HD + d] = A;
  if (d == 0) {
    float* wm = p.ws + p.n_split * BH * HD;
    wm[s * BH + bh] = M;
    wm[p.n_split * BH + s * BH + bh] = L;
  }
}

// An empty key range: zeros out and an lse of -inf (one split), or m =
// NEG_INF, l = 0. A row with kv_len 0 has every range empty and reads no key.
template <int HD, class P>
__device__ __forceinline__ void store_empty(const P& p, const Block& k) {
  if (p.n_split == 1) {
    for (int idx = threadIdx.x; idx < k.nrows * HD; idx += NT)
      store<HD>(p, k.b, k.head0 + idx / HD, idx % HD, 0.f, rt::NEG_INF, 0.f);
    return;
  }
  const long long BH = (long long)(gridDim.z / p.KV) * p.H;
  const long long s = blockIdx.x;
  float* wm = p.ws + p.n_split * BH * HD;
  for (int r = threadIdx.x; r < k.nrows; r += NT) {
    const long long bh = (long long)k.b * p.H + k.head0 + r;
    wm[s * BH + bh] = rt::NEG_INF;
    wm[p.n_split * BH + s * BH + bh] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores, over a bf16 or an int8 cache
// ---------------------------------------------------------------------------
// A block's shared memory when two blocks share an SM: half of the SM's
// 228 KB, less the 1 KB the card reserves a block.
constexpr size_t SMEM_TWO_BLOCKS = 228 * 1024 / 2 - 1024;

template <int HD, typename TKV>
struct MmaShape {
  static constexpr bool NARROW = !std::is_same<TKV, bf16>::value;   // an int8 cache
  static constexpr int BK = 64;                    // keys per tile, 16 a warp
  static constexpr int LDQ = HD + 8;               // padded bf16 row of Q
  // ring rows, in TKV elements. bf16: padded by 16 bytes for ldmatrix.
  // int8: K rows an odd multiple of 64 bytes and V rows padded by 16 bytes,
  // which keeps the fragment reads of the kernel free of bank conflicts
  static constexpr int KLD = NARROW ? (HD % 128 ? HD : HD + 64) : HD + 8;
  static constexpr int VLD = NARROW ? HD + 16 : HD + 8;
  static constexpr size_t Q_BYTES = sizeof(bf16) * RG * LDQ;
  static constexpr size_t STAGE_BYTES = sizeof(TKV) * BK * (KLD + VLD);
  static constexpr int FIT = (int)((SMEM_TWO_BLOCKS - Q_BYTES) / STAGE_BYTES);
  static constexpr int STAGES = NARROW ? (FIT < 6 ? FIT : 6) : (HD <= 128 ? 3 : 2);
  static constexpr int LDO = HD + 4;               // padded float row of the warp merge
  static constexpr size_t RING = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t MERGE = sizeof(float) * (NW * RG * LDO + 2 * NW * RG);
  static constexpr size_t SMEM = RING > MERGE ? RING : MERGE;
  static constexpr bool Q_IN_REGS = HD <= 128;
  static_assert(STAGES >= 2, "ring");
};

// The int8 byte k (0..3) of w, where u = w ^ 0x80808080, as an exact float:
// byte k of u, b + 128, placed under the exponent of 2^23 is the float
// 2^23 + b + 128, and one subtraction leaves b.
__device__ __forceinline__ float widen_byte(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) - 8388736.f;
}
// Two floats that are exact in bf16 (integers of at most 8 bits) as one
// register of bf16 values, lo in the lower half: their upper halves.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <int HD, typename TKV, class Cache>
__global__ void __launch_bounds__(NT)
split_decode_mma_kernel(const Params<bf16, TKV, Cache> p) {
  using Sh = MmaShape<HD, TKV>;
  constexpr bool NARROW = Sh::NARROW;
  constexpr int LDQ = Sh::LDQ, KLD = Sh::KLD, VLD = Sh::VLD, BK = Sh::BK, STAGES = Sh::STAGES;
  constexpr int KC = HD / 8;                         // 16-byte chunks per Q row
  constexpr int RC = HD * (int)sizeof(TKV) / 16;     // 16-byte chunks per cache row
  constexpr int EC = 16 / (int)sizeof(TKV);          // elements per chunk
  constexpr int NDB = HD / 8;                        // n8 blocks of the output
  // int8 V: a thread reads VB bytes of each of its keys, in pieces of VP
  // bytes 128 bytes apart; n-block nb's column c is dim v_dim(nb, c)
  constexpr int VB = HD / 8, VP = VB < 16 ? VB : 16;
  auto v_dim = [](int nb, int c) { return (nb / 16) * 128 + c * VP + nb % 16; };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // RG x LDQ
  TKV* Ks = reinterpret_cast<TKV*>(Qs + RG * LDQ);   // [STAGES][BK][KLD]
  TKV* Vs = Ks + STAGES * BK * KLD;                  // [STAGES][BK][VLD]

  const Block blk = block_of(p);
  if (blk.lo >= blk.hi) {
    store_empty<HD>(p, blk);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long sc = (long long)blk.b * p.KV + blk.kvh;
  const float s_scale = p.scale_log2 * (p.k_scale ? p.k_scale[sc] : 1.f);
  const float v_scale = p.v_scale ? p.v_scale[sc] : 1.f;

  // Q: the row group's heads, rows past the group's last zero-filled. An
  // int8 cache permutes each k-step's columns as the K fragments below read
  // them (a thread's four bytes of a key are neighbours: k-step kk's columns
  // 2t, 2t + 1, 2t + 8, 2t + 9 are dims d .. d + 3, d = 64 (kk / 4) + 16 t +
  // 4 (kk % 4)), which leaves Q K^T unchanged: Q is copied a pair of dims
  // at a time into that order
  if constexpr (NARROW) {
    for (int c = tid; c < RG * HD / 2; c += NT) {
      const int r = c / (HD / 2), d = (c % (HD / 2)) * 2;
      const int col = (4 * (d / 64) + d % 16 / 4) * 16 + 2 * (d % 64 / 16) + 8 * (d % 4 / 2);
      const bool ok = r < blk.nrows;
      const bf16* src = ok ? p.q + ((long long)blk.b * p.H + blk.head0 + r) * HD + d : p.q;
      mma::cp_async4(Qs + r * LDQ + col, src, ok ? 4 : 0);
    }
  } else {
    for (int c = tid; c < RG * KC; c += NT) {
      const int r = c / KC, d = (c % KC) * 8;
      const bool ok = r < blk.nrows;
      const bf16* src = ok ? p.q + ((long long)blk.b * p.H + blk.head0 + r) * HD + d : p.q;
      mma::cp_async16(Qs + r * LDQ + d, src, ok ? 16 : 0);
    }
  }
  mma::cp_async_commit();

  const int n_tiles = (blk.hi - blk.lo + BK - 1) / BK;
  auto load_tile = [&](int i) {
    TKV* ks = Ks + (i % STAGES) * BK * KLD;
    TKV* vs = Vs + (i % STAGES) * BK * VLD;
    for (int c = tid; c < BK * RC; c += NT) {
      const int kr = c / RC, d = (c % RC) * EC, kp = blk.lo + i * BK + kr;
      const bool ok = kp < blk.hi;
      const long long o = ok ? p.cache.row(blk.b, blk.kvh, kp) * HD + d : 0;
      mma::cp_async16(ks + kr * KLD + d, p.k + o, ok ? 16 : 0);
      mma::cp_async16(vs + kr * VLD + d, p.v + o, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    mma::cp_async_commit();
  }

  mma::cp_async_wait<STAGES - 1>();   // Q has landed ...
  __syncthreads();                    // ... for every thread
  auto q_frag = [&](uint32_t* a, int kk) {
    mma::ldmatrix_x4(a, Qs + (lane & 15) * LDQ + (lane >> 4) * 8 + kk * 16);
  };
  uint32_t qf[Sh::Q_IN_REGS ? HD / 16 : 1][4];
  if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) q_frag(qf[kk], kk);
  }

  // rows g (h = 0) and g + 8 (h = 1) of the group; this warp's 16 keys a tile
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  float o[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<STAGES - 2>();   // tile i has landed ...
    __syncthreads();                    // ... for every thread, and stage (i - 1) is free
    if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
    mma::cp_async_commit();
    const TKV* ks = Ks + (i % STAGES) * BK * KLD + warp * 16 * KLD;
    const TKV* vs = Vs + (i % STAGES) * BK * VLD + warp * 16 * VLD;

    // S = Q K^T over this warp's 16 keys: s[0] keys +0..7, s[1] keys +8..15
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (NARROW) {
      // keys g and 8 + g (j = 0, 1), bytes 64c + 16t .. + 15: k-steps 4c ..
      // 4c + 3, four bytes each (columns 2t, 2t + 1, then 2t + 8, 2t + 9)
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        uint32_t u[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int4 w = *reinterpret_cast<const int4*>(ks + (8 * j + g) * KLD + 64 * c + 16 * t);
          u[j][0] = (uint32_t)w.x ^ 0x80808080u; u[j][1] = (uint32_t)w.y ^ 0x80808080u;
          u[j][2] = (uint32_t)w.z ^ 0x80808080u; u[j][3] = (uint32_t)w.w ^ 0x80808080u;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t a[4];
          if constexpr (Sh::Q_IN_REGS) {
            a[0] = qf[4 * c + e][0]; a[1] = qf[4 * c + e][1];
            a[2] = qf[4 * c + e][2]; a[3] = qf[4 * c + e][3];
          } else {
            q_frag(a, 4 * c + e);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma::mma_bf16(s[j], a, pack_exact(widen_byte(u[j][e], 0), widen_byte(u[j][e], 1)),
                          pack_exact(widen_byte(u[j][e], 2), widen_byte(u[j][e], 3)));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        if constexpr (Sh::Q_IN_REGS) {
          a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
        } else {
          q_frag(a, kk);
        }
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, ks + ((lane & 7) + ((lane >> 4) << 3)) * KLD + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[0], a, bk[0], bk[1]);
        mma::mma_bf16(s[1], a, bk[2], bk[3]);
      }
    }

    // scale; keys past the range (only in the last tile) are masked
    const int k0 = blk.lo + i * BK + warp * 16;
    const bool whole = k0 + 16 <= blk.hi;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * s_scale;
        if (!whole && k0 + j * 8 + 2 * t + (e & 1) >= blk.hi) x = rt::NEG_INF;
        s[j][e] = x;
      }
    }

    // online softmax in the log2 domain; a masked key weighs 0 even while
    // the row has seen no key yet
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] <= rt::NEG_INF ? 0.f : exp2f(s[j][e] - m[e >> 1]);
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

    // O += P V: P's accumulator fragments are the A fragment of the warp's
    // 16 keys, so thread t's B fragments are keys 2t, 2t + 1 (b0) and 2t + 8,
    // 2t + 9 (b1)
    const uint32_t a[4] = {mma::pack_bf16(s[0][0], s[0][1]), mma::pack_bf16(s[0][2], s[0][3]),
                           mma::pack_bf16(s[1][0], s[1][1]), mma::pack_bf16(s[1][2], s[1][3])};
    if constexpr (NARROW) {
#pragma unroll
      for (int h = 0; h < VB / VP; ++h) {
        uint32_t u[4][VP / 4];        // piece h of the four keys, bytes ^ 0x80
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const TKV* src = vs + (2 * t + (kq & 1) + 8 * (kq >> 1)) * VLD + 128 * h + g * VP;
          if constexpr (VP == 16) {
            const int4 w = *reinterpret_cast<const int4*>(src);
            u[kq][0] = (uint32_t)w.x; u[kq][1] = (uint32_t)w.y;
            u[kq][2] = (uint32_t)w.z; u[kq][3] = (uint32_t)w.w;
          } else {
            const int2 w = *reinterpret_cast<const int2*>(src);
            u[kq][0] = (uint32_t)w.x; u[kq][1] = (uint32_t)w.y;
          }
#pragma unroll
          for (int x = 0; x < VP / 4; ++x) u[kq][x] ^= 0x80808080u;
        }
#pragma unroll
        for (int x = 0; x < VP / 4; ++x) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mma::mma_bf16(o[16 * h + 4 * x + e], a,
                          pack_exact(widen_byte(u[0][x], e), widen_byte(u[1][x], e)),
                          pack_exact(widen_byte(u[2][x], e), widen_byte(u[3][x], e)));
          }
        }
      }
    } else {
#pragma unroll
      for (int jd = 0; jd < HD / 16; ++jd) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(bv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * VLD + jd * 16 +
                                       (lane >> 4) * 8);
        mma::mma_bf16(o[2 * jd], a, bv[0], bv[1]);
        mma::mma_bf16(o[2 * jd + 1], a, bv[2], bv[3]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the warp merge

  float* Os = reinterpret_cast<float*>(smem_raw);   // NW x RG x LDO
  float* Ms = Os + NW * RG * Sh::LDO;               // NW x RG
  float* Ls = Ms + NW * RG;                         // NW x RG
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = g + 8 * h;
    if (t == 0) {
      Ms[warp * RG + r] = m[h];
      Ls[warp * RG + r] = l[h];
    }
    float* orow = Os + (warp * RG + r) * Sh::LDO;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      if constexpr (NARROW) {       // the output dims back in order
        orow[v_dim(j, 2 * t)] = o[j][2 * h];
        orow[v_dim(j, 2 * t + 1)] = o[j][2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(orow + j * 8 + 2 * t) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < blk.nrows * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float M = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Ms[w * RG + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = exp2f(Ms[w * RG + r] - M);
      L += wt * Ls[w * RG + r];
      A += wt * Os[(w * RG + r) * Sh::LDO + d];
    }
    store<HD>(p, blk.b, blk.head0 + r, d, A * v_scale, M, L);
  }
}

// ---------------------------------------------------------------------------
// float32 queries: CUDA-core FMA, over a float32 or an int8 cache
// ---------------------------------------------------------------------------
template <typename TKV, int HD>
struct FmaShape {
  static constexpr int BK = 32;                    // keys per tile: lane = key
  static constexpr int STAGES = 2;
  static constexpr int LD = HD + 16 / (int)sizeof(TKV);   // padded row, elements
  static constexpr int TILE = BK * LD;
  static constexpr size_t SMEM = sizeof(float) * RG * HD + sizeof(TKV) * 2 * STAGES * TILE;
};

template <typename TQ, typename TKV, int HD, class Cache>
__global__ void __launch_bounds__(NT)
split_decode_fma_kernel(const Params<TQ, TKV, Cache> p) {
  using Sh = FmaShape<TKV, HD>;
  constexpr int LD = Sh::LD, BK = Sh::BK, STAGES = Sh::STAGES;
  constexpr int KC = HD * (int)sizeof(TKV) / 16;   // 16-byte chunks per row
  constexpr int EC = 16 / (int)sizeof(TKV);        // elements per chunk
  constexpr int VN = rt::Vec<TKV>::N;
  constexpr int E = HD / 32;                       // head dims per lane in P V
  constexpr int RW = RG / NW;                      // rows per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // RG x HD, pre-scaled
  TKV* Ks = reinterpret_cast<TKV*>(Qs + RG * HD);  // [STAGES][BK][LD]
  TKV* Vs = Ks + STAGES * Sh::TILE;

  const Block blk = block_of(p);
  if (blk.lo >= blk.hi) {
    store_empty<HD>(p, blk);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long sc = (long long)blk.b * p.KV + blk.kvh;
  const float ks = p.k_scale ? p.k_scale[sc] : 1.f;
  const float vs = p.v_scale ? p.v_scale[sc] : 1.f;

  const int n_tiles = (blk.hi - blk.lo + BK - 1) / BK;
  auto load_tile = [&](int i) {
    TKV* kt = Ks + (i % STAGES) * Sh::TILE;
    TKV* vt = Vs + (i % STAGES) * Sh::TILE;
    for (int c = tid; c < BK * KC; c += NT) {
      const int kr = c / KC, d = (c % KC) * EC, kp = blk.lo + i * BK + kr;
      const bool ok = kp < blk.hi;
      const long long o = ok ? p.cache.row(blk.b, blk.kvh, kp) * HD + d : 0;
      mma::cp_async16(kt + kr * LD + d, p.k + o, ok ? 16 : 0);
      mma::cp_async16(vt + kr * LD + d, p.v + o, ok ? 16 : 0);
    }
  };
  load_tile(0);
  mma::cp_async_commit();

  // Q times scale * log2 e and the key scale, in float32
  const float qs = p.scale_log2 * ks;
  for (int idx = tid; idx < RG * HD; idx += NT) {
    const int r = idx / HD;
    Qs[idx] = r < blk.nrows
                  ? rt::to_f32(p.q[((long long)blk.b * p.H + blk.head0 + r) * HD + idx % HD]) * qs
                  : 0.f;
  }

  const int r0 = warp * RW;
  const int nr = min(RW, blk.nrows - r0);    // this warp's live rows (<= 0: none)
  float m[RW], l[RW], acc[RW][E];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = rt::NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();   // tile i (and, first time, Q's stores) ...
    __syncthreads();           // ... visible to every thread; the other stage is free
    if (i + 1 < n_tiles) load_tile(i + 1);
    mma::cp_async_commit();
    if (nr <= 0) continue;     // uniform across the warp
    const TKV* kt = Ks + (i % STAGES) * Sh::TILE;
    const TKV* vt = Vs + (i % STAGES) * Sh::TILE;
    const int base = blk.lo + i * BK;
    const bool valid = base + lane < blk.hi;

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < HD; d0 += VN) {
      float kf[VN];
      rt::Vec<TKV>::load(kt + lane * LD + d0, kf);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r < nr) {
#pragma unroll
          for (int u = 0; u < VN; ++u) s[r] = fmaf(Qs[(r0 + r) * HD + d0 + u], kf[u], s[r]);
        }
      }
    }
    float pr[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      pr[r] = 0.f;
      if (r >= nr) continue;
      const float sv = valid ? s[r] : rt::NEG_INF;
      float mt = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - m_new);
      pr[r] = valid ? exp2f(sv - m_new) : 0.f;
      float ps = pr[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
    const int n_valid = min(BK, blk.hi - base);
    for (int j = 0; j < n_valid; ++j) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = rt::to_f32(vt[j * LD + lane + 32 * e]);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r < nr) {
          const float pj = __shfl_sync(0xffffffffu, pr[r], j);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r >= nr) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      store<HD>(p, blk.b, blk.head0 + r0 + r, lane + 32 * e, acc[r][e] * vs, m[r], l[r]);
  }
}

// ---------------------------------------------------------------------------
// the merge of the splits' partials: one block of HD threads per (b, head)
// ---------------------------------------------------------------------------
template <typename TQ, int HD>
__global__ void __launch_bounds__(HD)
split_decode_merge_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
                          float* __restrict__ lse, int BH, int n_split) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* wm = ws + (long long)n_split * BH * HD;
  const float* wl = wm + (long long)n_split * BH;
  float M = rt::NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, wm[(long long)s * BH + bh]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ls = wl[(long long)s * BH + bh];
    if (ls > 0.f) {            // an empty split wrote no accumulator
      const float wt = exp2f(wm[(long long)s * BH + bh] - M);
      L += wt * ls;
      A += wt * ws[((long long)s * BH + bh) * HD + d];
    }
  }
  out[(long long)bh * HD + d] = rt::from_f32<TQ>(A / fmaxf(L, 1e-30f));
  if (lse && d == 0) lse[bh] = row_lse(M, L);
}

// Launch the split body (bf16 q on the tensor cores, over a bf16 or an int8
// cache; float32 q on CUDA cores) and, with n_split > 1, the merge. Returns
// 0 or a cudaError_t code.
template <int HD, typename TQ, typename TKV, class Cache>
int launch(const Params<TQ, TKV, Cache>& p, int B, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const dim3 grid((unsigned)p.n_split, (unsigned)((G + RG - 1) / RG), (unsigned)(B * p.KV));
  cudaError_t err;
  if constexpr (std::is_same<TQ, bf16>::value) {
    constexpr size_t smem = MmaShape<HD, TKV>::SMEM;
    err = cudaFuncSetAttribute(split_decode_mma_kernel<HD, TKV, Cache>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    split_decode_mma_kernel<HD, TKV, Cache><<<grid, NT, smem, stream>>>(p);
  } else {
    constexpr size_t smem = FmaShape<TKV, HD>::SMEM;
    err = cudaFuncSetAttribute(split_decode_fma_kernel<TQ, TKV, HD, Cache>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    split_decode_fma_kernel<TQ, TKV, HD, Cache><<<grid, NT, smem, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  split_decode_merge_kernel<TQ, HD><<<B * p.H, HD, 0, stream>>>(p.ws, p.out, p.lse, B * p.H,
                                                                p.n_split);
  return (int)cudaGetLastError();
}

}  // namespace dec
