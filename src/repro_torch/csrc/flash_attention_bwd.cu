// K2 backward: the gradients of flash attention for Hopper (sm_90a), CUDA C++.
//
// Stands for the backward of the XLA path of ops.flash_attention
// (src/repro/kernels/ref.py flash_attention under jax.grad): the Pallas
// TPU kernel _attn_kernel / flash_attention (src/repro/kernels/
// flash_attention.py:27, :88) has no VJP, so the reference trains through
// XLA's differentiated blocked attention. Given q, k, v, the forward's
// output o and per-row log-sum-exp lse (flash_attention.cu stores it under
// autograd), and do = dL/do:
//   P = exp(scale * q.k - lse) (0 where the mask hides the key),
//   D = rowsum(do * o), dS = P * (do.v - D),
//   dq = scale * dS k, dk = scale * dS^T q, dv = P^T do,
// dk and dv summed over the G query heads of each kv head; causal,
// sliding-window, same-chunk or no mask; queries are the last Sq of Skv
// positions. kernels/ref.py flash_attention_bwd is the same formula in
// plain PyTorch.
//
// What bounds it on the H100: five products a visible (query, key) pair
// (q.k and do.v recomputed, then dv, dk and dq), ~10 * hd operations, on
// inputs read once and outputs written once: at training lengths far above
// the ~295 operations per byte where the tensor cores and not the memory
// become the limit, so it is bound by the tensor cores' rate, about 2.5x
// the forward's time. What the design does about it: every (query, key)
// intermediate (S, P, dP, dS) stays in registers, the mask's empty tiles
// are skipped as in the forward, and the bf16 products run on the tensor
// cores (mma.sync m16n8k16, float32 sums), as the forward's
// prefill_common.cuh. wgmma, TMA and warp specialisation are the step
// beyond.
//
// Two passes, no atomics, so a backward repeats bit for bit:
// * dQ pass, grid (ceil(Sq * G / 64), KV, B): a block owns 64 query rows
//   of one kv head's group (a row is a (position, head) pair, as in the
//   forward), computes D for them (stored to delta for the second pass),
//   and walks the live key tiles accumulating dq.
// * dK/dV pass, grid (ceil(Skv / BC), KV, B): a block owns BC keys of one
//   kv head and walks the live tiles of query rows of all G heads of its
//   group, recomputing P from lse and reading D, accumulating dk and dv.
// bf16 (flash_attention_bwd_{dq,dkv}_mma_kernel): 4 warps of 16 rows;
// S = Q K^T and dP = dO V^T as in the forward, then dS becomes the bf16 A
// fragment of dS K (dq), or P^T and dS^T the A fragments of P^T dO (dv)
// and dS^T Q (dk), in registers. P and dS are rounded to bf16 for those
// products, the one numeric departure from the plain version, whose
// products are float32. Trouble spot: at hd 256 a warp's float32 dk and dv
// for 16 keys are 256 registers a thread. So at hd 256 the dK/dV pass
// takes 32-key tiles and splits hd in two: warp (kw, ds) recomputes S^T
// and dP^T for keys kw * 16.. over the whole hd and accumulates columns
// ds * 128.. of dk and dv (S and dP computed twice, 1.5x that pass's
// products, against a spill). The dQ pass at hd 256 takes 32-key tiles
// (dq alone is 128 registers). Tiles stream through a 2-stage cp.async
// ring; rows are padded by 16 bytes for conflict-free ldmatrix.
// float32 (flash_attention_bwd_{dq,dkv}_kernel): exact FMA on the CUDA
// cores (no TF32), register-tiled 4 x 4 over 256 threads as the forward's
// float32 body of attention_common.cuh; P and dS pass through shared
// memory.
#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float PAD_LSE = 1e30f;   // padding rows: P = exp(s - 1e30) = 0

__device__ __forceinline__ bool visible(int kp, int qp, int kv_len, int causal, int window,
                                        int chunk) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  if (chunk) ok = ok && kp / chunk == qp / chunk;
  return ok;
}

// whether keys [k_lo, k_hi] and query positions [q_lo, q_hi] can hold a
// visible pair (the reachability test of flash_attention.py:42-53)
__device__ __forceinline__ bool tiles_meet(int k_lo, int k_hi, int q_lo, int q_hi, int causal,
                                           int window, int chunk) {
  bool ok = true;
  if (causal) ok = ok && k_lo <= q_hi;
  if (window) ok = ok && k_hi > q_lo - window;
  if (chunk) ok = ok && (k_hi / chunk >= q_lo / chunk) && (k_lo / chunk <= q_hi / chunk);
  return ok;
}

// the element offset of query row r (position r / G of head kvh * G + r % G)
__device__ __forceinline__ long long row_off(int b, int Sq, int H, int G, int kvh, int r, int HD) {
  return ((long long)b * Sq * H + (long long)(r / G) * H + kvh * G + r % G) * HD;
}
__device__ __forceinline__ long long lse_off(int b, int Sq, int H, int G, int kvh, int r) {
  return ((long long)b * H + kvh * G + r % G) * Sq + r / G;
}

// ======================================================================
// bf16 on the tensor cores
// ======================================================================
constexpr int MT = 128;   // 4 warps
constexpr int MBQ = 64;   // dQ pass: query rows a block

template <int HD> struct Cfg;
// DQ_BK: keys a tile of the dQ pass; KW x DS warps of the dK/dV pass (KW
// groups of 16 keys, hd split DS ways); BR: query rows a tile of that pass
template <> struct Cfg<64> { static constexpr int DQ_BK = 64, KW = 4, DS = 1, BR = 64; };
template <> struct Cfg<128> { static constexpr int DQ_BK = 64, KW = 4, DS = 1, BR = 32; };
template <> struct Cfg<256> { static constexpr int DQ_BK = 32, KW = 2, DS = 2, BR = 32; };

template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + 8;
  static constexpr int BC = 16 * Cfg<HD>::KW;
  static constexpr size_t DQ = sizeof(bf16) * (2 * MBQ * LD + 2 * 2 * Cfg<HD>::DQ_BK * LD) +
                               sizeof(float) * 2 * MBQ;
  static constexpr size_t DKV = sizeof(bf16) * (2 * BC * LD + 2 * 2 * Cfg<HD>::BR * LD) +
                                (sizeof(float) * 2 + sizeof(int)) * 2 * Cfg<HD>::BR;
};

// A (16 x 16) of a row-major [m][k] tile at (m0, k0)
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* t, int LD, int m0, int k0,
                                       int lane) {
  mma::ldmatrix_x4(a, t + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
// B of n-blocks n0.. and n0 + 8.. (b[0..1], b[2..3]) at depth k0, from a
// [n][k] tile (k contiguous)
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* t, int LD, int n0, int k0,
                                          int lane) {
  mma::ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                          ((lane >> 3) & 1) * 8);
}
// the same from a [k][n] tile (n contiguous), through ldmatrix.trans
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* t, int LD, int k0, int n0,
                                          int lane) {
  mma::ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                                (lane >> 4) * 8);
}

// acc (16 x 8 NB blocks) += A-tile rows m0.. (of a [m][k] tile, depth HD)
// times the n-rows n0.. of a [n][k] tile
template <int HD, int NB>
__device__ __forceinline__ void mma_nk(float (*acc)[4], const bf16* a_t, int m0, const bf16* b_t,
                                       int n0, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_t, LD, m0, kk * 16, lane);
#pragma unroll
    for (int jn = 0; jn < NB / 2; ++jn) {
      uint32_t b[4];
      load_b_nk(b, b_t, LD, n0 + jn * 16, kk * 16, lane);
      mma::mma_bf16(acc[2 * jn], a, b[0], b[1]);
      mma::mma_bf16(acc[2 * jn + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 NB blocks, columns n0..) += F (16 x 16 KB, float32 C
// fragments, rounded to bf16) times the [k][n] tile b_t
template <int HD, int KB, int NB>
__device__ __forceinline__ void mma_frag_kn(float (*acc)[4], float (*f)[4], const bf16* b_t,
                                            int n0, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < KB / 2; ++kk) {
    const uint32_t a[4] = {mma::pack_bf16(f[2 * kk][0], f[2 * kk][1]),
                           mma::pack_bf16(f[2 * kk][2], f[2 * kk][3]),
                           mma::pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                           mma::pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3])};
#pragma unroll
    for (int jd = 0; jd < NB / 2; ++jd) {
      uint32_t b[4];
      load_b_kn(b, b_t, LD, kk * 16, n0 + jd * 16, lane);
      mma::mma_bf16(acc[2 * jd], a, b[0], b[1]);
      mma::mma_bf16(acc[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MT)
flash_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                                  float* __restrict__ delta, bf16* __restrict__ dq, int Sq,
                                  int Skv, int H, int KV, int causal, int window, int chunk,
                                  float scale) {
  constexpr int BK = Cfg<HD>::DQ_BK;
  constexpr int LD = HD + 8, KC = HD / 8, NKB = BK / 8, NDB = HD / 8;
  static_assert((MBQ * KC) % MT == 0 && (BK * KC) % MT == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [MBQ][LD]
  bf16* dOs = Qs + MBQ * LD;                      // [MBQ][LD]
  bf16* Ks = dOs + MBQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * LD);   // [MBQ] lse * log2 e
  float* Dsm = Ls + MBQ;                                    // [MBQ]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = H / KV, rows = Sq * G, r0 = blockIdx.x * MBQ, qbase = Skv - Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * LOG2E;

#pragma unroll
  for (int i = 0; i < MBQ * KC / MT; ++i) {
    const int c = tid + i * MT, lr = c / KC, d = (c % KC) * 8, r = r0 + lr;
    const bool ok = r < rows;
    const long long off = ok ? row_off(b, Sq, H, G, kvh, r, HD) + d : 0;
    mma::cp_async16(Qs + lr * LD + d, q + off, ok ? 16 : 0);
    mma::cp_async16(dOs + lr * LD + d, dout + off, ok ? 16 : 0);
  }
  mma::cp_async_commit();

  // D = rowsum(do * o) of each row (warp w: rows 16w..16w+15), stored for
  // the dK/dV pass
  for (int i = 0; i < 16; ++i) {
    const int lr = warp * 16 + i, r = r0 + lr;
    float acc = 0.f;
    if (r < rows) {
      const long long off = row_off(b, Sq, H, G, kvh, r, HD);
      for (int d = 2 * lane; d < HD; d += 64) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + d));
        const float2 dv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
        acc = fmaf(ov.x, dv.x, acc);
        acc = fmaf(ov.y, dv.y, acc);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) {
      Dsm[lr] = acc;
      Ls[lr] = r < rows ? lse[lse_off(b, Sq, H, G, kvh, r)] * LOG2E : PAD_LSE;
      if (r < rows) delta[lse_off(b, Sq, H, G, kvh, r)] = acc;
    }
  }

  const int q_lo = qbase + r0 / G, q_hi = qbase + (min(r0 + MBQ, rows) - 1) / G;
  auto live = [&](int kt) {
    return tiles_meet(kt * BK, kt * BK + BK - 1, q_lo, q_hi, causal, window, chunk);
  };
  int kt1 = (Skv + BK - 1) / BK - 1;
  if (causal) kt1 = min(kt1, q_hi / BK);
  while (kt1 >= 0 && !live(kt1)) --kt1;
  int kt0 = 0;
  while (kt0 <= kt1 && !live(kt0)) ++kt0;
  const int n_live = kt1 - kt0 + 1;

  auto load_kv = [&](int kt, int stage) {
    bf16* ks = Ks + stage * BK * LD;
    bf16* vs = Vs + stage * BK * LD;
#pragma unroll
    for (int i = 0; i < BK * KC / MT; ++i) {
      const int c = tid + i * MT, kr = c / KC, d = (c % KC) * 8, kp = kt * BK + kr;
      const bool ok = kp < Skv;
      const long long off = ok ? (((long long)b * Skv + kp) * KV + kvh) * HD + d : 0;
      mma::cp_async16(ks + kr * LD + d, k + off, ok ? 16 : 0);
      mma::cp_async16(vs + kr * LD + d, v + off, ok ? 16 : 0);
    }
  };
  if (n_live > 0) load_kv(kt0, 0);
  mma::cp_async_commit();
  __syncthreads();   // Ls, Dsm

  int qp[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = warp * 16 + g + 8 * h;
    qp[h] = qbase + min(r0 + lr, rows - 1) / G;
    l2[h] = Ls[lr];
    dd[h] = Dsm[lr];
  }

  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int kt = kt0 + i, stage = i & 1;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_live) load_kv(kt + 1, stage ^ 1);
    mma::cp_async_commit();
    const bf16* ks = Ks + stage * BK * LD;
    const bf16* vs = Vs + stage * BK * LD;

    float s[NKB][4], dp[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_nk<HD, NKB>(s, Qs, warp * 16, ks, 0, lane);     // S = Q K^T
    mma_nk<HD, NKB>(dp, dOs, warp * 16, vs, 0, lane);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt * BK + j * 8 + 2 * t + (e & 1), h = e >> 1;
        const float p = visible(kp, qp[h], Skv, causal, window, chunk)
                            ? exp2f(s[j][e] * scale_log2 - l2[h])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - dd[h]);   // dS
      }
    }
    mma_frag_kn<HD, NKB, NDB>(acc, s, ks, 0, lane);   // dQ += dS K
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r >= rows) continue;
    bf16* dst = dq + row_off(b, Sq, H, G, kvh, r, HD) + 2 * t;
#pragma unroll
    for (int j = 0; j < NDB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(MT)
flash_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int Sq, int Skv, int H, int KV,
                                   int causal, int window, int chunk, float scale) {
  constexpr int KW = Cfg<HD>::KW, DS = Cfg<HD>::DS, BR = Cfg<HD>::BR;
  constexpr int BC = 16 * KW, DW = HD / DS;
  constexpr int LD = HD + 8, KC = HD / 8, NRB = BR / 8, NDW = DW / 8;
  static_assert(KW * DS == 4 && (BC * KC) % MT == 0 && (BR * KC) % MT == 0 && BR <= MT,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BC][LD]
  bf16* Vs = Ks + BC * LD;                        // [BC][LD]
  bf16* Qs = Vs + BC * LD;                        // [2][BR][LD]
  bf16* dOs = Qs + 2 * BR * LD;                   // [2][BR][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BR * LD);   // [2][BR] lse * log2 e
  float* Dl = Ls + 2 * BR;                                  // [2][BR]
  int* Qp = reinterpret_cast<int*>(Dl + 2 * BR);            // [2][BR] query positions

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BC;
  const int G = H / KV, rows = Sq * G, qbase = Skv - Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % KW, ds = warp / KW;
  const float scale_log2 = scale * LOG2E;

#pragma unroll
  for (int i = 0; i < BC * KC / MT; ++i) {
    const int c = tid + i * MT, kr = c / KC, d = (c % KC) * 8, kp = k0 + kr;
    const bool ok = kp < Skv;
    const long long off = ok ? (((long long)b * Skv + kp) * KV + kvh) * HD + d : 0;
    mma::cp_async16(Ks + kr * LD + d, k + off, ok ? 16 : 0);
    mma::cp_async16(Vs + kr * LD + d, v + off, ok ? 16 : 0);
  }
  mma::cp_async_commit();

  // the live tiles of query rows form one interval
  const int k_lo = k0, k_hi = min(k0 + BC, Skv) - 1;
  auto live = [&](int qt) {
    const int q_lo = qbase + qt * BR / G, q_hi = qbase + (min(qt * BR + BR, rows) - 1) / G;
    return tiles_meet(k_lo, k_hi, q_lo, q_hi, causal, window, chunk);
  };
  int qt1 = (rows + BR - 1) / BR - 1;
  while (qt1 >= 0 && !live(qt1)) --qt1;
  int qt0 = 0;
  while (qt0 <= qt1 && !live(qt0)) ++qt0;
  const int n_live = qt1 - qt0 + 1;

  auto load_q = [&](int qt, int stage) {
    bf16* qs = Qs + stage * BR * LD;
    bf16* dos = dOs + stage * BR * LD;
#pragma unroll
    for (int i = 0; i < BR * KC / MT; ++i) {
      const int c = tid + i * MT, lr = c / KC, d = (c % KC) * 8, r = qt * BR + lr;
      const bool ok = r < rows;
      const long long off = ok ? row_off(b, Sq, H, G, kvh, r, HD) + d : 0;
      mma::cp_async16(qs + lr * LD + d, q + off, ok ? 16 : 0);
      mma::cp_async16(dos + lr * LD + d, dout + off, ok ? 16 : 0);
    }
    if (tid < BR) {
      const int r = qt * BR + tid;
      const bool ok = r < rows;
      Ls[stage * BR + tid] = ok ? lse[lse_off(b, Sq, H, G, kvh, r)] * LOG2E : PAD_LSE;
      Dl[stage * BR + tid] = ok ? delta[lse_off(b, Sq, H, G, kvh, r)] : 0.f;
      Qp[stage * BR + tid] = qbase + min(r, rows - 1) / G;
    }
  };
  if (n_live > 0) load_q(qt0, 0);
  mma::cp_async_commit();

  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kp[h] = k0 + kw * 16 + g + 8 * h;

  float dka[NDW][4], dva[NDW][4];
#pragma unroll
  for (int j = 0; j < NDW; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  for (int i = 0; i < n_live; ++i) {
    const int stage = i & 1;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_live) load_q(qt0 + i + 1, stage ^ 1);
    mma::cp_async_commit();
    const bf16* qs = Qs + stage * BR * LD;
    const bf16* dos = dOs + stage * BR * LD;
    const float* ls = Ls + stage * BR;
    const float* dl = Dl + stage * BR;
    const int* qpos = Qp + stage * BR;

    float st[NRB][4], dpt[NRB][4];
#pragma unroll
    for (int j = 0; j < NRB; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
    mma_nk<HD, NRB>(st, Ks, kw * 16, qs, 0, lane);     // S^T = K Q^T
    mma_nk<HD, NRB>(dpt, Vs, kw * 16, dos, 0, lane);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NRB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), h = e >> 1;
        const float p = visible(kp[h], qpos[c], Skv, causal, window, chunk)
                            ? exp2f(st[j][e] * scale_log2 - ls[c])
                            : 0.f;
        st[j][e] = p;                           // P^T
        dpt[j][e] = p * (dpt[j][e] - dl[c]);   // dS^T
      }
    }
    mma_frag_kn<HD, NRB, NDW>(dva, st, dos, ds * DW, lane);   // dV += P^T dO
    mma_frag_kn<HD, NRB, NDW>(dka, dpt, qs, ds * DW, lane);   // dK += dS^T Q
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= Skv) continue;
    const long long off = (((long long)b * Skv + kp[h]) * KV + kvh) * HD + ds * DW + 2 * t;
#pragma unroll
    for (int j = 0; j < NDW; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// ======================================================================
// float32: exact FMA on the CUDA cores
// ======================================================================
constexpr int FT = 256;   // 16 row groups x 16 column lanes
constexpr int FBQ = 64;   // dQ pass: query rows a block

template <int HD> struct FCfg {
  static constexpr int BK = HD == 256 ? 32 : 64;    // dQ pass: keys a tile
  static constexpr int BKV = HD == 256 ? 32 : 64;   // dK/dV pass: keys a block
  static constexpr int BQR = HD == 256 ? 32 : 64;   // dK/dV pass: query rows a tile
  static constexpr size_t DQ = sizeof(float) * ((2 * FBQ + 2 * BK) * (HD + 1) +
                                                FBQ * (BK + 1) + 2 * FBQ) +
                               sizeof(int) * FBQ;
  static constexpr size_t DKV = sizeof(float) * ((2 * BKV + 2 * BQR) * (HD + 1) +
                                                 2 * BKV * (BQR + 1) + 2 * BQR) +
                                sizeof(int) * BQR;
};

template <int HD>
__global__ void __launch_bounds__(FT)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ o,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta, float* __restrict__ dq, int Sq,
                              int Skv, int H, int KV, int causal, int window, int chunk,
                              float scale) {
  constexpr int BK = FCfg<HD>::BK, QS = HD + 1, PS = BK + 1;
  constexpr int JK = BK / 16, E = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [FBQ][QS]
  float* dOs = Qs + FBQ * QS;                       // [FBQ][QS]
  float* Ks = dOs + FBQ * QS;                       // [BK][QS]
  float* Vs = Ks + BK * QS;                         // [BK][QS]
  float* Ps = Vs + BK * QS;                         // [FBQ][PS] dS
  float* Ls = Ps + FBQ * PS;                        // [FBQ]
  float* Dsm = Ls + FBQ;                            // [FBQ]
  int* rpos = reinterpret_cast<int*>(Dsm + FBQ);    // [FBQ]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = H / KV, rows = Sq * G, r0 = blockIdx.x * FBQ, qbase = Skv - Sq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int idx = tid; idx < FBQ * HD; idx += FT) {
    const int lr = idx / HD, d = idx % HD, r = r0 + lr;
    const bool ok = r < rows;
    const long long off = ok ? row_off(b, Sq, H, G, kvh, r, HD) + d : 0;
    Qs[lr * QS + d] = ok ? q[off] : 0.f;
    dOs[lr * QS + d] = ok ? dout[off] : 0.f;
  }
  // D of rows ty*4 + i, summed by the 16 lanes of the row group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i, r = r0 + lr;
    float acc = 0.f;
    if (r < rows) {
      const long long off = row_off(b, Sq, H, G, kvh, r, HD);
#pragma unroll
      for (int e = 0; e < E; ++e) acc = fmaf(o[off + tx + 16 * e], dout[off + tx + 16 * e], acc);
    }
    acc = rt::group16_sum(acc);
    if (tx == 0) {
      Dsm[lr] = acc;
      Ls[lr] = r < rows ? lse[lse_off(b, Sq, H, G, kvh, r)] : PAD_LSE;
      rpos[lr] = qbase + min(r, rows - 1) / G;
      if (r < rows) delta[lse_off(b, Sq, H, G, kvh, r)] = acc;
    }
  }
  const int q_lo = qbase + r0 / G, q_hi = qbase + (min(r0 + FBQ, rows) - 1) / G;

  float acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * BK;
    if (!tiles_meet(k_lo, k_lo + BK - 1, q_lo, q_hi, causal, window, chunk)) continue;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += FT) {
      const int c = idx / HD, d = idx % HD, kp = k_lo + c;
      const bool ok = kp < Skv;
      const long long off = ok ? (((long long)b * Skv + kp) * KV + kvh) * HD + d : 0;
      Ks[c * QS + d] = ok ? k[off] : 0.f;
      Vs[c * QS + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float s[4][JK], dp[4][JK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[JK], vv[JK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * QS + d];
        gv[i] = dOs[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        kv[j] = Ks[(tx + 16 * j) * QS + d];
        vv[j] = Vs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int kp = k_lo + tx + 16 * j;
        const float p = visible(kp, rpos[lr], Skv, causal, window, chunk)
                            ? expf(s[i][j] * scale - Ls[lr])
                            : 0.f;
        Ps[lr * PS + tx + 16 * j] = p * (dp[i][j] - Dsm[lr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kv = Ks[c * QS + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], kv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    const long long off = row_off(b, Sq, H, G, kvh, r, HD);
#pragma unroll
    for (int e = 0; e < E; ++e) dq[off + tx + 16 * e] = acc[i][e] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(FT)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                               int H, int KV, int causal, int window, int chunk, float scale) {
  constexpr int BKV = FCfg<HD>::BKV, BQR = FCfg<HD>::BQR, QS = HD + 1, PS = BQR + 1;
  constexpr int KI = BKV / 16, JQ = BQR / 16, E = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BKV][QS]
  float* Vs = Ks + BKV * QS;                        // [BKV][QS]
  float* Qs = Vs + BKV * QS;                        // [BQR][QS]
  float* dOs = Qs + BQR * QS;                       // [BQR][QS]
  float* Ps = dOs + BQR * QS;                       // [BKV][PS] P^T
  float* dSs = Ps + BKV * PS;                       // [BKV][PS] dS^T
  float* Ls = dSs + BKV * PS;                       // [BQR]
  float* Dl = Ls + BQR;                             // [BQR]
  int* Qp = reinterpret_cast<int*>(Dl + BQR);       // [BQR]

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BKV;
  const int G = H / KV, rows = Sq * G, qbase = Skv - Sq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int idx = tid; idx < BKV * HD; idx += FT) {
    const int c = idx / HD, d = idx % HD, kp = k0 + c;
    const bool ok = kp < Skv;
    const long long off = ok ? (((long long)b * Skv + kp) * KV + kvh) * HD + d : 0;
    Ks[c * QS + d] = ok ? k[off] : 0.f;
    Vs[c * QS + d] = ok ? v[off] : 0.f;
  }
  const int k_lo = k0, k_hi = min(k0 + BKV, Skv) - 1;

  float dka[KI][E], dva[KI][E];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int n_qt = (rows + BQR - 1) / BQR;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q_lo = qbase + qt * BQR / G, q_hi = qbase + (min(qt * BQR + BQR, rows) - 1) / G;
    if (!tiles_meet(k_lo, k_hi, q_lo, q_hi, causal, window, chunk)) continue;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BQR * HD; idx += FT) {
      const int lr = idx / HD, d = idx % HD, r = qt * BQR + lr;
      const bool ok = r < rows;
      const long long off = ok ? row_off(b, Sq, H, G, kvh, r, HD) + d : 0;
      Qs[lr * QS + d] = ok ? q[off] : 0.f;
      dOs[lr * QS + d] = ok ? dout[off] : 0.f;
    }
    if (tid < BQR) {
      const int r = qt * BQR + tid;
      const bool ok = r < rows;
      Ls[tid] = ok ? lse[lse_off(b, Sq, H, G, kvh, r)] : PAD_LSE;
      Dl[tid] = ok ? delta[lse_off(b, Sq, H, G, kvh, r)] : 0.f;
      Qp[tid] = qbase + min(r, rows - 1) / G;
    }
    __syncthreads();

    // keys ty * KI + i, query rows tx + 16 j
    float st[KI][JQ], dpt[KI][JQ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < JQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[KI], vv[KI], qv[JQ], gv[JQ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kv[i] = Ks[(ty * KI + i) * QS + d];
        vv[i] = Vs[(ty * KI + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        qv[j] = Qs[(tx + 16 * j) * QS + d];
        gv[j] = dOs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < JQ; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int c = ty * KI + i;
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        const int lr = tx + 16 * j;
        const float p = visible(k0 + c, Qp[lr], Skv, causal, window, chunk)
                            ? expf(st[i][j] * scale - Ls[lr])
                            : 0.f;
        Ps[c * PS + lr] = p;
        dSs[c * PS + lr] = p * (dpt[i][j] - Dl[lr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQR; ++r) {
      float pv[KI], sv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = Ps[(ty * KI + i) * PS + r];
        sv[i] = dSs[(ty * KI + i) * PS + r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float gv = dOs[r * QS + tx + 16 * e];
        const float qv = Qs[r * QS + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          dva[i][e] = fmaf(pv[i], gv, dva[i][e]);
          dka[i][e] = fmaf(sv[i], qv, dka[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kp = k0 + ty * KI + i;
    if (kp >= Skv) continue;
    const long long off = (((long long)b * Skv + kp) * KV + kvh) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + tx + 16 * e] = dka[i][e] * scale;
      dv[off + tx + 16 * e] = dva[i][e];
    }
  }
}

// ======================================================================
// launch
// ======================================================================
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                int Skv, int H, int KV, int causal, int window, int chunk, float scale,
                cudaStream_t stream) {
  using S = MmaSmem<HD>;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_mma_kernel<HD>, S::DQ);
  if (err == cudaSuccess) err = allow_smem(flash_attention_bwd_dkv_mma_kernel<HD>, S::DKV);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const dim3 grid_q((unsigned)((Sq * G + MBQ - 1) / MBQ), (unsigned)KV, (unsigned)B);
  flash_attention_bwd_dq_mma_kernel<HD><<<grid_q, MT, S::DQ, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), Sq, Skv, H, KV, causal, window, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)((Skv + S::BC - 1) / S::BC), (unsigned)KV, (unsigned)B);
  flash_attention_bwd_dkv_mma_kernel<HD><<<grid_k, MT, S::DKV, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, H, KV, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int KV, int causal, int window, int chunk, float scale,
               cudaStream_t stream) {
  using C = FCfg<HD>;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_kernel<HD>, C::DQ);
  if (err == cudaSuccess) err = allow_smem(flash_attention_bwd_dkv_kernel<HD>, C::DKV);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const dim3 grid_q((unsigned)((Sq * G + FBQ - 1) / FBQ), (unsigned)KV, (unsigned)B);
  flash_attention_bwd_dq_kernel<HD><<<grid_q, FT, C::DQ, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), Sq, Skv, H, KV, causal, window, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)((Skv + C::BKV - 1) / C::BKV), (unsigned)KV, (unsigned)B);
  flash_attention_bwd_dkv_kernel<HD><<<grid_k, FT, C::DKV, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, H, KV, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int Sq, int Skv, int H, int KV, int causal, int window, int chunk,
           float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                          window, chunk, scale, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                           window, chunk, scale, s);
  return -1;
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, KV, hd); lse and
// delta (scratch, written by the dQ pass): (B, H, Sq) float32; all
// contiguous and 16-byte aligned. dtype 0 = float32, 1 = bfloat16. Two
// launches on one stream: the dQ pass, then the dK/dV pass. Returns 0, a
// cudaError_t code, or -1 for an unsupported hd / dtype.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int KV, int hd, int causal,
                                          int window, int chunk, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                        window, chunk, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                         window, chunk, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                         window, chunk, scale, s);
  }
  return -1;
}
