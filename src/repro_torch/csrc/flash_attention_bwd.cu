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
// cores.
//
// Two passes, no atomics, so a backward repeats bit for bit: a dQ pass
// that computes D = rowsum(do * o) for its rows (stored to delta) and
// accumulates dq over the live key tiles, then a dK/dV pass that owns keys
// of one kv head and walks the live tiles of query rows of all G heads of
// its group, recomputing P from lse and reading D. P and dS are rounded to
// bf16 for their products, the one numeric departure from the plain
// version, whose products are float32.
// bf16 (flash_attention_bwd_{dq,dkv}_wgmma_kernel): three warpgroups, TMA
// loads into a ring of stages on mbarriers, wgmma with float32 sums in
// registers. dQ pass: a block owns one head's 128 positions (64 a
// consumer), K and V stream by; S = Q K^T and dP = dO V^T from shared
// memory, dS in registers is the A operand of dQ += dS K. dK/dV pass: a
// block owns 128 keys (64 a consumer) at hd 64; 64 keys at hd 128 and 256,
// both consumers on them with hd split in two (S^T and dP^T computed by
// both), so that the float32 sums fit; a step is one head's 64 positions
// (32 at hd 256); S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and
// dS^T in registers are the A operands of dV += P^T dO and dK += dS^T Q. At
// hd 256 a consumer's dk and dv sums for 128 columns would be 128
// registers, so the pass runs twice, dV alone then dK alone (S^T computed
// in each), and since one kv head at batch 1 gives too few blocks, each kv
// head's G query heads are split into head groups whose float32 partial
// sums are added in order by flash_attention_bwd_dkv_reduce_kernel. Under a
// causal mask both passes launch their heaviest blocks first.
// Registers and dynamic shared memory of the wgmma instances (ptxas and
// cuobjdump, sm_90a): 168 a thread at launch, the consumers under
// setmaxnreg using up to 142 (dQ hd 64), 172 (dQ hd 128), 186 (dQ hd 256),
// 165 (dK/dV hd 64 and 128) and 122 (dV and dK hd 256); dQ 99912, 198216
// and 198184 bytes, dK/dV 103496, 169032 and 201800 bytes at hd 64, 128 and
// 256; no spill (chip_smoke.py phase 1 holds it). ptxas kept the dK/dV
// consumers near 168 registers even under setmaxnreg, so their tiles are
// sized to fit that: hence the hd split at 128 and the two halves at 256.
// float32 (flash_attention_bwd_{dq,dkv}_kernel): exact FMA on the CUDA
// cores (no TF32), register-tiled 4 x 4 over 256 threads as the forward's
// float32 body of attention_common.cuh; P and dS pass through shared
// memory.
#include "attention_common.cuh"
#include "wgmma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float PAD_LSE = 1e30f;   // padding rows: P = exp(s - 1e30) = 0

using hop::align1024;
using wa::tiles_full;
using wa::tiles_meet;
using wa::visible;
using wa::WS_CONSUMER_WARPS;
using wa::WS_THREADS;

// the element offset of query row r (position r / G of head kvh * G + r % G)
__device__ __forceinline__ long long row_off(int b, int Sq, int H, int G, int kvh, int r, int HD) {
  return ((long long)b * Sq * H + (long long)(r / G) * H + kvh * G + r % G) * HD;
}
__device__ __forceinline__ long long lse_off(int b, int Sq, int H, int G, int kvh, int r) {
  return ((long long)b * H + kvh * G + r % G) * Sq + r / G;
}

// ======================================================================
// bf16 on wgmma: warp-specialised, fed by TMA
// ======================================================================
// A block is three warpgroups: warpgroup 0 produces (warp 0's lane 0
// issues the TMA loads; in the dK/dV pass warp 1 copies each stage's lse
// and D), warpgroups 1 and 2 consume: wgmma on the tiles that have landed.
// Tiles are boxes of R rows x 64 bf16 in the 128-byte swizzle
// (hopper_common.cuh), 1024-byte aligned; hd 128 and 256 are 2 or 4 boxes
// side by side. A query tile is one head's consecutive positions: a box
// (64 of hd, 1 head, R positions, 1 batch) of q viewed as (hd, H, Sq, B),
// so G need not divide the tile, lse and D of a tile are contiguous and
// positions past Sq load as zeros.
// KV_KEYS keys a dK/dV block (64 a consumer warpgroup, or at hd 256 the
// same 64 with hd split in two), KV_ROWS query positions a step of it;
// Q_ROWS query positions a dQ block (64 a consumer), Q_KEYS keys a step;
// the ring's stages. kernels/flash_attention.py WGMMA_TILES mirrors these.
template <int HD> struct WCfg;
template <> struct WCfg<64> {
  static constexpr int KV_KEYS = 128, KV_ROWS = 64, KV_STAGES = 4, Q_ROWS = 128, Q_KEYS = 64,
                       Q_STAGES = 4;
};
template <> struct WCfg<128> {
  static constexpr int KV_KEYS = 64, KV_ROWS = 64, KV_STAGES = 4, Q_ROWS = 128, Q_KEYS = 64,
                       Q_STAGES = 4;
};
template <> struct WCfg<256> {
  static constexpr int KV_KEYS = 64, KV_ROWS = 32, KV_STAGES = 4, Q_ROWS = 128, Q_KEYS = 32,
                       Q_STAGES = 2;
};

// Shared memory of the dK/dV pass (byte offsets from the 1024-aligned
// base): K and V once, then the ring's stages of Q, dO, lse * log2 e and D,
// then the barriers; BYTES adds the alignment slack.
template <int HD> struct DkvLayout {
  using C = WCfg<HD>;
  static constexpr int KB = C::KV_KEYS, BQ = C::KV_ROWS, ST = C::KV_STAGES;
  static constexpr int K = 0, V = KB * HD * 2, RING = 2 * KB * HD * 2;
  static constexpr int SQ = 0, SDO = BQ * HD * 2, SL = 2 * BQ * HD * 2;
  static constexpr int STAGE = (SL + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int BARS = RING + ST * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8 + 1024;
  static_assert(STAGE % 1024 == 0 && BYTES <= 232448, "shared memory of a block");
};
// ... of the dQ pass: Q and dO once, the ring's stages of K and V, D of the
// block's rows, the barriers
template <int HD> struct DqLayout {
  using C = WCfg<HD>;
  static constexpr int QR = C::Q_ROWS, BK = C::Q_KEYS, ST = C::Q_STAGES;
  static constexpr int Q = 0, DO = QR * HD * 2, RING = 2 * QR * HD * 2;
  static constexpr int SK = 0, SV = BK * HD * 2, STAGE = 2 * BK * HD * 2;
  static constexpr int DSM = RING + ST * STAGE;
  static constexpr int BARS = DSM + QR * 4;
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8 + 1024;
  static_assert(STAGE % 1024 == 0 && BYTES <= 232448, "shared memory of a block");
};

// The dK/dV block's tile and walk. Blocks run key blocks slowest (the
// first wave takes the first key block of every head group, kv head and
// batch: under a causal mask the heaviest), then HS head groups, kv heads,
// batches. HS > 1 where key blocks x kv heads x batches would not fill the
// card (MQA at batch 1): group hs walks heads [hs G / HS, (hs + 1) G / HS)
// of the kv head's G, writes float32 partial sums, and
// flash_attention_bwd_dkv_reduce_kernel adds the groups in order. The live
// position tiles form one interval; step i is position tile pt0 + i / ng of
// head kvh * G + g0 + i % ng.
struct DkvWalk {
  int kb, kvh, b, hs, g0, ng, pt0, n_steps;
};
template <int KB, int BQ>
__device__ __forceinline__ DkvWalk dkv_walk(int B, int Sq, int Skv, int H, int KV, int HS,
                                            int causal, int window, int chunk) {
  const int per = KV * B * HS, kb = blockIdx.x / per, r = blockIdx.x % per;
  const int hs = r / (KV * B), kvh = r % KV, b = r / KV % B;
  const int G = H / KV, g0 = hs * G / HS, ng = (hs + 1) * G / HS - g0;
  const int qbase = Skv - Sq, k_lo = kb * KB, k_hi = min(kb * KB + KB, Skv) - 1;
  auto live = [&](int pt) {
    return tiles_meet(k_lo, k_hi, qbase + pt * BQ, qbase + min(pt * BQ + BQ, Sq) - 1, causal,
                      window, chunk);
  };
  int pt1 = (Sq + BQ - 1) / BQ - 1;
  while (pt1 >= 0 && !live(pt1)) --pt1;
  int pt0 = 0;
  while (pt0 <= pt1 && !live(pt0)) ++pt0;
  return {kb, kvh, b, hs, g0, ng, pt0, (pt1 - pt0 + 1) * ng};
}

// MODE 0 sums dK and dV, 1 dV alone, 2 dK alone: at hd 256 a consumer's
// float32 sums of both gradients for 64 keys x 128 columns would be 128
// registers, so hd 256 runs MODE 1, then MODE 2 (S^T computed in each).
template <int HD, int MODE>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_attention_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_do,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, float* __restrict__ ws, int B,
                                     int Sq, int Skv, int H, int KV, int HS, int causal,
                                     int window, int chunk, float scale) {
  using L = DkvLayout<HD>;
  constexpr int KB = L::KB, BQ = L::BQ, ST = L::ST, NB = HD / 64;
  constexpr bool SPLIT = KB == 64;          // both consumers on the same keys, hd split
  constexpr int NC = SPLIT ? HD / 2 : HD;   // columns of dk / dv a consumer sums
  constexpr bool DV = MODE != 2, DK = MODE != 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = hop::warpgroup_idx(), warp = hop::warp_in_group();
  const int lane = tid % 32;
  if (tid == 0) {
    hop::bar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(&full[s], 1 + 32);
      hop::bar_init(&empty[s], WS_CONSUMER_WARPS);
    }
    hop::fence_bar_init();
  }
  __syncthreads();

  // Everything below is computed within each branch, after setmaxnreg:
  // values live into both branches would have to fit the producer's
  // registers and spill.
  if (wg == 0) {
    hop::regs_dec<40>();
    const DkvWalk w = dkv_walk<KB, BQ>(B, Sq, Skv, H, KV, HS, causal, window, chunk);
    const int G = H / KV, kvh = w.kvh, b = w.b, k0 = w.kb * KB;
    if (warp == 0 && lane == 0) {
      hop::bar_arrive_tx(kv_full, (DK ? 2 : 1) * KB * HD * 2);
      for (int j = 0; j < NB; ++j) {
        hop::tma_load_4d(sm + L::K + j * KB * 128, &tm_k, kv_full, 64 * j, kvh, k0, b);
        if (DK) hop::tma_load_4d(sm + L::V + j * KB * 128, &tm_v, kv_full, 64 * j, kvh, k0, b);
      }
      for (int i = 0; i < w.n_steps; ++i) {
        const int s = i % ST;
        hop::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        unsigned char* st = sm + L::RING + s * L::STAGE;
        const int p0 = (w.pt0 + i / w.ng) * BQ, h = kvh * G + w.g0 + i % w.ng;
        hop::bar_arrive_tx(&full[s], 2 * BQ * HD * 2);
        for (int j = 0; j < NB; ++j) {
          hop::tma_load_4d(st + L::SQ + j * BQ * 128, &tm_q, &full[s], 64 * j, h, p0, b);
          hop::tma_load_4d(st + L::SDO + j * BQ * 128, &tm_do, &full[s], 64 * j, h, p0, b);
        }
      }
    } else if (warp == 1) {
      // lse * log2 e and D of the stage's positions (past Sq: PAD_LSE, so P = 0)
      for (int i = 0; i < w.n_steps; ++i) {
        const int s = i % ST;
        hop::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        float* ls = reinterpret_cast<float*>(sm + L::RING + s * L::STAGE + L::SL);
        const int p0 = (w.pt0 + i / w.ng) * BQ;
        const long long base = ((long long)b * H + kvh * G + w.g0 + i % w.ng) * Sq;
        for (int c = lane; c < BQ; c += 32) {
          const bool ok = p0 + c < Sq;
          ls[c] = ok ? lse[base + p0 + c] * LOG2E : PAD_LSE;
          if (DK) ls[BQ + c] = ok ? delta[base + p0 + c] : 0.f;
        }
        hop::bar_arrive(&full[s]);
      }
    }
  } else {
    hop::regs_inc<232>();
    const DkvWalk w = dkv_walk<KB, BQ>(B, Sq, Skv, H, KV, HS, causal, window, chunk);
    const int qbase = Skv - Sq, k0 = w.kb * KB;
    const int cw = wg - 1, g = lane >> 2, t = lane & 3;
    const int key0 = SPLIT ? k0 : k0 + 64 * cw, col0 = SPLIT ? cw * NC : 0;
    const int wk_lo = key0, wk_hi = min(key0 + 64, Skv) - 1;
    const float scale_log2 = scale * LOG2E;
    int kp[2];
    kp[0] = key0 + warp * 16 + g;
    kp[1] = kp[0] + 8;
    float dka[DK ? NC / 2 : 1], dva[DV ? NC / 2 : 1];
    hop::zero_acc(dka);
    hop::zero_acc(dva);
    const unsigned char* Kt = sm + L::K + (SPLIT ? 0 : cw * 64 * 128);
    const unsigned char* Vt = sm + L::V + (SPLIT ? 0 : cw * 64 * 128);
    hop::bar_wait(kv_full, 0);

    for (int i = 0; i < w.n_steps; ++i) {
      const int s = i % ST;
      const int p0 = (w.pt0 + i / w.ng) * BQ;
      const bool live = wk_lo <= wk_hi && tiles_meet(wk_lo, wk_hi, qbase + p0,
                                                     qbase + min(p0 + BQ, Sq) - 1, causal,
                                                     window, chunk);
      hop::bar_wait(&full[s], (i / ST) & 1);
      const unsigned char* st = sm + L::RING + s * L::STAGE;
      if (live) {
        float sa[BQ / 2], pa[DK ? BQ / 2 : 1];   // S^T = K Q^T, dP^T = V dO^T
        const uint64_t k_d = hop::fresh(hop::desc(Kt, 16, 1024));
        const uint64_t q_d = hop::fresh(hop::desc(st + L::SQ, 16, 1024));
        const uint64_t v_d = hop::fresh(hop::desc(Vt, 16, 1024));
        const uint64_t o_d = hop::fresh(hop::desc(st + L::SDO, 16, 1024));
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int off = (kk / 4) * KB * 128 + (kk % 4) * 32;
          const int qoff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          hop::mma_ss<0, 0>(sa, hop::desc_at(k_d, off), hop::desc_at(q_d, qoff), kk > 0,
                            hop::Tag<BQ>());
          if constexpr (DK)
            hop::mma_ss<0, 0>(pa, hop::desc_at(v_d, off), hop::desc_at(o_d, qoff), kk > 0,
                              hop::Tag<BQ>());
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_acc(sa);
        if constexpr (DK) hop::fence_acc(pa);
        const float* ls = reinterpret_cast<const float*>(st + L::SL);
        const int qp0 = qbase + p0;
        // positions past Sq need no mask: their lse is PAD_LSE, so P = 0
        if (tiles_full(key0, key0 + 63, qp0, qp0 + BQ - 1, Skv, causal, window, chunk)) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = j * 8 + 2 * t + (e & 1);
              const float p = exp2f(sa[4 * j + e] * scale_log2 - ls[c]);
              sa[4 * j + e] = p;                                       // P^T
              if constexpr (DK) pa[4 * j + e] = p * (pa[4 * j + e] - ls[BQ + c]);   // dS^T
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = j * 8 + 2 * t + (e & 1);
              const float p = visible(kp[e >> 1], qp0 + c, Skv, causal, window, chunk)
                                  ? exp2f(sa[4 * j + e] * scale_log2 - ls[c])
                                  : 0.f;
              sa[4 * j + e] = p;
              if constexpr (DK) pa[4 * j + e] = p * (pa[4 * j + e] - ls[BQ + c]);
            }
          }
        }
        // dV += P^T dO, dK += dS^T Q: B MN-major, columns col0.. (boxes of
        // 64 columns BQ * 128 bytes apart), rows 16 kk..
        const int coff = (col0 / 64) * BQ * 128;
        uint32_t ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          if constexpr (DV) hop::acc_to_a(ap[kk], sa, kk);
          if constexpr (DK) hop::acc_to_a(as[kk], pa, kk);
        }
        hop::wg_fence();
        if constexpr (DV) {
          const uint64_t om_d = hop::fresh(hop::desc(st + L::SDO + coff, BQ * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            hop::mma_rs<1>(dva, ap[kk], hop::desc_at(om_d, kk * 2048), 1, hop::Tag<NC>());
        }
        if constexpr (DK) {
          const uint64_t qm_d = hop::fresh(hop::desc(st + L::SQ + coff, BQ * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            hop::mma_rs<1>(dka, as[kk], hop::desc_at(qm_d, kk * 2048), 1, hop::Tag<NC>());
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        if constexpr (DK) hop::fence_acc(dka);
        if constexpr (DV) hop::fence_acc(dva);
      }
      __syncwarp();
      if (lane == 0) hop::bar_arrive(&empty[s]);
    }

    // rows past Skv are not written; with head groups, float32 partial sums
    // (dK unscaled) to the workspace, [2][HS][B][Skv][KV][HD]
    const long long n = (long long)B * Skv * KV * HD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kp[h] >= Skv) continue;
      const long long off =
          (((long long)w.b * Skv + kp[h]) * KV + w.kvh) * HD + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int a = 4 * j + 2 * h;
        if constexpr (DK) {
          if (HS == 1)
            *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
                __floats2bfloat162_rn(dka[a] * scale, dka[a + 1] * scale);
          else
            *reinterpret_cast<float2*>(ws + w.hs * n + off + j * 8) =
                make_float2(dka[a], dka[a + 1]);
        }
        if constexpr (DV) {
          if (HS == 1)
            *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
                __floats2bfloat162_rn(dva[a], dva[a + 1]);
          else
            *reinterpret_cast<float2*>(ws + (HS + w.hs) * n + off + j * 8) =
                make_float2(dva[a], dva[a + 1]);
        }
      }
    }
  }
}

// dK = scale x the sum of the HS head groups' partial sums, dV their sum,
// the groups added in order (so a backward repeats bit for bit)
__global__ void flash_attention_bwd_dkv_reduce_kernel(const float* __restrict__ ws,
                                                      bf16* __restrict__ dk,
                                                      bf16* __restrict__ dv, long long n,
                                                      int HS, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int h = 0; h < HS; ++h) {
      sk += ws[h * n + i];
      sv += ws[(HS + h) * n + i];
    }
    dk[i] = __float2bfloat16_rn(sk * scale);
    dv[i] = __float2bfloat16_rn(sv);
  }
}

template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    const float* __restrict__ lse, float* __restrict__ delta,
                                    bf16* __restrict__ dq, int B, int Sq, int Skv, int H,
                                    int KV, int causal, int window, int chunk, float scale) {
  using L = DqLayout<HD>;
  constexpr int QR = L::QR, BK = L::BK, ST = L::ST, NB = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* Dsm = reinterpret_cast<float*>(sm + L::DSM);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = hop::warpgroup_idx(), warp = hop::warp_in_group();
  const int lane = tid % 32;
  if (tid == 0) {
    hop::bar_init(qdo_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], WS_CONSUMER_WARPS);
    }
    hop::fence_bar_init();
  }
  __syncthreads();

  // Everything below is computed within each branch, after setmaxnreg.
  if (wg == 0) {
    hop::regs_dec<24>();
    const wa::QWalk w = wa::q_walk<QR, BK>(B, Sq, Skv, H, causal, window, chunk);
    const int h = w.h, b = w.b, kvh = h / (H / KV), p0 = w.qb * QR, kt0 = w.kt0;
    const int n_steps = w.n_steps;
    if (warp == 0 && lane == 0) {
      hop::bar_arrive_tx(qdo_full, 2 * QR * HD * 2);
      for (int j = 0; j < NB; ++j) {
        hop::tma_load_4d(sm + L::Q + j * QR * 128, &tm_q, qdo_full, 64 * j, h, p0, b);
        hop::tma_load_4d(sm + L::DO + j * QR * 128, &tm_do, qdo_full, 64 * j, h, p0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % ST;
        hop::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        unsigned char* st = sm + L::RING + s * L::STAGE;
        hop::bar_arrive_tx(&full[s], 2 * BK * HD * 2);
        for (int j = 0; j < NB; ++j) {
          hop::tma_load_4d(st + L::SK + j * BK * 128, &tm_k, &full[s], 64 * j, kvh,
                           (kt0 + i) * BK, b);
          hop::tma_load_4d(st + L::SV + j * BK * 128, &tm_v, &full[s], 64 * j, kvh,
                           (kt0 + i) * BK, b);
        }
      }
    }
  } else {
    hop::regs_inc<240>();
    const wa::QWalk w = wa::q_walk<QR, BK>(B, Sq, Skv, H, causal, window, chunk);
    const int h = w.h, b = w.b, p0 = w.qb * QR, kt0 = w.kt0, n_steps = w.n_steps;
    const int qbase = Skv - Sq, q_lo = qbase + p0;
    const int cw = wg - 1, g = lane >> 2, t = lane & 3;
    // D = rowsum(do * o) of this consumer's 64 rows (warp w: 16w..16w+15),
    // stored for the dK/dV pass
    for (int i = 0; i < 16; ++i) {
      const int lr = cw * 64 + warp * 16 + i, p = p0 + lr;
      float acc = 0.f;
      if (p < Sq) {
        const long long off = (((long long)b * Sq + p) * H + h) * HD;
        for (int d = 2 * lane; d < HD; d += 64) {
          const float2 ov =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + d));
          const float2 gv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
          acc = fmaf(ov.x, gv.x, acc);
          acc = fmaf(ov.y, gv.y, acc);
        }
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
      if (lane == 0) {
        Dsm[lr] = acc;
        if (p < Sq) delta[((long long)b * H + h) * Sq + p] = acc;
      }
    }
    hop::named_sync(1 + cw, 128);
    int qp[2];
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = cw * 64 + warp * 16 + g + 8 * r, p = p0 + lr;
      qp[r] = qbase + p;
      l2[r] = p < Sq ? lse[((long long)b * H + h) * Sq + p] * LOG2E : PAD_LSE;
      dd[r] = Dsm[lr];
    }
    const int wq_lo = q_lo + cw * 64, wq_hi = min(q_lo + cw * 64 + 64, qbase + Sq) - 1;
    const float scale_log2 = scale * LOG2E;
    float dqa[HD / 2];
    hop::zero_acc(dqa);
    const unsigned char* Qt = sm + L::Q + cw * 64 * 128;
    const unsigned char* dOt = sm + L::DO + cw * 64 * 128;
    hop::bar_wait(qdo_full, 0);

    for (int i = 0; i < n_steps; ++i) {
      const int s = i % ST, kt = kt0 + i;
      hop::bar_wait(&full[s], (i / ST) & 1);
      const unsigned char* st = sm + L::RING + s * L::STAGE;
      if (wq_lo <= wq_hi &&
          tiles_meet(kt * BK, kt * BK + BK - 1, wq_lo, wq_hi, causal, window, chunk)) {
        float sa[BK / 2], pa[BK / 2];   // S = Q K^T, dP = dO V^T
        const uint64_t q_d = hop::fresh(hop::desc(Qt, 16, 1024));
        const uint64_t o_d = hop::fresh(hop::desc(dOt, 16, 1024));
        const uint64_t k_d = hop::fresh(hop::desc(st + L::SK, 16, 1024));
        const uint64_t v_d = hop::fresh(hop::desc(st + L::SV, 16, 1024));
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int qoff = (kk / 4) * QR * 128 + (kk % 4) * 32;
          const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
          hop::mma_ss<0, 0>(sa, hop::desc_at(q_d, qoff), hop::desc_at(k_d, koff), kk > 0,
                            hop::Tag<BK>());
          hop::mma_ss<0, 0>(pa, hop::desc_at(o_d, qoff), hop::desc_at(v_d, koff), kk > 0,
                            hop::Tag<BK>());
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_acc(sa);
        hop::fence_acc(pa);
        // rows past Sq need no mask: their lse is PAD_LSE, so P = 0
        if (tiles_full(kt * BK, kt * BK + BK - 1, wq_lo, q_lo + cw * 64 + 63, Skv, causal,
                       window, chunk)) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float p = exp2f(sa[4 * j + e] * scale_log2 - l2[r]);
              sa[4 * j + e] = p * (pa[4 * j + e] - dd[r]);   // dS
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = kt * BK + j * 8 + 2 * t + (e & 1), r = e >> 1;
              const float p = visible(kpos, qp[r], Skv, causal, window, chunk)
                                  ? exp2f(sa[4 * j + e] * scale_log2 - l2[r])
                                  : 0.f;
              sa[4 * j + e] = p * (pa[4 * j + e] - dd[r]);
            }
          }
        }
        uint32_t as[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hop::acc_to_a(as[kk], sa, kk);
        // dQ += dS K: B = K MN-major (hd along the boxes, BK * 128 bytes apart)
        const uint64_t km_d = hop::fresh(hop::desc(st + L::SK, BK * 128, 1024));
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hop::mma_rs<1>(dqa, as[kk], hop::desc_at(km_d, kk * 2048), 1, hop::Tag<HD>());
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_acc(dqa);
      }
      __syncwarp();
      if (lane == 0) hop::bar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + cw * 64 + warp * 16 + g + 8 * r;
      if (p >= Sq) continue;
      bf16* dst = dq + (((long long)b * Sq + p) * H + h) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
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

// ----------------------------------------------------------------------
// host: the wgmma body's tensor maps and launches
// ----------------------------------------------------------------------
// the dQ pass (it stores D), then the dK/dV pass, on the wgmma body with
// the wrapper's geometry (kernels/flash_attention.py), which must be this
// build's
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, void* dk, void* dv, float* ws, int B,
                int Sq, int Skv, int H, int KV, int causal, int window, int chunk, float scale,
                const int* geo, cudaStream_t stream) {
  using QL = DqLayout<HD>;
  using KL = DkvLayout<HD>;
  const int HS = geo[4];
  if (geo[0] != (Sq + QL::QR - 1) / QL::QR * H * B || geo[2] != QL::BYTES || HS < 1 ||
      HS > H / KV || (HS > 1 && !ws) ||
      geo[1] != (Skv + KL::KB - 1) / KL::KB * KV * B * HS || geo[3] != KL::BYTES)
    return -1;
  CUtensorMap mq, mdo, mk, mv;
  if (wa::head_map<HD>(&mq, q, B, Sq, H, QL::QR) ||
      wa::head_map<HD>(&mdo, dout, B, Sq, H, QL::QR) ||
      wa::head_map<HD>(&mk, k, B, Skv, KV, QL::BK) ||
      wa::head_map<HD>(&mv, v, B, Skv, KV, QL::BK))
    return -2;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_wgmma_kernel<HD>, QL::BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_wgmma_kernel<HD><<<geo[0], WS_THREADS, QL::BYTES, stream>>>(
      mq, mdo, mk, mv, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), B, Sq, Skv, H, KV, causal, window, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (wa::head_map<HD>(&mq, q, B, Sq, H, KL::BQ) ||
      wa::head_map<HD>(&mdo, dout, B, Sq, H, KL::BQ) ||
      wa::head_map<HD>(&mk, k, B, Skv, KV, KL::KB) ||
      wa::head_map<HD>(&mv, v, B, Skv, KV, KL::KB))
    return -2;
  // hd 256: dV (MODE 1), then dK (MODE 2); else both at once (MODE 0)
  constexpr int M0 = HD == 256 ? 1 : 0, M1 = HD == 256 ? 2 : 0;
  for (int m = 0; m < (HD == 256 ? 2 : 1); ++m) {
    auto kernel = m ? flash_attention_bwd_dkv_wgmma_kernel<HD, M1>
                    : flash_attention_bwd_dkv_wgmma_kernel<HD, M0>;
    err = allow_smem(kernel, KL::BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<geo[1], WS_THREADS, KL::BYTES, stream>>>(
        mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, B, Sq,
        Skv, H, KV, HS, causal, window, chunk, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (HS > 1) {
    const long long n = (long long)B * Skv * KV * HD;
    flash_attention_bwd_dkv_reduce_kernel<<<(unsigned)min((n + 255) / 256, 4096LL), 256, 0,
                                            stream>>>(ws, static_cast<bf16*>(dk),
                                                      static_cast<bf16*>(dv), n, HS, scale);
  }
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
           float* ws, int B, int Sq, int Skv, int H, int KV, int causal, int window, int chunk,
           float scale, const int* geo, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                          window, chunk, scale, s);
  if (dtype != 1) return -1;
  return launch_bf16<HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, ws, B, Sq, Skv, H, KV,
                         causal, window, chunk, scale, geo, s);
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, KV, hd); lse and
// delta (scratch, written by the dQ pass): (B, H, Sq) float32; all
// contiguous and 16-byte aligned. dtype 0 = float32, 1 = bfloat16; for
// bf16 the wrapper passes the wgmma body's geometry: dQ blocks,
// dK/dV blocks, the two passes' dynamic shared memory bytes (checked
// against this build's) and the dK/dV pass's head groups HS, with ws, a
// float32 workspace of 2 x HS x B x Skv x KV x hd, when HS > 1. Launches on
// one stream: the dQ pass, then the dK/dV pass (at hd 256 in bf16 two
// kernels, dV then dK), then with HS > 1 the groups' sum. Returns 0, a
// cudaError_t code, -1 for an unsupported hd / dtype / geometry, or -2
// when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, void* ws,
                                          int B, int Sq, int Skv, int H, int KV, int hd,
                                          int causal, int window, int chunk, float scale,
                                          int dtype, int dq_blocks, int dkv_blocks,
                                          int dq_smem, int dkv_smem, int head_groups,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(ws);
  const int geo[5] = {dq_blocks, dkv_blocks, dq_smem, dkv_smem, head_groups};
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, w, B, Sq, Skv, H, KV,
                        causal, window, chunk, scale, geo, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, w, B, Sq, Skv, H,
                         KV, causal, window, chunk, scale, geo, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, w, B, Sq, Skv, H,
                         KV, causal, window, chunk, scale, geo, s);
  }
  return -1;
}
