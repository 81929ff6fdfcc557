// K2: flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _attn_kernel / flash_attention
// (src/repro/kernels/flash_attention.py:27, :88): online-softmax GQA
// attention whose queries are the last sq of skv positions, with causal,
// sliding-window, same-chunk or no mask, skipping key tiles the mask
// leaves empty.
//
// What bounds it on the H100: at prefill lengths attention does ~4*hd
// operations per (query, key) pair on inputs read once, far above the ~295
// operations per byte where the tensor cores and not the 3.35 TB/s memory
// become the limit, so it is bound by the tensor cores' rate.
//
// bfloat16 has two bodies; the wrapper picks one by shape and names it
// (body 1 or 0) with its geometry, which the launcher checks against this
// build (kernels/flash_attention.py forward_body holds the rule; it never
// changes body on a failed build or launch). The rule: body 1 at every
// bf16 shape, since it measured faster than body 0 at every shape timed in
// one process on the card (PERF.md); body 0 stays launchable beside it, so
// that a measurement can time the two on the same inputs.
//
// body 1, flash_attention_wgmma_kernel: warp-specialised, fed by TMA, as
// the backward's dQ pass (flash_attention_bwd.cu). 1 + CWG warpgroups:
// warpgroup 0 produces (setmaxnreg down to 24; warp 0's lane 0 loads the
// block's Q once, then keeps K and V tiles in flight through a ring of
// stages on mbarriers), the CWG consumers (setmaxnreg up) compute
// S = Q K^T by wgmma from shared memory, the online softmax in float32
// registers, then P, rounded to bf16, as the register A operand of
// O += P V (V read MN-major through its descriptor). The consumers take
// turns on the tensor cores (named barriers): in its turn a consumer
// issues S of this key tile and P V of its previous one, then runs its
// softmax while the others' products run; the steady loop holds no branch
// around a wgmma, or ptxas serialises the products (C7514), and a
// consumer whose rows a tile cannot reach only takes its turn. A block
// owns one head's consecutive query positions (a box of q viewed as (hd,
// H, Sq, B), wgmma_attention.cuh head_map), so G need not divide the tile;
// positions past Sq load as zeros and are not stored. The live key tiles
// form one interval (tiles_meet), each consumer's too, and a tile is
// masked per element only where it is not whole (tiles_full). Under a
// causal mask the heaviest blocks launch first. Tiles (FwdCfg): 64
// positions a consumer and 64-key tiles, three consumers at hd 64 (their
// sums fit 160 registers), two at hd 128; at hd 256 the block's 64
// positions go to both consumers, each computing the same S and summing O
// for half of hd (64 float32 registers), since a consumer's 64 x 256
// float32 O alone would be 128 registers. Numerics as body 0: NEG_INF =
// -1e30, l clamped at 1e-30, one division at the end, P rounded to bf16
// for its product (the running sum l over the float32 P); a whole tile's
// scale goes into one FFMA a score and 2^x is ex2.approx.ftz.
//
// body 0, flash_attention_mma_kernel: the mma.sync prefill body of
// prefill_common.cuh (ldmatrix from a cp.async ring) over contiguous keys
// (rt::DenseCache), the queries at positions Skv - Sq + [0, Sq). K1's
// chunks run the same body over block-table keys.
//
// float32: flash_attention_kernel, rt::tiled_attention of
// attention_common.cuh, float32 FMA on CUDA cores register-tiled 4x4:
// exact for float32 inputs (no TF32), as the Pallas body's float32 dots.
//
// Under autograd the wrapper passes lse, (B, H, Sq) float32: each query
// row's log-sum-exp of its scaled scores, stored by the same bodies for the
// backward (flash_attention_bwd.cu); null stores nothing.
//
// Grids: body 1, ceil(Sq / QR) * H * B blocks of 128 (1 + CWG) threads,
// FwdLayout<hd>::BYTES of dynamic shared memory; body 0, (ceil(sq * G /
// 64), KV, B) blocks of 128 threads, pf::MmaTile<hd>::SMEM bytes; float32,
// the same grid at 256 threads, rt::tile_smem_bytes<HD>() (67 KB at hd 64).
#include "prefill_common.cuh"
#include "wgmma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T, int HD>
__global__ void __launch_bounds__(rt::NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int Sq, int Skv, int H, int KV, int causal, int window, int chunk,
                       float scale) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  rt::tiled_attention<T, T, HD>(q, k, v, out, (long long)b * Sq * H * HD, b, H, kvh, H / KV, Sq,
                                Skv - Sq, Skv, causal, window, chunk, scale,
                                rt::DenseCache{Skv, KV}, lse);
}

template <int HD>
__global__ void __launch_bounds__(pf::MT)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                           int causal, int window, int chunk, float scale_log2) {
  pf::prefill_mma<HD>(q, k, v, out, Sq, H, KV, Skv - Sq, Skv, causal, window, chunk,
                      scale_log2, rt::DenseCache{Skv, KV}, lse);
}

// ----------------------------------------------------------------------
// body 1: wgmma, warp-specialised, fed by TMA
// ----------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// consumer warpgroups (CWG), query positions a block (QR: 64 a consumer,
// or at hd 256 the same 64 for both with hd split in two), keys a tile
// (BK), the ring's stages (ST). kernels/flash_attention.py FWD_TILES
// mirrors these.
template <int HD> struct FwdCfg;
template <> struct FwdCfg<64> {
  static constexpr int CWG = 3, QR = 192, BK = 64, ST = 4;
};
template <> struct FwdCfg<128> {
  static constexpr int CWG = 2, QR = 128, BK = 64, ST = 4;
};
template <> struct FwdCfg<256> {
  static constexpr int CWG = 2, QR = 64, BK = 64, ST = 3;
};

// Shared memory (byte offsets from the 1024-aligned base): the block's Q,
// then the ring's stages of K and V, then the barriers; BYTES adds the
// alignment slack. Q, K and V are boxes of rows x 64 bf16 side by side.
template <int HD> struct FwdLayout {
  using C = FwdCfg<HD>;
  static constexpr int CWG = C::CWG, QR = C::QR, BK = C::BK, ST = C::ST;
  static constexpr int THREADS = 128 * (1 + CWG);
  static constexpr bool SPLIT = QR < 64 * CWG;
  static constexpr int Q = 0, RING = QR * HD * 2;
  static constexpr int SK = 0, SV = BK * HD * 2, STAGE = 2 * BK * HD * 2;
  static constexpr int BARS = RING + ST * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8 + 1024;
  static_assert(RING % 1024 == 0 && STAGE % 1024 == 0 && BYTES <= 232448,
                "shared memory of a block");
  static_assert(SPLIT ? QR == 64 && CWG == 2 : QR == 64 * CWG, "rows of the consumers");
};

// The consumer's steps, each on the tile of one key tile. S = Q K^T into sa
// (K-major Q and K, k16 slices 32 bytes along a box, boxes QR * 128 and
// BK * 128 bytes apart).
template <int HD>
__device__ __forceinline__ void issue_s(float (&sa)[FwdCfg<HD>::BK / 2], const unsigned char* Qt,
                                        const unsigned char* Kt) {
  constexpr int QR = FwdCfg<HD>::QR, BK = FwdCfg<HD>::BK;
  const uint64_t q_d = hop::fresh(hop::desc(Qt, 16, 1024));
  const uint64_t k_d = hop::fresh(hop::desc(Kt, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hop::mma_ss<0, 0>(sa, hop::desc_at(q_d, (kk / 4) * QR * 128 + (kk % 4) * 32),
                      hop::desc_at(k_d, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0,
                      hop::Tag<BK>());
  hop::wg_commit();
}

// O += P V: P (bf16) the register A operand, V MN-major from Vt (the
// consumer's first column box; boxes BK * 128 bytes apart, keys 16 kk..
// 2048 bytes down)
template <int HD, int NC>
__device__ __forceinline__ void issue_pv(float (&o)[NC / 2],
                                         const uint32_t (&ap)[FwdCfg<HD>::BK / 16][4],
                                         const unsigned char* Vt) {
  constexpr int BK = FwdCfg<HD>::BK;
  const uint64_t v_d = hop::fresh(hop::desc(Vt, BK * 128, 1024));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hop::mma_rs<1>(o, ap[kk], hop::desc_at(v_d, kk * 2048), 1, hop::Tag<NC>());
  hop::wg_commit();
}

// 2^x on the MUFU alone (ex2.approx.ftz: results below 2^-126 flush to 0,
// far below what P's bf16 rounding keeps beside the row's largest term, 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile's scores in sa (rows g and g + 8 of the
// warp's 16, each shared by the quad of lanes 4g..4g+3), in the log2
// domain: the running max m and sum l updated, alpha the factor for O, sa
// left holding P. Where MASK (the tile is not whole for the consumer's
// rows) the scores are scaled first and the hidden ones set to NEG_INF, as
// the mma.sync body does; a whole tile is scaled inside one FFMA a score,
// p = 2^(s * scale - m), its max taken on the raw scores (scale > 0).
template <int BK, bool MASK>
__device__ __forceinline__ void online_softmax(float (&sa)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2, int k_lo,
                                               const int (&qp)[2], int t, int Skv, int causal,
                                               int window, int chunk) {
  if (MASK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sa[4 * j + e] * scale_log2;
        sa[4 * j + e] = wa::visible(k_lo + j * 8 + 2 * t + (e & 1), qp[e >> 1], Skv, causal,
                                    window, chunk)
                            ? x
                            : rt::NEG_INF;
      }
    }
  }
  const float sc = MASK ? 1.f : scale_log2;   // what takes sa to the log2 domain
  float rs[2] = {0.f, 0.f}, mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = sa[2 * r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mt = fmaxf(mt, fmaxf(sa[4 * j + 2 * r], sa[4 * j + 2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt * sc);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    mn[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(sa[4 * j + e], sc, mn[e >> 1]));
      sa[4 * j + e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int HD>
__global__ void __launch_bounds__(FwdLayout<HD>::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                             float* __restrict__ lse, int B, int Sq, int Skv, int H, int KV,
                             int causal, int window, int chunk, float scale_log2) {
  using L = FwdLayout<HD>;
  constexpr int CWG = L::CWG, QR = L::QR, BK = L::BK, ST = L::ST, NB = HD / 64;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int NC = SPLIT ? HD / 2 : HD;   // output columns a consumer sums
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = hop::warpgroup_idx(), warp = hop::warp_in_group();
  const int lane = tid % 32;
  if (tid == 0) {
    hop::bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], 4 * CWG);
    }
    hop::fence_bar_init();
  }
  __syncthreads();

  // Everything below is computed within each branch, after setmaxnreg
  // (128 x (24 + CWG x the consumers') <= 65536): values live into both
  // branches would have to fit the producer's registers and spill.
  if (wg == 0) {
    hop::regs_dec<24>();
    const wa::QWalk w = wa::q_walk<QR, BK>(B, Sq, Skv, H, causal, window, chunk);
    const int h = w.h, b = w.b, kvh = h / (H / KV), p0 = w.qb * QR, kt0 = w.kt0;
    const int n_steps = w.n_steps;
    if (warp == 0 && lane == 0) {
      hop::bar_arrive_tx(q_full, QR * HD * 2);
      for (int j = 0; j < NB; ++j)
        hop::tma_load_4d(sm + L::Q + j * QR * 128, &tm_q, q_full, 64 * j, h, p0, b);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % ST;
        hop::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        unsigned char* st = sm + L::RING + s * L::STAGE;
        hop::bar_arrive_tx(&full[s], L::STAGE);
        for (int j = 0; j < NB; ++j) {
          hop::tma_load_4d(st + L::SK + j * BK * 128, &tm_k, &full[s], 64 * j, kvh,
                           (kt0 + i) * BK, b);
          hop::tma_load_4d(st + L::SV + j * BK * 128, &tm_v, &full[s], 64 * j, kvh,
                           (kt0 + i) * BK, b);
        }
      }
    }
  } else {
    hop::regs_inc<CWG == 2 ? 240 : 160>();
    const wa::QWalk w = wa::q_walk<QR, BK>(B, Sq, Skv, H, causal, window, chunk);
    const int h = w.h, b = w.b, p0 = w.qb * QR, kt0 = w.kt0, n_steps = w.n_steps;
    const int cw = wg - 1, g = lane >> 2, t = lane & 3;
    const int row0 = SPLIT ? 0 : 64 * cw, col0 = SPLIT ? cw * NC : 0;
    const int qbase = Skv - Sq, q_lo = qbase + p0 + row0;
    const int wq_lo = q_lo, wq_hi = min(q_lo + 64, qbase + Sq) - 1;
    // this thread's two rows (g and g + 8 of its warp's 16); positions past
    // Sq hold zeros and are not stored
    int qp[2];
    qp[0] = q_lo + warp * 16 + g;
    qp[1] = qp[0] + 8;
    float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
    float o[NC / 2];
    hop::zero_acc(o);
    float sa[BK / 2];          // S = Q K^T of the current tile, then its P
    uint32_t ap[BK / 16][4];   // the previous live tile's P (bf16), for O += P V
    float alpha[2];
    const unsigned char* Qt = sm + L::Q + row0 * 128;
    auto stage = [&](int i) { return sm + L::RING + (i % ST) * L::STAGE; };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) hop::bar_arrive(&empty[i % ST]);
    };
    auto k_lo = [&](int i) { return (kt0 + i) * BK; };
    auto meets = [&](int i) {
      return wq_lo <= wq_hi &&
             wa::tiles_meet(k_lo(i), k_lo(i) + BK - 1, wq_lo, wq_hi, causal, window, chunk);
    };
    auto softmax = [&](int i) {
      if (wa::tiles_full(k_lo(i), k_lo(i) + BK - 1, wq_lo, q_lo + 63, Skv, causal, window, chunk))
        online_softmax<BK, false>(sa, m, l, alpha, scale_log2, k_lo(i), qp, t, Skv, causal,
                                  window, chunk);
      else
        online_softmax<BK, true>(sa, m, l, alpha, scale_log2, k_lo(i), qp, t, Skv, causal,
                                 window, chunk);
    };
    // this consumer's live steps [c0, c1] (one interval) of the block's
    const int c1 = [&] {
      int c = n_steps - 1;
      while (c >= 0 && !meets(c)) --c;
      return c;
    }();
    const int c0 = [&] {
      int c = 0;
      while (c <= c1 && !meets(c)) ++c;
      return c;
    }();
    hop::bar_wait(q_full, 0);

    // The consumers take turns on the tensor cores (named barrier 1 + c is
    // consumer c's turn): in its turn a consumer issues S of step i and
    // O += P V of its previous step, then passes the turn on, and runs its
    // softmax while the others' products run. Each consumer takes one turn
    // a step and one more to drain, live or not, so the turns go round in
    // order; the last consumer lets consumer 0 go first. The steady loop
    // holds no branch around a wgmma, so that ptxas keeps the products
    // asynchronous.
    auto turn = [&] { hop::named_sync(1 + cw, 256); };
    auto pass = [&] { hop::named_arrive(1 + (cw + 1) % CWG, 256); };
    if (cw == CWG - 1) hop::named_arrive(1, 256);
    for (int i = 0; i < c0 && i < n_steps; ++i) {   // dead steps before the live ones
      hop::bar_wait(&full[i % ST], (i / ST) & 1);
      turn();
      pass();
      release(i);
    }
    if (c0 <= c1) {
      hop::bar_wait(&full[c0 % ST], (c0 / ST) & 1);
      turn();
      hop::wg_fence();
      issue_s<HD>(sa, Qt, stage(c0) + L::SK);
      pass();
      hop::wg_wait<0>();
      hop::fence_acc(sa);
      softmax(c0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hop::acc_to_a(ap[kk], sa, kk);
      for (int i = c0 + 1; i <= c1; ++i) {
        hop::bar_wait(&full[i % ST], (i / ST) & 1);
        turn();
        hop::wg_fence();
        issue_s<HD>(sa, Qt, stage(i) + L::SK);
        issue_pv<HD, NC>(o, ap, stage(i - 1) + L::SV + (col0 / 64) * BK * 128);
        pass();
        hop::wg_wait<1>();
        hop::fence_acc(sa);
        softmax(i);
        hop::wg_wait<0>();
        hop::fence_acc(o);
        release(i - 1);
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hop::acc_to_a(ap[kk], sa, kk);
      }
      turn();   // drain: the last live step's product
      hop::wg_fence();
      issue_pv<HD, NC>(o, ap, stage(c1) + L::SV + (col0 / 64) * BK * 128);
      pass();
      hop::wg_wait<0>();
      hop::fence_acc(o);
      release(c1);
    } else {
      turn();   // no live step: the drain turn alone
      pass();
    }
    for (int i = max(c1 + 1, c0); i < n_steps; ++i) {   // dead steps after the live ones
      hop::bar_wait(&full[i % ST], (i / ST) & 1);
      turn();
      pass();
      release(i);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int p = p0 + row0 + warp * 16 + g + 8 * r;
      if (p >= Sq) continue;
      const float lc = fmaxf(lr, 1e-30f);
      if (lse != nullptr && t == 0 && col0 == 0)
        lse[((long long)b * H + h) * Sq + p] = m[r] * LN2 + logf(lc);
      bf16* dst = out + (((long long)b * Sq + p) * H + h) * HD + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / lc, o[4 * j + 2 * r + 1] / lc);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Sq, int Skv, int H, int KV, int causal, int window, int chunk, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = rt::tile_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const dim3 grid((unsigned)((Sq * G + rt::BQ - 1) / rt::BQ), (unsigned)KV, (unsigned)B);
  flash_attention_kernel<float, HD><<<grid, rt::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Sq, Skv, H, KV, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Skv, int H, int KV, int causal, int window, int chunk, float scale,
                int body, int blocks, int smem, cudaStream_t stream) {
  if (body == 0)
    return pf::launch<HD>(flash_attention_mma_kernel<HD>, B, Sq, H, KV, stream,
                          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv,
                          H, KV, causal, window, chunk, scale * LOG2E);
  using L = FwdLayout<HD>;
  if (body != 1 || blocks != (Sq + L::QR - 1) / L::QR * H * B || smem != L::BYTES) return -1;
  CUtensorMap mq, mk, mv;
  if (wa::head_map<HD>(&mq, q, B, Sq, H, L::QR) || wa::head_map<HD>(&mk, k, B, Skv, KV, L::BK) ||
      wa::head_map<HD>(&mv, v, B, Skv, KV, L::BK))
    return -2;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_attention_wgmma_kernel<HD><<<blocks, L::THREADS, L::BYTES, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, B, Sq, Skv, H, KV, causal, window, chunk,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int Sq, int Skv, int H, int KV, int causal, int window, int chunk, float scale,
           int body, int blocks, int smem, cudaStream_t s) {
  if (dtype == 0 && body == 0)
    return launch_f32<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, chunk, scale,
                           body, blocks, smem, s);
  return -1;
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); out: (B, Sq, H, hd); all
// contiguous and 16-byte aligned. lse: (B, H, Sq) float32, or null for
// none. dtype 0 = float32, 1 = bfloat16. body 0 = the mma.sync body (bf16)
// or the FMA body (float32), 1 = the wgmma body (bf16) with the wrapper's
// geometry: its blocks and dynamic shared memory bytes (checked against
// this build's; ignored for body 0). Returns 0, a cudaError_t code, -1 for
// an unsupported hd / dtype / body / geometry, or -2 when a tensor map
// cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                                      int causal, int window, int chunk, float scale,
                                      int dtype, int body, int blocks, int smem, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk, scale,
                        body, blocks, smem, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk,
                         scale, body, blocks, smem, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk,
                         scale, body, blocks, smem, s);
  }
  return -1;
}
