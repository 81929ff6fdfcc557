// K4: grouped (expert) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _gmm_kernel / moe_gmm
// (src/repro/kernels/moe_gmm.py:26, :47): jax.lax.ragged_dot semantics.
// Rows of x (T, K) are sorted by expert; the group_sizes[e] rows of expert
// e multiply w[e] (K, N); products accumulate in float32 and the output
// (T, N) is x's dtype. Rows past the last group are written as zeros. The
// MoE feed-forward runs it three times per layer (gate, up, down).
//
// What bounds it on the H100: at decode (8 rows over up to 8 experts) and
// at prefill (1024 tokens over 16 experts of 5120 x 8192), the expert
// weights dominate the bytes and the work per weight byte is below the
// ~295 operations per byte where the bf16 tensor cores, not the 3.35 TB/s
// memory, set the limit: the bound is reading each used expert's weights
// once. grok-1's 256 rows per expert sit near that line.
//
// Ragged groups, against the TPU kernel: the Pallas wrapper scatters x
// into a copy padded so that each row tile holds one expert, and gathers
// the output back. Here nothing is copied: every block loads the group
// sizes (E <= 256) into shared memory, scans them into row and tile
// offsets, and finds its expert and row range itself; the ragged edge of
// each group is masked. The host never learns the group sizes. The grid is
// the static worst case, ceil(T / 64) + E row tiles by ceil(N / BN) column
// tiles (the Pallas bound Mp / bm); a tile past the last group zeroes its
// share of the rows no group covers, or returns. A block reads its (K, BN)
// slab of w[e] once for all its rows, so at decode each used expert's
// weights stream once. Weights are indexed with 64-bit offsets (grok-1's w
// per layer holds 1.6e9 elements).
//
// bfloat16 has two bodies, picked by shape by the wrapper, which passes
// the persistent body's geometry (blocks > 0) or none (0); the rule lives
// in kernels/moe_gmm.py forward_body and never changes body on a failed
// build or launch. moe_gmm_wgmma_kernel (below: persistent, warp-
// specialised, wgmma fed by TMA, 128-row tiles ordered by expert) runs
// where T is at least WGMMA_MIN_ROWS there; moe_gmm_mma_kernel runs at
// fewer rows (decode), where its grid of 64-row tiles keeps more of the
// weights in flight at once than one persistent block an SM does.
//
// moe_gmm_mma_kernel, on the tensor cores. A block tile is 64
// rows x 256 columns, split across its 4 warps by columns (64 x 64 each),
// so at decode, where a tile has 8 live rows, every warp has work and
// every warp streams its share of the weight slab; m16 row blocks with no
// live row are skipped (the ring is instantiated per count of live row
// blocks, so no branch sits inside it). x (64 x 32) and w (32 x 256) tiles
// stream through a 3-stage ring of shared memory filled by 16-byte
// cp.async, two stages in flight while one computes: at decode's 6 used
// experts x 32 column tiles, 192 blocks keep ~6 MB of weights in flight.
// Of the tile shapes timed on the card side by side (64 to 256 columns,
// 32 or 64 deep, 2 to 4 stages, 4 or 8 warps), none was faster at every
// shape of the MoE path than this one (PERF.md). Rows past the
// group's edge and K or N past theirs are zero-filled by cp.async's
// src-size operand, not branched around. A fragments of x come from
// ldmatrix.x4, B fragments of the row-major w (k by n, n contiguous) from
// ldmatrix.x4.trans; rows are padded by 16 bytes so ldmatrix is free of
// bank conflicts. mma.sync.m16n8k16 multiplies in bf16 and sums in
// float32 (each product exact, as the Pallas body's float32 upcast). The
// epilogue rounds to bf16 through shared memory and stores 16 bytes a
// thread.
//
// float32: moe_gmm_kernel<float>, float32 FMA on CUDA cores (exact, no
// TF32): a 64 x 64 tile, a (64, 32) x tile (transposed) and a (32, 64) w
// tile through shared memory with the next stage's 16-byte global loads in
// registers while the current one computes, each thread a 4 x 4 patch.
//
// Grids: the wgmma body, one block of 384 threads an SM, FwdLayout::BYTES
// (214 KB) of dynamic shared memory; the others (ceil(T / 64) + E,
// ceil(N / BN)): bf16 BN 256, 128 threads, 66 KB of dynamic shared memory,
// 2 blocks an SM (242 registers); float32 BN 64, 256 threads, 17 KB of
// static shared memory; both 3 KB more for the group offsets.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "moe_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using moe::BM;
using moe::MAX_E;
using moe::RowTile;
using moe::find_row_tile;
using moe::scan_groups;

// ---------------------------------------------------------------------
// float32: CUDA-core FMA
// ---------------------------------------------------------------------
constexpr int NT = 256;     // 16 x 16 threads, each owning a 4 x 4 output patch
constexpr int BN = 64;      // columns per tile
constexpr int BK = 32;      // depth per shared-memory stage

// 16 bytes of T, widened to float
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& raw, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ group_sizes, T* __restrict__ out, int T_rows, int K,
               int N, int E) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LV = BM * BK / (VEC * NT);  // 16-byte vectors per thread per tile
  static_assert(BM * BK == BK * BN, "x and w tiles hold as many elements");
  __shared__ long long s_rows[MAX_E];  // inclusive scan of (clamped) group sizes
  __shared__ int s_tiles[MAX_E];       // inclusive scan of row tiles per group
  __shared__ __align__(16) float As[BK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  scan_groups<NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const RowTile tile = find_row_tile(s_rows, s_tiles, T_rows, E, blockIdx.x);
  if (tile.e < 0) {
    // rows no group covers are zero, as ragged_dot leaves them
    for (int i = tid; i < BM * (BN / 4); i += NT) {
      const long long r = tile.row0 + i / (BN / 4);
      const int c = n0 + (i % (BN / 4)) * 4;
      if (r < T_rows && c < N) {
        const float z[4] = {0.f, 0.f, 0.f, 0.f};
        Vec<T>::store4(out + r * N + c, z);
      }
    }
    return;
  }
  const long long row0 = tile.row0;
  const int rows = tile.rows;
  if (rows <= 0) return;

  const T* we = w + (long long)tile.e * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  const bool live = (ty & ~1) * 4 < rows;  // uniform per warp: rows 8w..8w+7

  uint4 xr[LV], wr[LV];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v % BM, kx = (v / BM) * VEC;  // lanes walk rows
      xr[i] = (r < rows && k0 + kx < K)
                  ? *reinterpret_cast<const uint4*>(x + (row0 + r) * K + k0 + kx)
                  : make_uint4(0, 0, 0, 0);
      const int kr = v / (BN / VEC), nv = (v % (BN / VEC)) * VEC;
      wr[i] = (k0 + kr < K && n0 + nv < N)
                  ? *reinterpret_cast<const uint4*>(we + (long long)(k0 + kr) * N + n0 + nv)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      float f[VEC];
      Vec<T>::widen(xr[i], f);
      const int r = v % BM, kx = (v / BM) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) As[kx + j][r] = f[j];
      Vec<T>::widen(wr[i], f);
      const int kr = v / (BN / VEC), nv = (v % (BN / VEC)) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(&Bs[kr][nv + j]) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while this stage computes
    if (live) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int c = n0 + tx * 4;
  if (c >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) Vec<T>::store4(out + (row0 + r) * N + c, acc[i]);
  }
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async ring, ldmatrix
// ---------------------------------------------------------------------
constexpr int MMA_NT = 128;      // 4 warps, each 64 rows x WN columns
constexpr int MMA_BN = 256;      // columns per tile
constexpr int WN = MMA_BN / (MMA_NT / 32);   // columns per warp
constexpr int NJ = WN / 8;       // n8 blocks per warp
constexpr int MMA_BK = 32;       // depth per stage
constexpr int MMA_STAGES = 3;    // stages in the ring
constexpr int XLD = MMA_BK + 8;  // padded rows (elements): ldmatrix free of bank conflicts
constexpr int WLD = MMA_BN + 8;
constexpr int X_ELEMS = BM * XLD;       // one x stage
constexpr int W_ELEMS = MMA_BK * WLD;   // one w stage
constexpr size_t MMA_SMEM = sizeof(bf16) * MMA_STAGES * (X_ELEMS + W_ELEMS);
static_assert(BM * WLD <= MMA_STAGES * (X_ELEMS + W_ELEMS), "epilogue tile fits the ring");
static_assert((BM * MMA_BK / 8) % MMA_NT == 0 && (MMA_BK * MMA_BN / 8) % MMA_NT == 0 &&
                  NJ % 2 == 0,
              "whole 16-byte chunks per thread, n8 blocks in pairs");

// The ring over K for a tile whose first MI m16 row blocks hold rows of
// its group: acc[0..MI) += x tile @ w slab. load(kt, stage) issues stage
// kt's cp.async copies. Every fragment of a 16-deep step is loaded before
// its products, so the step's ldmatrix latencies overlap.
template <int MI, class Load>
__device__ __forceinline__ void mma_mainloop(float (&acc)[4][NJ][4], const bf16* Xs,
                                             const bf16* Ws, int n_k, int warp, int lane,
                                             const Load& load) {
#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < n_k) load(st, st);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<MMA_STAGES - 2>();   // stage kt has landed ...
    __syncthreads();   // ... for every thread, and stage kt - 1 is read out
    if (kt + MMA_STAGES - 1 < n_k) load(kt + MMA_STAGES - 1, (kt + MMA_STAGES - 1) % MMA_STAGES);
    mma::cp_async_commit();
    const bf16* xs = Xs + (kt % MMA_STAGES) * X_ELEMS;
    const bf16* ws = Ws + (kt % MMA_STAGES) * W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      // B fragments of this warp's WN columns: x4.trans = k +0..7 / +8..15
      // by n +0..7 / +8..15; A fragments of the live row blocks: x4 = rows
      // +0..7 / +8..15 by k +0..7 / +8..15
      uint32_t bw[NJ][2], a[MI][4];
#pragma unroll
      for (int nb = 0; nb < NJ / 2; ++nb) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD +
                                      warp * WN + nb * 16 + (lane >> 4) * 8);
        bw[2 * nb][0] = r[0]; bw[2 * nb][1] = r[1];
        bw[2 * nb + 1][0] = r[2]; bw[2 * nb + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma::ldmatrix_x4(a[mi], xs + (mi * 16 + (lane & 15)) * XLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma::mma_bf16(acc[mi][nj], a[mi], bw[nj][0], bw[nj][1]);
    }
  }
}

__global__ void __launch_bounds__(MMA_NT)
moe_gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ group_sizes, bf16* __restrict__ out, int T_rows,
                   int K, int N, int E) {
  constexpr int XC = MMA_BK / 8, WC = MMA_BN / 8;   // 16-byte chunks per row
  __shared__ long long s_rows[MAX_E];
  __shared__ int s_tiles[MAX_E];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BM][XLD]
  bf16* Ws = Xs + MMA_STAGES * X_ELEMS;            // [STAGES][BK][WLD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * MMA_BN;
  scan_groups<MMA_NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const RowTile tile = find_row_tile(s_rows, s_tiles, T_rows, E, blockIdx.x);
  if (tile.e < 0) {
    // rows no group covers are zero, as ragged_dot leaves them
    for (int i = tid; i < BM * WC; i += MMA_NT) {
      const long long r = tile.row0 + i / WC;
      const int c = n0 + (i % WC) * 8;
      if (r < T_rows && c < N) *reinterpret_cast<uint4*>(out + r * N + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int rows = tile.rows;
  if (rows <= 0) return;
  const bf16* xe = x + tile.row0 * K;
  const bf16* we = w + (long long)tile.e * K * N;

  // one stage: x rows past the group's edge, and K or N past theirs, are
  // zero-filled (src-size 0, the source clamped to a valid address)
  auto load = [&](int kt, int stage) {
    const int k0 = kt * MMA_BK;
    bf16* xs = Xs + stage * X_ELEMS;
    bf16* ws = Ws + stage * W_ELEMS;
#pragma unroll
    for (int i = 0; i < BM * XC / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, r = c / XC, kc = (c % XC) * 8;
      const bool ok = r < rows && k0 + kc < K;
      mma::cp_async16(xs + r * XLD + kc, ok ? xe + (long long)r * K + k0 + kc : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < MMA_BK * WC / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, kr = c / WC, nc = (c % WC) * 8;
      const bool ok = k0 + kr < K && n0 + nc < N;
      mma::cp_async16(ws + kr * WLD + nc, ok ? we + (long long)(k0 + kr) * N + n0 + nc : w,
                      ok ? 16 : 0);
    }
  };

  const int n_k = (K + MMA_BK - 1) / MMA_BK;
  const int live_m = (rows + 15) / 16;   // m16 row blocks holding a row of the group
  float acc[4][NJ][4];                   // [m16 block][n8 block][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  switch (live_m) {   // the m16 loop unrolled without a branch in the ring
    case 1: mma_mainloop<1>(acc, Xs, Ws, n_k, warp, lane, load); break;
    case 2: mma_mainloop<2>(acc, Xs, Ws, n_k, warp, lane, load); break;
    case 3: mma_mainloop<3>(acc, Xs, Ws, n_k, warp, lane, load); break;
    default: mma_mainloop<4>(acc, Xs, Ws, n_k, warp, lane, load); break;
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue tile

  // epilogue: round to bf16 into shared memory, then 16-byte row stores
  bf16* Os = Xs;   // [BM][WLD]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi < live_m) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int r = mi * 16 + g, c = warp * WN + nj * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(Os + r * WLD + c) =
            __floats2bfloat162_rn(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<__nv_bfloat162*>(Os + (r + 8) * WLD + c) =
            __floats2bfloat162_rn(acc[mi][nj][2], acc[mi][nj][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * WC; i += MMA_NT) {
    const int r = i / WC, c = (i % WC) * 8;
    if (r < rows && n0 + c < N)
      *reinterpret_cast<uint4*>(out + (tile.row0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(Os + r * WLD + c);
  }
}

// ---------------------------------------------------------------------
// bfloat16 on wgmma: persistent, warp-specialised, fed by TMA
// ---------------------------------------------------------------------
// One block an SM walks output tiles in a static order (tile = blockIdx.x
// + i * gridDim.x; moe::expert_tile): 128 rows of one expert x 256 columns,
// experts slowest, then column tiles, then the expert's row tiles, so the
// row tiles that read one (K, 256) slab of w[e] run side by side while it
// is in L2. Warpgroup 0 produces (setmaxnreg down to 24: warp 0's lane 0
// keeps TMA loads in flight into a ring of W_STAGES stages on mbarriers;
// warps 1-3 zero the rows no group covers), warpgroups 1 and 2 consume
// (240): wgmma.m64n256k16, each consumer 64 rows of the tile, one wgmma
// group in flight so a stage is released while the next one runs; a
// consumer whose 64 rows hold no row of the group only releases the
// stages. A = x's rows (K-major: K contiguous), B = w[e] as stored, (K, N)
// with N contiguous, read MN-major through the descriptor (4 boxes of 64
// columns), so w is never transposed or copied. TMA cannot stop at a
// group's edge: rows past it (the next group's, or past T, which load as
// zeros) are computed and not stored. w's map is (N, K, E), so a stage past
// K loads zeros from w[e] and never the next expert's rows. The rounded
// tile goes out through a padded shared-memory tile with 16-byte stores
// while the producer loads the next tile.
constexpr int WS_THREADS = 384;
constexpr int WS_CONSUMER_WARPS = 8;
constexpr int W_STAGES = 3;
constexpr int W_DEPTH = 64;    // reduction (of K) a stage
constexpr int W_COLS = 256;    // output columns (of N) a tile
constexpr int W_ROWS = 128;    // rows of one expert a tile

// Stages of x (128 rows x 64 of K) and w[e] (64 of K x 256 of N: 4 boxes),
// an epilogue tile a consumer (64 x 256, rows padded by 16 bytes), the
// scan, the barriers. kernels/moe_gmm.py fwd_smem_bytes mirrors these.
struct FwdLayout {
  static constexpr int A = 0, B = W_ROWS * W_DEPTH * 2;
  static constexpr int STAGE = B + W_DEPTH * W_COLS * 2;
  static constexpr int EPI_LD = W_COLS + 8, EPI = W_STAGES * STAGE;
  static constexpr int EPI_WG = 64 * EPI_LD * 2;
  static constexpr int SCAN = EPI + 2 * EPI_WG;
  static constexpr int BARS = SCAN + MAX_E * (8 + 4);
  static constexpr int BYTES = BARS + 2 * W_STAGES * 8 + 1024;
  static_assert(BYTES <= 232448 && STAGE % 1024 == 0 && B % 1024 == 0,
                "shared memory of a block");
};

__global__ void __launch_bounds__(WS_THREADS, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const int* __restrict__ group_sizes, bf16* __restrict__ out, int T_rows,
                     int K, int N, int E) {
  using L = FwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  long long* s_rows = reinterpret_cast<long long*>(sm + L::SCAN);
  int* s_tiles = reinterpret_cast<int*>(s_rows + MAX_E);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + W_STAGES;
  const int tid = threadIdx.x, wg = hop::warpgroup_idx(), warp = hop::warp_in_group();
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], WS_CONSUMER_WARPS);
    }
    hop::fence_bar_init();
  }
  scan_groups<WS_THREADS, W_ROWS>(group_sizes, T_rows, E, s_rows, s_tiles);
  const int n_ct = (N + W_COLS - 1) / W_COLS, n_k = (K + W_DEPTH - 1) / W_DEPTH;
  const int total = s_tiles[E - 1] * n_ct;
  const long long covered = min(s_rows[E - 1], (long long)T_rows);

  if (wg == 0) {
    hop::regs_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        int it = 0;
        for (int u = blockIdx.x; u < total; u += gridDim.x) {
          const moe::ExpertTile tl =
              moe::expert_tile<W_ROWS>(s_rows, s_tiles, T_rows, E, n_ct, u);
          if (tl.rows <= 0) continue;
          for (int kt = 0; kt < n_k; ++kt, ++it) {
            const int s = it % W_STAGES;
            hop::bar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
            unsigned char* st = sm + s * L::STAGE;
            hop::bar_arrive_tx(&full[s], L::STAGE);
            hop::tma_load_2d(st + L::A, &tm_x, &full[s], kt * W_DEPTH, (int)tl.row0);
            for (int j = 0; j < W_COLS / 64; ++j)
              hop::tma_load_3d(st + L::B + j * W_DEPTH * 128, &tm_w, &full[s],
                               tl.c * W_COLS + 64 * j, kt * W_DEPTH, tl.e);
          }
        }
      }
    } else {
      // warps 1-3: rows no group covers are zero, as ragged_dot leaves them
      const long long n16 = (T_rows - covered) * N / 8;
      uint4* z = reinterpret_cast<uint4*>(out + covered * N);
      for (long long i = (long long)blockIdx.x * 96 + tid - 32; i < n16;
           i += (long long)gridDim.x * 96)
        z[i] = make_uint4(0, 0, 0, 0);
    }
  } else {
    hop::regs_inc<240>();
    const int cw = wg - 1, g = lane >> 2, t = lane & 3, wtid = tid - 128 * wg;
    bf16* epi = reinterpret_cast<bf16*>(sm + L::EPI + cw * L::EPI_WG);
    int it = 0;
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      const moe::ExpertTile tl = moe::expert_tile<W_ROWS>(s_rows, s_tiles, T_rows, E, n_ct, u);
      if (tl.rows <= 0) continue;
      const int rows = tl.rows - 64 * cw;   // this consumer's rows of the group
      if (rows <= 0) {
        // no row of the group: release the tile's stages unread
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % W_STAGES;
          hop::bar_wait(&full[s], (it / W_STAGES) & 1);
          __syncwarp();
          if (lane == 0) hop::bar_arrive(&empty[s]);
        }
        continue;
      }
      float acc[W_COLS / 2];
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % W_STAGES;
        hop::bar_wait(&full[s], (it / W_STAGES) & 1);
        const unsigned char* st = sm + s * L::STAGE;
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < W_DEPTH / 16; ++kk)
          hop::mma_ss<0, 1>(acc, hop::desc(st + L::A + cw * 64 * 128 + kk * 32, 16, 1024),
                            hop::desc(st + L::B + kk * 2048, W_DEPTH * 128, 1024),
                            kt > 0 || kk > 0, hop::Tag<W_COLS>());
        hop::wg_commit();
        hop::wg_wait<1>();   // the previous stage's products are done
        if (kt > 0 && lane == 0) hop::bar_arrive(&empty[(it - 1) % W_STAGES]);
      }
      hop::wg_wait<0>();
      hop::fence_acc(acc);
      if (lane == 0) hop::bar_arrive(&empty[(it - 1) % W_STAGES]);

      // epilogue: round to bf16 through shared memory (the producer is
      // already loading the next tile), rows of the group only
      hop::named_sync(1 + cw, 128);   // the previous tile's reads are done
#pragma unroll
      for (int j = 0; j < W_COLS / 8; ++j) {
        const int r = warp * 16 + g, c = j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(epi + r * L::EPI_LD + c) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(epi + (r + 8) * L::EPI_LD + c) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hop::named_sync(1 + cw, 128);
      const int c0 = tl.c * W_COLS;
      const long long row0 = tl.row0 + 64 * cw;
      for (int i = wtid; i < 64 * (W_COLS / 8); i += 128) {
        const int r = i / (W_COLS / 8), c = (i % (W_COLS / 8)) * 8;
        if (r < rows && c0 + c < N)
          *reinterpret_cast<uint4*>(out + (row0 + r) * N + c0 + c) =
              *reinterpret_cast<const uint4*>(epi + r * L::EPI_LD + c);
      }
    }
  }
}

int launch_f32(const void* x, const void* w, const void* gs, void* out, int T_rows, int K, int N,
               int E, cudaStream_t stream) {
  const dim3 grid((unsigned)((T_rows + BM - 1) / BM + E), (unsigned)((N + BN - 1) / BN));
  moe_gmm_kernel<float><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const int*>(gs),
      static_cast<float*>(out), T_rows, K, N, E);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const void* gs, void* out, int T_rows, int K,
                int N, int E, int blocks, int smem, cudaStream_t stream) {
  if (blocks > 0) {
    if (smem != FwdLayout::BYTES) return -1;
    CUtensorMap mx, mw;
    const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)T_rows}, x_str[1] = {(uint64_t)K * 2};
    const uint32_t x_box[2] = {W_DEPTH, W_ROWS};
    const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
    const uint64_t w_str[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
    const uint32_t w_box[3] = {64, W_DEPTH, 1};
    if (hop::make_tmap(&mx, x, 2, x_dims, x_str, x_box) ||
        hop::make_tmap(&mw, w, 3, w_dims, w_str, w_box))
      return -2;
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdLayout::BYTES);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_wgmma_kernel<<<blocks, WS_THREADS, FwdLayout::BYTES, stream>>>(
        mx, mw, static_cast<const int*>(gs), static_cast<bf16*>(out), T_rows, K, N, E);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(moe_gmm_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T_rows + BM - 1) / BM + E),
                  (unsigned)((N + MMA_BN - 1) / MMA_BN));
  moe_gmm_mma_kernel<<<grid, MMA_NT, MMA_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(gs),
      static_cast<bf16*>(out), T_rows, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, K); w: (E, K, N); out: (T, N); all contiguous, 16-byte aligned,
// dtype 0 = float32, 1 = bfloat16; group_sizes: (E,) int32 on the device.
// K and N multiples of 8, 1 <= E <= 256, ceil(N / 64) <= 65535. blocks 0
// runs the grid body (bf16: mma.sync; float32: FMA); blocks > 0 (bf16
// only) the persistent wgmma body on that many blocks, with smem its
// dynamic shared memory bytes as the wrapper computed them (checked
// against this build's). Returns 0, a cudaError_t code, -1 for unsupported
// arguments, or -2 when a tensor map cannot be encoded.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* group_sizes, void* out,
                              int T_rows, int K, int N, int E, int dtype, int blocks, int smem,
                              void* stream) {
  if (E < 1 || E > MAX_E || K % 8 || N % 8 || blocks < 0) return -1;
  if (T_rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && blocks == 0) return launch_f32(x, w, group_sizes, out, T_rows, K, N, E, s);
  if (dtype == 1)
    return launch_bf16(x, w, group_sizes, out, T_rows, K, N, E, blocks, smem, s);
  return -1;
}
