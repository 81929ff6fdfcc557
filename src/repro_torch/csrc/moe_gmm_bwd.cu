// K4's backward: the gradients of the grouped (expert) matmul for Hopper
// (sm_90a), CUDA C++.
//
// The forward, out = ragged_dot(x, w, group_sizes) (csrc/moe_gmm.cu, the
// port of the Pallas _gmm_kernel, src/repro/kernels/moe_gmm.py:26), has
// no VJP on the TPU: the reference trains through its XLA path,
// jax.lax.ragged_dot (src/repro/kernels/ops.py:113-115), and XLA
// differentiates that. These kernels compute the same two gradients:
//
//   dX[r] = dY[r] . W[e(r)]^T    (T, K): each row of group e; rows that no
//                                group covers are written as zeros
//   dW[e] = X_e^T . dY_e         (E, K, N): over the rows of group e; an
//                                empty group's dW[e] is written as zeros
//
// products exact, sums in float32, each output rounded once to its dtype.
// One launcher call runs the dX kernel, the dW kernel or both (a null
// output pointer skips its kernel): two launches for both.
//
// What bounds them on the H100: at llama4-scout's training shapes (4096
// rows over 16 experts of 5120 x 8192) each gradient is 2 T K N = 344
// GFLOP against 1.3-1.5 GB that must move (the expert weights or their
// gradient once, the activations once): the bytes bound (0.43 ms at 3.35
// TB/s) and the operations bound (0.35 ms at 989 TFLOP/s) are near, so
// both the tensor-core rate and the streaming of w / dW matter.
//
// dX (moe_gmm_bwd_dx_*): the forward's row tiling and group scan
// (csrc/moe_common.cuh): a grid of ceil(T / 64) + E row tiles by column
// tiles of K, each block finding its expert and rows itself; a tile past
// the last group zeroes its rows. The reduction runs over N. W[e] is read
// in place, transposed by the operand layout and never copied: w is
// (K, N) with N contiguous, so a (256 of K) x (32 of N) slab is 256 rows
// of 64 contiguous bytes, which for this product is a column-major B
// operand: its fragments come from a plain ldmatrix where the forward's
// row-major slab needs ldmatrix.trans.
//
// dW (moe_gmm_bwd_dw_*): a grid of N tiles (fastest, so the blocks of one
// expert's K tile share its rows of x in L2) by E x K tiles; each block
// owns one (64 of K) x (BN of N) tile of one expert and reduces over that
// group's rows in steps of 32. X_e^T is read in place: a (32 rows) x (64
// of K) tile of x, K contiguous, gives the A fragments through
// ldmatrix.trans; dY_e's (32 rows) x (256 of N) tile is the same
// row-major B operand as the forward's w. The group's ragged edge is
// zero-filled through cp.async's src-size operand, not branched around; a
// block whose group is empty runs no step and stores its zero sums. Each
// output element is summed by one thread in one order: no atomics, so a
// backward repeats bit for bit.
//
// The group sizes stay on the card (every block scans them); the host
// never reads them, so a train step costs no sync and can be captured.
// Weights and their gradients are indexed with 64-bit offsets.
//
// bfloat16: mma.sync.m16n8k16 (bf16 products, float32 sums), 4 warps a
// block, 64 x 256 tiles (each warp 64 x 64), a 3-stage cp.async ring,
// ldmatrix from rows padded by 16 bytes (free of bank conflicts), the
// epilogue rounding to bf16 through shared memory and storing 16 bytes a
// thread. dX: 75 KB of dynamic shared memory; dW: 63 KB.
// float32: exact FMA on the CUDA cores (no TF32): 64 x 64 tiles, 256
// threads each a 4 x 4 patch, a 32-deep stage through shared memory with
// the next stage's 16-byte loads in registers while this one computes.
//
// Next: wgmma fed by TMA, and dX and dW in one persistent launch ordered
// by expert so that an expert's rows are read once for both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "moe_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using moe::BM;
using moe::MAX_E;
using moe::RowTile;
using moe::find_row_tile;
using moe::scan_groups;

// The rows [start, start + count) of group e, from the scanned sizes (count
// 0 for an empty group, or one that starts at or past T).
struct Group {
  long long start;
  int count;
};

__device__ Group group_rows(const long long* s_rows, int T_rows, int e) {
  const long long start = e ? s_rows[e - 1] : 0;
  const long long end = min(s_rows[e], (long long)T_rows);
  return {start, (int)max(end - start, 0LL)};
}

// ---------------------------------------------------------------------
// float32: CUDA-core FMA
// ---------------------------------------------------------------------
constexpr int NT = 256;   // 16 x 16 threads, each a 4 x 4 output patch
constexpr int BN = 64;    // output columns per tile (and dW's K rows)
constexpr int BK = 32;    // reduction depth per shared-memory stage
constexpr int LV = BM * BK / (4 * NT);   // 16-byte vectors a thread per tile operand
static_assert(LV * 4 * NT == BM * BK && BM == BN, "whole float4s per thread");

__device__ __forceinline__ float4 ld4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// 4 x 4 patch of acc += As[kk][ty*4 ..] x Bs[kk][tx*4 ..] over one stage
__device__ __forceinline__ void fma_stage(float (&acc)[4][4], const float (*As)[BM + 4],
                                          const float (*Bs)[BN + 4], int tx, int ty) {
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

// dX = dY W[e]^T: grid (ceil(T / 64) + E, ceil(K / 64)). Both operands
// are read along their contiguous N and stored transposed: As[n][row],
// Bs[n][k].
__global__ void __launch_bounds__(NT)
moe_gmm_bwd_dx_kernel(const float* __restrict__ dout, const float* __restrict__ w,
                      const int* __restrict__ group_sizes, float* __restrict__ dx, int T_rows,
                      int K, int N, int E) {
  __shared__ long long s_rows[MAX_E];
  __shared__ int s_tiles[MAX_E];
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * BN;
  scan_groups<NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const RowTile tile = find_row_tile(s_rows, s_tiles, T_rows, E, blockIdx.x);
  if (tile.e < 0) {
    // rows no group covers are zero, as ragged_dot's gradient leaves them
    for (int i = tid; i < BM * (BN / 4); i += NT) {
      const long long r = tile.row0 + i / (BN / 4);
      const int c = c0 + (i % (BN / 4)) * 4;
      if (r < T_rows && c < K)
        *reinterpret_cast<float4*>(dx + r * K + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const long long row0 = tile.row0;
  const int rows = tile.rows;
  if (rows <= 0) return;
  const float* we = w + (long long)tile.e * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  const bool live = (ty & ~1) * 4 < rows;   // uniform per warp: rows 8w..8w+7

  float4 dr[LV], wr[LV];
  auto load = [&](int n0) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v % BM, nx = (v / BM) * 4;   // lanes walk rows
      const bool n_ok = n0 + nx < N;
      dr[i] = ld4(dout + (row0 + r) * N + n0 + nx, r < rows && n_ok);
      wr[i] = ld4(we + (long long)(c0 + r) * N + n0 + nx, c0 + r < K && n_ok);
    }
  };

  float acc[4][4] = {};
  load(0);
  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v % BM, nx = (v / BM) * 4;
      const float d[4] = {dr[i].x, dr[i].y, dr[i].z, dr[i].w};
      const float g[4] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        As[nx + j][r] = d[j];
        Bs[nx + j][r] = g[j];
      }
    }
    __syncthreads();
    if (n0 + BK < N) load(n0 + BK);   // in flight while this stage computes
    if (live) fma_stage(acc, As, Bs, tx, ty);
    __syncthreads();
  }

  const int c = c0 + tx * 4;
  if (c >= K) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows)
      *reinterpret_cast<float4*>(dx + (row0 + r) * K + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// dW[e] = X_e^T dY_e: grid (ceil(N / 64), E * k_tiles). Both operands are
// read along their contiguous dimension into row-major stages: As[row][k],
// Bs[row][n].
__global__ void __launch_bounds__(NT)
moe_gmm_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                      const int* __restrict__ group_sizes, float* __restrict__ dw, int T_rows,
                      int K, int N, int E, int k_tiles) {
  __shared__ long long s_rows[MAX_E];
  __shared__ int s_tiles[MAX_E];
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int e = blockIdx.y / k_tiles;
  const int k0 = (blockIdx.y % k_tiles) * BM;
  const int n0 = blockIdx.x * BN;
  scan_groups<NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const Group grp = group_rows(s_rows, T_rows, e);
  const float* xe = x + grp.start * K;
  const float* de = dout + grp.start * N;
  const int tx = tid & 15, ty = tid >> 4;

  float4 xr[LV], dr[LV];
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BM / 4), cx = (v % (BM / 4)) * 4;   // lanes walk columns
      const bool r_ok = r0 + r < grp.count;
      xr[i] = ld4(xe + (long long)(r0 + r) * K + k0 + cx, r_ok && k0 + cx < K);
      dr[i] = ld4(de + (long long)(r0 + r) * N + n0 + cx, r_ok && n0 + cx < N);
    }
  };

  float acc[4][4] = {};
  if (grp.count > 0) load(0);
  for (int r0 = 0; r0 < grp.count; r0 += BK) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BM / 4), cx = (v % (BM / 4)) * 4;
      *reinterpret_cast<float4*>(&As[r][cx]) = xr[i];
      *reinterpret_cast<float4*>(&Bs[r][cx]) = dr[i];
    }
    __syncthreads();
    if (r0 + BK < grp.count) load(r0 + BK);
    fma_stage(acc, As, Bs, tx, ty);
    __syncthreads();
  }

  // an empty group stores its zero sums
  const int n = n0 + tx * 4;
  if (n >= N) return;
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k < K)
      *reinterpret_cast<float4*>(dwe + (long long)k * N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async ring, ldmatrix
// ---------------------------------------------------------------------
constexpr int MMA_NT = 128;                  // 4 warps
constexpr int MMA_BN = 256;                  // output columns per tile
constexpr int WN = MMA_BN / (MMA_NT / 32);   // columns per warp
constexpr int NJ = WN / 8;                   // n8 blocks per warp
constexpr int MMA_BK = 32;                   // reduction depth per stage
constexpr int STAGES = 3;
constexpr int PAD = 8;                       // 16 bytes a row: ldmatrix free of bank conflicts
// dX stages: dY (64 rows x 32 of N) and W[e] (256 of K x 32 of N)
constexpr int DX_LD = MMA_BK + PAD;
constexpr int DX_D_ELEMS = BM * DX_LD;
constexpr int DX_W_ELEMS = MMA_BN * DX_LD;
constexpr size_t DX_SMEM = sizeof(bf16) * STAGES * (DX_D_ELEMS + DX_W_ELEMS);
// dW stages: x (32 rows x 64 of K) and dY (32 rows x 256 of N)
constexpr int DW_XLD = BM + PAD;
constexpr int DW_DLD = MMA_BN + PAD;
constexpr int DW_X_ELEMS = MMA_BK * DW_XLD;
constexpr int DW_D_ELEMS = MMA_BK * DW_DLD;
constexpr size_t DW_SMEM = sizeof(bf16) * STAGES * (DW_X_ELEMS + DW_D_ELEMS);
// the epilogue's 64 x 256 tile reuses the ring
constexpr int OUT_LD = MMA_BN + PAD;
static_assert(BM * OUT_LD <= STAGES * (DX_D_ELEMS + DX_W_ELEMS) &&
                  BM * OUT_LD <= STAGES * (DW_X_ELEMS + DW_D_ELEMS),
              "epilogue tile fits the ring");
static_assert(NJ % 2 == 0 && (BM * MMA_BK / 8) % MMA_NT == 0 &&
                  (MMA_BN * MMA_BK / 8) % MMA_NT == 0,
              "n8 blocks in pairs, whole 16-byte chunks per thread");

// The ring over the reduction: load(kt, stage) issues stage kt's cp.async
// copies, step(stage) runs the products of a landed stage.
template <class Load, class Step>
__device__ __forceinline__ void ring(int n_k, const Load& load, const Step& step) {
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k) load(st, st);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<STAGES - 2>();   // stage kt has landed ...
    __syncthreads();   // ... for every thread, and stage kt - 1 is read out
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    mma::cp_async_commit();
    step(kt % STAGES);
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue tile
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][NJ][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
}

// Round the first live_m m16 blocks of acc to bf16 into Os [BM][OUT_LD]
// (this warp's WN columns), then make the tile visible to the block.
__device__ __forceinline__ void stage_out(bf16* Os, const float (&acc)[4][NJ][4], int live_m,
                                          int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi < live_m) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int r = mi * 16 + g, c = warp * WN + nj * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(Os + r * OUT_LD + c) =
            __floats2bfloat162_rn(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<__nv_bfloat162*>(Os + (r + 8) * OUT_LD + c) =
            __floats2bfloat162_rn(acc[mi][nj][2], acc[mi][nj][3]);
      }
    }
  }
  __syncthreads();
}

// dX's products of one landed stage for a tile whose first MI m16 blocks
// hold rows: A = dY (rows x 32 of N, row-major: ldmatrix.x4), B = W[e]'s
// slab (256 of K x 32 of N: for this product column-major, so a plain
// ldmatrix.x4 gives b0 / b1 of two n8 blocks: matrices rows +0..7 by n
// +0..7 / +8..15, then rows +8..15 by the same).
template <int MI>
__device__ __forceinline__ void dx_step(float (&acc)[4][NJ][4], const bf16* ds, const bf16* ws,
                                        int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < MMA_BK / 16; ++kk) {
    uint32_t bw[NJ][2], a[MI][4];
#pragma unroll
    for (int nb = 0; nb < NJ / 2; ++nb) {
      uint32_t r[4];
      mma::ldmatrix_x4(r, ws + (warp * WN + nb * 16 + (lane & 7) + (lane >> 4) * 8) * DX_LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      bw[2 * nb][0] = r[0]; bw[2 * nb][1] = r[1];
      bw[2 * nb + 1][0] = r[2]; bw[2 * nb + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      mma::ldmatrix_x4(a[mi], ds + (mi * 16 + (lane & 15)) * DX_LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) mma::mma_bf16(acc[mi][nj], a[mi], bw[nj][0], bw[nj][1]);
  }
}

template <int MI, class Load>
__device__ __forceinline__ void dx_mainloop(float (&acc)[4][NJ][4], const bf16* Ds,
                                            const bf16* Ws, int n_k, int warp, int lane,
                                            const Load& load) {
  ring(n_k, load, [&](int stage) {
    dx_step<MI>(acc, Ds + stage * DX_D_ELEMS, Ws + stage * DX_W_ELEMS, warp, lane);
  });
}

// dX = dY W[e]^T: grid (ceil(T / 64) + E, ceil(K / 256)).
__global__ void __launch_bounds__(MMA_NT)
moe_gmm_bwd_dx_mma_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ w,
                          const int* __restrict__ group_sizes, bf16* __restrict__ dx,
                          int T_rows, int K, int N, int E) {
  constexpr int CH = MMA_BK / 8;   // 16-byte chunks a row of a stage
  __shared__ long long s_rows[MAX_E];
  __shared__ int s_tiles[MAX_E];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ds = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BM][DX_LD]
  bf16* Ws = Ds + STAGES * DX_D_ELEMS;              // [STAGES][MMA_BN][DX_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * MMA_BN;
  constexpr int OC = MMA_BN / 8;   // 16-byte chunks a row of the output tile
  scan_groups<MMA_NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const RowTile tile = find_row_tile(s_rows, s_tiles, T_rows, E, blockIdx.x);
  if (tile.e < 0) {
    // rows no group covers are zero, as ragged_dot's gradient leaves them
    for (int i = tid; i < BM * OC; i += MMA_NT) {
      const long long r = tile.row0 + i / OC;
      const int c = c0 + (i % OC) * 8;
      if (r < T_rows && c < K) *reinterpret_cast<uint4*>(dx + r * K + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int rows = tile.rows;
  if (rows <= 0) return;
  const bf16* de = dout + tile.row0 * N;
  const bf16* we = w + (long long)tile.e * K * N;

  // one stage: dY rows past the group's edge, and K or N past theirs, are
  // zero-filled (src-size 0, the source clamped to a valid address)
  auto load = [&](int kt, int stage) {
    const int n0 = kt * MMA_BK;
    bf16* ds = Ds + stage * DX_D_ELEMS;
    bf16* ws = Ws + stage * DX_W_ELEMS;
#pragma unroll
    for (int i = 0; i < BM * CH / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, r = c / CH, nc = (c % CH) * 8;
      const bool ok = r < rows && n0 + nc < N;
      mma::cp_async16(ds + r * DX_LD + nc, ok ? de + (long long)r * N + n0 + nc : dout,
                      ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < MMA_BN * CH / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, kr = c / CH, nc = (c % CH) * 8;
      const bool ok = c0 + kr < K && n0 + nc < N;
      mma::cp_async16(ws + kr * DX_LD + nc, ok ? we + (long long)(c0 + kr) * N + n0 + nc : w,
                      ok ? 16 : 0);
    }
  };

  const int n_k = (N + MMA_BK - 1) / MMA_BK;
  const int live_m = (rows + 15) / 16;   // m16 row blocks holding a row of the group
  float acc[4][NJ][4];                   // [m16 block][n8 block][fragment]
  zero_acc(acc);
  switch (live_m) {   // the m16 loop unrolled without a branch in the ring
    case 1: dx_mainloop<1>(acc, Ds, Ws, n_k, warp, lane, load); break;
    case 2: dx_mainloop<2>(acc, Ds, Ws, n_k, warp, lane, load); break;
    case 3: dx_mainloop<3>(acc, Ds, Ws, n_k, warp, lane, load); break;
    default: dx_mainloop<4>(acc, Ds, Ws, n_k, warp, lane, load); break;
  }

  bf16* Os = Ds;   // [BM][OUT_LD]
  stage_out(Os, acc, live_m, warp, lane);
  for (int i = tid; i < BM * OC; i += MMA_NT) {
    const int r = i / OC, c = (i % OC) * 8;
    if (r < rows && c0 + c < K)
      *reinterpret_cast<uint4*>(dx + (tile.row0 + r) * K + c0 + c) =
          *reinterpret_cast<const uint4*>(Os + r * OUT_LD + c);
  }
}

// dW's products of one landed stage (32 rows): A = X_e^T (64 of K x
// rows), from the stage x (rows x 64 of K, K contiguous) by ldmatrix.x4
// .trans: matrices rows +0..7 / +0..7 / +8..15 / +8..15 of the stage by
// K +0..7 / +8..15 / +0..7 / +8..15, giving a0..a3; B = dY_e (rows x 256
// of N, row-major), by ldmatrix.x4.trans as the forward's w.
__device__ __forceinline__ void dw_step(float (&acc)[4][NJ][4], const bf16* xs, const bf16* ds,
                                        int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < MMA_BK / 16; ++kk) {
    uint32_t bw[NJ][2], a[4][4];
#pragma unroll
    for (int nb = 0; nb < NJ / 2; ++nb) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, ds + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DW_DLD +
                                    warp * WN + nb * 16 + (lane >> 4) * 8);
      bw[2 * nb][0] = r[0]; bw[2 * nb][1] = r[1];
      bw[2 * nb + 1][0] = r[2]; bw[2 * nb + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      mma::ldmatrix_x4_trans(a[mi], xs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * DW_XLD +
                                        mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) mma::mma_bf16(acc[mi][nj], a[mi], bw[nj][0], bw[nj][1]);
  }
}

// dW[e] = X_e^T dY_e: grid (ceil(N / 256), E * k_tiles), one (64 of K) x
// (256 of N) tile of one expert a block.
__global__ void __launch_bounds__(MMA_NT)
moe_gmm_bwd_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                          const int* __restrict__ group_sizes, bf16* __restrict__ dw,
                          int T_rows, int K, int N, int E, int k_tiles) {
  constexpr int XC = BM / 8, DC = MMA_BN / 8;   // 16-byte chunks a row
  __shared__ long long s_rows[MAX_E];
  __shared__ int s_tiles[MAX_E];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][MMA_BK][DW_XLD]
  bf16* Ds = Xs + STAGES * DW_X_ELEMS;             // [STAGES][MMA_BK][DW_DLD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = blockIdx.y / k_tiles;
  const int k0 = (blockIdx.y % k_tiles) * BM;
  const int n0 = blockIdx.x * MMA_BN;
  scan_groups<MMA_NT>(group_sizes, T_rows, E, s_rows, s_tiles);
  const Group grp = group_rows(s_rows, T_rows, e);
  const bf16* xe = x + grp.start * K;
  const bf16* de = dout + grp.start * N;

  // one stage of 32 rows: rows past the group's edge, and K or N past
  // theirs, are zero-filled (src-size 0, the source clamped to a valid
  // address)
  auto load = [&](int kt, int stage) {
    const int r0 = kt * MMA_BK;
    bf16* xs = Xs + stage * DW_X_ELEMS;
    bf16* ds = Ds + stage * DW_D_ELEMS;
#pragma unroll
    for (int i = 0; i < MMA_BK * XC / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, r = c / XC, kc = (c % XC) * 8;
      const bool ok = r0 + r < grp.count && k0 + kc < K;
      mma::cp_async16(xs + r * DW_XLD + kc, ok ? xe + (long long)(r0 + r) * K + k0 + kc : x,
                      ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < MMA_BK * DC / MMA_NT; ++i) {
      const int c = tid + i * MMA_NT, r = c / DC, nc = (c % DC) * 8;
      const bool ok = r0 + r < grp.count && n0 + nc < N;
      mma::cp_async16(ds + r * DW_DLD + nc, ok ? de + (long long)(r0 + r) * N + n0 + nc : dout,
                      ok ? 16 : 0);
    }
  };

  float acc[4][NJ][4];
  zero_acc(acc);
  // an empty group runs no step: its tile stores the zero sums
  ring((grp.count + MMA_BK - 1) / MMA_BK, load, [&](int stage) {
    dw_step(acc, Xs + stage * DW_X_ELEMS, Ds + stage * DW_D_ELEMS, warp, lane);
  });

  bf16* Os = Xs;   // [BM][OUT_LD]
  stage_out(Os, acc, 4, warp, lane);
  bf16* dwe = dw + (long long)e * K * N;
  for (int i = tid; i < BM * DC; i += MMA_NT) {
    const int r = i / DC, c = (i % DC) * 8;
    if (k0 + r < K && n0 + c < N)
      *reinterpret_cast<uint4*>(dwe + (long long)(k0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(Os + r * OUT_LD + c);
  }
}

int launch_f32(const void* x, const void* w, const void* gs, const void* dout, void* dx,
               void* dw, int T_rows, int K, int N, int E, cudaStream_t stream) {
  const int k_tiles = (K + BM - 1) / BM;
  if (dx && T_rows > 0) {
    const dim3 grid((unsigned)((T_rows + BM - 1) / BM + E), (unsigned)((K + BN - 1) / BN));
    moe_gmm_bwd_dx_kernel<<<grid, NT, 0, stream>>>(
        static_cast<const float*>(dout), static_cast<const float*>(w),
        static_cast<const int*>(gs), static_cast<float*>(dx), T_rows, K, N, E);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dw) {
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)(E * k_tiles));
    moe_gmm_bwd_dw_kernel<<<grid, NT, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dout),
        static_cast<const int*>(gs), static_cast<float*>(dw), T_rows, K, N, E, k_tiles);
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const void* gs, const void* dout, void* dx,
                void* dw, int T_rows, int K, int N, int E, cudaStream_t stream) {
  const int k_tiles = (K + BM - 1) / BM;
  if (dx && T_rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(moe_gmm_bwd_dx_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DX_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((T_rows + BM - 1) / BM + E),
                    (unsigned)((K + MMA_BN - 1) / MMA_BN));
    moe_gmm_bwd_dx_mma_kernel<<<grid, MMA_NT, DX_SMEM, stream>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(w),
        static_cast<const int*>(gs), static_cast<bf16*>(dx), T_rows, K, N, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dw) {
    cudaError_t err = cudaFuncSetAttribute(moe_gmm_bwd_dw_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DW_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((N + MMA_BN - 1) / MMA_BN), (unsigned)(E * k_tiles));
    moe_gmm_bwd_dw_mma_kernel<<<grid, MMA_NT, DW_SMEM, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dout),
        static_cast<const int*>(gs), static_cast<bf16*>(dw), T_rows, K, N, E, k_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, K); w: (E, K, N); dout: (T, N); dx: (T, K) or null (not computed);
// dw: (E, K, N) or null; all contiguous, 16-byte aligned, one dtype, 0 =
// float32, 1 = bfloat16; group_sizes: (E,) int32 on the device. K and N
// multiples of 8, 1 <= E <= 256, E * ceil(K / 64) <= 65535. Returns 0, a
// cudaError_t code, or -1 for unsupported arguments.
extern "C" int moe_gmm_bwd_launch(const void* x, const void* w, const void* group_sizes,
                                  const void* dout, void* dx, void* dw, int T_rows, int K,
                                  int N, int E, int dtype, void* stream) {
  if (E < 1 || E > MAX_E || K % 8 || N % 8 || T_rows < 0) return -1;
  if ((long long)E * ((K + BM - 1) / BM) > 65535) return -1;
  if (K <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, group_sizes, dout, dx, dw, T_rows, K, N, E, s);
  if (dtype == 1) return launch_bf16(x, w, group_sizes, dout, dx, dw, T_rows, K, N, E, s);
  return -1;
}
