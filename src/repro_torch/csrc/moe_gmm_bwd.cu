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
// The group sizes stay on the card (every block scans them,
// csrc/moe_common.cuh); the host never reads them, so a train step costs
// no sync and can be captured. Weights and their gradients are indexed
// with 64-bit offsets. Each output element is summed by one thread in one
// order: no atomics, so a backward repeats bit for bit.
//
// bfloat16 (moe_gmm_bwd_{dx,dw}_wgmma_kernel): one persistent block an SM
// walks output tiles in a static order (below), three warpgroups: a
// producer whose one thread keeps TMA loads in flight into a 3-stage ring
// on mbarriers (24 registers after setmaxnreg), two consumers (240)
// running wgmma.m64n256k16 on 64 rows each, one wgmma group in flight so
// that a stage is released while the next one runs. Operands are boxes of
// rows x 64 bf16 in the 128-byte swizzle. dX: A = dY's rows (K-major), B =
// W[e] as stored, (K, N) with N contiguous, K-major for this product, so W
// is never transposed or copied; a tile is 128 rows of one expert x 256 of
// K, ordered expert, column tile, row tile, so the row tiles that read one
// slab of W[e] run side by side; rows past the group are computed and not
// stored; the rounded tile goes out through a padded shared-memory tile
// with 16-byte stores, while the producer loads the next tile; the
// producer's other warps zero the rows no group covers. dW: A = X_e^T and
// B = dY_e, both MN-major through the descriptor, a tile 128 of K x 256 of
// N; TMA cannot stop at a group's edge, so the rows past it are zeroed in
// the stage of the group's last step before its products; the tile goes
// out by TMA stores from 4 swizzled boxes, which clip at K's and N's
// edges, overlapped with the next tile's loads; an empty group stores
// zeros. Registers and dynamic shared memory (ptxas and cuobjdump,
// sm_90a): 168 a thread at launch, the consumers using up to 178 (dX) and
// 162 (dW); 219184 and 217136 bytes; no spill.
//
// float32 (moe_gmm_bwd_{dx,dw}_kernel): exact FMA on the CUDA cores (no
// TF32): 64 x 64 tiles, 256 threads each a 4 x 4 patch, a 32-deep stage
// through shared memory with the next stage's 16-byte loads in registers
// while this one computes. dX: the forward's row tiling, a grid of
// ceil(T / 64) + E row tiles by column tiles of K, each block finding its
// expert and rows itself; a tile past the last group zeroes its rows; the
// reduction runs over N. dW: a grid of N tiles (fastest, so the blocks of
// one expert's K tile share its rows of x in L2) by E x K tiles; each block
// reduces over its group's rows, the ragged edge loaded as zeros; a block
// whose group is empty stores its zero sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
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
// bfloat16 on wgmma: persistent, warp-specialised, fed by TMA
// ---------------------------------------------------------------------
// One block an SM walks output tiles in a static order (tile = blockIdx.x
// + i * gridDim.x), so each output element has one owner and one summation
// order: no atomics, a backward repeats bit for bit. Warpgroup 0 produces
// (warp 0's lane 0 issues the TMA loads into a ring of W_STAGES stages on
// mbarriers; 24 registers a thread), warpgroups 1 and 2 consume (240
// registers): wgmma m64n256k16, each consumer 64 rows of the tile, one
// wgmma group kept in flight so a stage is released while the next runs.
// The schedule comes from the group sizes scanned on the card
// (moe_common.cuh); the host reads nothing. Operand stages are boxes of
// rows x 64 bf16 in the 128-byte swizzle (hopper_common.cuh).
constexpr int WS_THREADS = 384;
constexpr int WS_CONSUMER_WARPS = 8;
constexpr int W_STAGES = 3;
constexpr int W_DEPTH = 64;    // reduction a stage
constexpr int W_COLS = 256;    // output columns a tile (dX: of K, dW: of N)
constexpr int DX_ROWS = 128;   // dX: rows of one expert a tile
constexpr int DW_KROWS = 128;  // dW: rows of K a tile

// dX: stages of dY (128 rows x 64 of N) and W[e] (256 of K x 64 of N), an
// epilogue tile a consumer (64 x 256, rows padded by 16 bytes), the scan,
// the barriers. kernels/moe_gmm.py wgmma_smem_bytes mirrors these bytes.
struct DxLayout {
  static constexpr int A = 0, B = DX_ROWS * W_DEPTH * 2;
  static constexpr int STAGE = B + W_COLS * W_DEPTH * 2;
  static constexpr int EPI_LD = W_COLS + 8, EPI = W_STAGES * STAGE;
  static constexpr int EPI_WG = 64 * EPI_LD * 2;
  static constexpr int SCAN = EPI + 2 * EPI_WG;
  static constexpr int BARS = SCAN + MAX_E * (8 + 4);
  static constexpr int BYTES = BARS + 2 * W_STAGES * 8 + 1024;
  static_assert(BYTES <= 232448 && STAGE % 1024 == 0, "shared memory of a block");
};
// dW: stages of x (64 rows x 128 of K: 2 boxes) and dY (64 rows x 256 of
// N: 4 boxes), an epilogue tile a consumer (64 of K x 256 of N as 4
// swizzled boxes, stored by TMA), the scan, the barriers
struct DwLayout {
  static constexpr int X = 0, D = W_DEPTH * DW_KROWS * 2;
  static constexpr int STAGE = D + W_DEPTH * W_COLS * 2;
  static constexpr int EPI = W_STAGES * STAGE, EPI_WG = 64 * W_COLS * 2;
  static constexpr int SCAN = EPI + 2 * EPI_WG;
  static constexpr int BARS = SCAN + MAX_E * (8 + 4);
  static constexpr int BYTES = BARS + 2 * W_STAGES * 8 + 1024;
  static_assert(BYTES <= 232448 && STAGE % 1024 == 0, "shared memory of a block");
};

// dX = dY W[e]^T: A = dY's rows (K-major: N contiguous), B = W[e] as
// stored, (K, N) with N contiguous, K-major for this product.
__global__ void __launch_bounds__(WS_THREADS, 1)
moe_gmm_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy,
                            const __grid_constant__ CUtensorMap tm_w,
                            const int* __restrict__ group_sizes, bf16* __restrict__ dx,
                            int T_rows, int K, int N, int E) {
  using L = DxLayout;
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
  moe::scan_groups<WS_THREADS, DX_ROWS>(group_sizes, T_rows, E, s_rows, s_tiles);
  const int n_ct = (K + W_COLS - 1) / W_COLS, n_k = (N + W_DEPTH - 1) / W_DEPTH;
  const int total = s_tiles[E - 1] * n_ct;
  const long long covered = min(s_rows[E - 1], (long long)T_rows);

  if (wg == 0) {
    hop::regs_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        int it = 0;
        for (int u = blockIdx.x; u < total; u += gridDim.x) {
          const moe::ExpertTile tl =
              moe::expert_tile<DX_ROWS>(s_rows, s_tiles, T_rows, E, n_ct, u);
          if (tl.rows <= 0) continue;
          for (int n = 0; n < n_k; ++n, ++it) {
            const int s = it % W_STAGES;
            hop::bar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
            unsigned char* st = sm + s * L::STAGE;
            hop::bar_arrive_tx(&full[s], L::STAGE);
            hop::tma_load_2d(st + L::A, &tm_dy, &full[s], n * W_DEPTH, (int)tl.row0);
            hop::tma_load_2d(st + L::B, &tm_w, &full[s], n * W_DEPTH,
                             tl.e * K + tl.c * W_COLS);
          }
        }
      }
    } else {
      // warps 1-3: rows no group covers are zero, as ragged_dot's gradient
      // leaves them
      const long long n16 = (T_rows - covered) * K / 8;
      uint4* z = reinterpret_cast<uint4*>(dx + covered * K);
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
      const moe::ExpertTile tl =
          moe::expert_tile<DX_ROWS>(s_rows, s_tiles, T_rows, E, n_ct, u);
      if (tl.rows <= 0) continue;
      float acc[W_COLS / 2];
      for (int n = 0; n < n_k; ++n, ++it) {
        const int s = it % W_STAGES;
        hop::bar_wait(&full[s], (it / W_STAGES) & 1);
        const unsigned char* st = sm + s * L::STAGE;
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < W_DEPTH / 16; ++kk)
          hop::mma_ss<0, 0>(acc, hop::desc(st + L::A + cw * 64 * 128 + kk * 32, 16, 1024),
                            hop::desc(st + L::B + kk * 32, 16, 1024), n > 0 || kk > 0,
                            hop::Tag<W_COLS>());
        hop::wg_commit();
        hop::wg_wait<1>();   // the previous stage's products are done
        if (n > 0 && lane == 0) hop::bar_arrive(&empty[(it - 1) % W_STAGES]);
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
      const int rows = tl.rows - 64 * cw, c0 = tl.c * W_COLS;
      const long long row0 = tl.row0 + 64 * cw;
      for (int i = wtid; i < 64 * (W_COLS / 8); i += 128) {
        const int r = i / (W_COLS / 8), c = (i % (W_COLS / 8)) * 8;
        if (r < rows && c0 + c < K)
          *reinterpret_cast<uint4*>(dx + (row0 + r) * K + c0 + c) =
              *reinterpret_cast<const uint4*>(epi + r * L::EPI_LD + c);
      }
    }
  }
}

// dW[e] = X_e^T dY_e: A = X_e^T, MN-major (x's K contiguous), B = dY_e,
// MN-major (N contiguous). TMA cannot stop at a group's edge: in a group's
// last step the rows past it (the next group's, or past T, which load as
// zeros) are zeroed in the stage before its products. The tile goes out
// through shared memory by TMA stores, which clip at K's and N's edges.
__global__ void __launch_bounds__(WS_THREADS, 1)
moe_gmm_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_dy,
                            const __grid_constant__ CUtensorMap tm_dw,
                            const int* __restrict__ group_sizes, int T_rows, int K, int N,
                            int E) {
  using L = DwLayout;
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
  moe::scan_groups<WS_THREADS>(group_sizes, T_rows, E, s_rows, s_tiles);
  const int n_kt = (K + DW_KROWS - 1) / DW_KROWS, n_nt = (N + W_COLS - 1) / W_COLS;
  const int total = E * n_kt * n_nt;
  // tile u: expert u / (n_kt n_nt), then K tiles, then N tiles
  auto group = [&](int e, long long& start) {
    start = e ? s_rows[e - 1] : 0;
    return (int)max(min(s_rows[e], (long long)T_rows) - start, 0LL);
  };

  if (wg == 0) {
    hop::regs_dec<24>();
    if (warp == 0 && lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        const int e = u / (n_kt * n_nt), kt = u / n_nt % n_kt, nt = u % n_nt;
        long long start;
        const int count = group(e, start);
        for (int r = 0; r < count; r += W_DEPTH, ++it) {
          const int s = it % W_STAGES;
          hop::bar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
          unsigned char* st = sm + s * L::STAGE;
          hop::bar_arrive_tx(&full[s], L::STAGE);
          for (int j = 0; j < DW_KROWS / 64; ++j)
            hop::tma_load_2d(st + L::X + j * 8192, &tm_x, &full[s], kt * DW_KROWS + 64 * j,
                             (int)(start + r));
          for (int j = 0; j < W_COLS / 64; ++j)
            hop::tma_load_2d(st + L::D + j * 8192, &tm_dy, &full[s], nt * W_COLS + 64 * j,
                             (int)(start + r));
        }
      }
    }
  } else {
    hop::regs_inc<240>();
    const int cw = wg - 1, g = lane >> 2, t = lane & 3, wtid = tid - 128 * wg;
    unsigned char* epi = sm + L::EPI + cw * L::EPI_WG;
    int it = 0;
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      const int e = u / (n_kt * n_nt), kt = u / n_nt % n_kt, nt = u % n_nt;
      long long start;
      const int count = group(e, start);
      float acc[W_COLS / 2];
      hop::zero_acc(acc);   // an empty group stores its zero sums
      for (int r = 0; r < count; r += W_DEPTH, ++it) {
        const int s = it % W_STAGES;
        hop::bar_wait(&full[s], (it / W_STAGES) & 1);
        unsigned char* st = sm + s * L::STAGE;
        const int valid = count - r;
        if (valid < W_DEPTH) {
          // zero rows valid.. of this consumer's x box and of half the dY
          // boxes, then both consumers meet before either's products
          const int n16 = (W_DEPTH - valid) * 8;   // 16-byte chunks a box
          uint4* zx = reinterpret_cast<uint4*>(st + L::X + cw * 8192 + valid * 128);
          uint4* zd0 = reinterpret_cast<uint4*>(st + L::D + 2 * cw * 8192 + valid * 128);
          uint4* zd1 = reinterpret_cast<uint4*>(st + L::D + (2 * cw + 1) * 8192 + valid * 128);
          for (int i = wtid; i < n16; i += 128) {
            zx[i] = make_uint4(0, 0, 0, 0);
            zd0[i] = make_uint4(0, 0, 0, 0);
            zd1[i] = make_uint4(0, 0, 0, 0);
          }
          hop::fence_async_smem();
          hop::named_sync(3, 256);
        }
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < W_DEPTH / 16; ++kk)
          hop::mma_ss<1, 1>(acc, hop::desc(st + L::X + cw * 8192 + kk * 2048, 8192, 1024),
                            hop::desc(st + L::D + kk * 2048, 8192, 1024), 1,
                            hop::Tag<W_COLS>());
        hop::wg_commit();
        hop::wg_wait<1>();
        if (r > 0 && lane == 0) hop::bar_arrive(&empty[(it - 1) % W_STAGES]);
      }
      hop::wg_wait<0>();
      hop::fence_acc(acc);
      if (count > 0 && lane == 0) hop::bar_arrive(&empty[(it - 1) % W_STAGES]);

      // epilogue: bf16 into 4 swizzled boxes (64 of K x 64 of N), then TMA
      // stores while the producer loads the next tile
      if (wtid == 0) hop::tma_store_wait_read();   // the previous tile's stores read out
      hop::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < W_COLS / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          const int off = (j / 8) * 8192 + r * 128 + (((j % 8) ^ (r & 7)) << 4) + 4 * t;
          *reinterpret_cast<__nv_bfloat162*>(epi + off) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      hop::fence_async_smem();
      hop::named_sync(1 + cw, 128);
      if (wtid == 0) {
        for (int j = 0; j < W_COLS / 64; ++j)
          hop::tma_store_3d(&tm_dw, epi + j * 8192, nt * W_COLS + 64 * j,
                            kt * DW_KROWS + 64 * cw, e);
        hop::tma_store_commit();
      }
    }
    if (wtid == 0) hop::tma_store_wait();
  }
}

int launch_bf16(const void* x, const void* w, const void* gs, const void* dout, void* dx,
                void* dw, int T_rows, int K, int N, int E, int blocks, int dx_smem, int dw_smem,
                cudaStream_t stream) {
  if (dx_smem != DxLayout::BYTES || dw_smem != DwLayout::BYTES || blocks < 1) return -1;
  if (T_rows == 0) {
    // no rows: dX is empty and every dW[e] is zero
    if (dw) return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * 2, stream);
    return 0;
  }
  if (dx) {
    CUtensorMap mdy, mw;
    const uint64_t dy_dims[2] = {(uint64_t)N, (uint64_t)T_rows}, dy_str[1] = {(uint64_t)N * 2};
    const uint32_t dy_box[2] = {W_DEPTH, DX_ROWS};
    const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)E * K}, w_str[1] = {(uint64_t)N * 2};
    const uint32_t w_box[2] = {W_DEPTH, W_COLS};
    if (hop::make_tmap(&mdy, dout, 2, dy_dims, dy_str, dy_box) ||
        hop::make_tmap(&mw, w, 2, w_dims, w_str, w_box))
      return -2;
    cudaError_t err = cudaFuncSetAttribute(moe_gmm_bwd_dx_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           DxLayout::BYTES);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_bwd_dx_wgmma_kernel<<<blocks, WS_THREADS, DxLayout::BYTES, stream>>>(
        mdy, mw, static_cast<const int*>(gs), static_cast<bf16*>(dx), T_rows, K, N, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dw) {
    CUtensorMap mx, mdy, mdw;
    const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)T_rows}, x_str[1] = {(uint64_t)K * 2};
    const uint64_t dy_dims[2] = {(uint64_t)N, (uint64_t)T_rows}, dy_str[1] = {(uint64_t)N * 2};
    const uint32_t box[2] = {64, W_DEPTH};
    const uint64_t dw_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
    const uint64_t dw_str[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
    const uint32_t dw_box[3] = {64, 64, 1};
    if (hop::make_tmap(&mx, x, 2, x_dims, x_str, box) ||
        hop::make_tmap(&mdy, dout, 2, dy_dims, dy_str, box) ||
        hop::make_tmap(&mdw, dw, 3, dw_dims, dw_str, dw_box))
      return -2;
    cudaError_t err = cudaFuncSetAttribute(moe_gmm_bwd_dw_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           DwLayout::BYTES);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_bwd_dw_wgmma_kernel<<<blocks, WS_THREADS, DwLayout::BYTES, stream>>>(
        mx, mdy, mdw, static_cast<const int*>(gs), T_rows, K, N, E);
  }
  return (int)cudaGetLastError();
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

}  // namespace

// x: (T, K); w: (E, K, N); dout: (T, N); dx: (T, K) or null (not computed);
// dw: (E, K, N) or null; all contiguous, 16-byte aligned, one dtype, 0 =
// float32, 1 = bfloat16; group_sizes: (E,) int32 on the device. K and N
// multiples of 8 (16-byte rows, which TMA's strides need), 1 <= E <= 256;
// float32 (a grid of tiles) also E * ceil(K / 64) <= 65535. For bf16 the
// wrapper passes the wgmma body's geometry: persistent blocks and the dX
// and dW kernels' dynamic shared memory bytes (checked against this
// build's). Returns 0, a cudaError_t code, -1 for unsupported arguments,
// or -2 when a tensor map cannot be encoded.
extern "C" int moe_gmm_bwd_launch(const void* x, const void* w, const void* group_sizes,
                                  const void* dout, void* dx, void* dw, int T_rows, int K,
                                  int N, int E, int dtype, int blocks, int dx_smem, int dw_smem,
                                  void* stream) {
  if (E < 1 || E > MAX_E || K % 8 || N % 8 || T_rows < 0) return -1;
  if (K <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((long long)E * ((K + BM - 1) / BM) > 65535) return -1;
    return launch_f32(x, w, group_sizes, dout, dx, dw, T_rows, K, N, E, s);
  }
  if (dtype != 1) return -1;
  return launch_bf16(x, w, group_sizes, dout, dx, dw, T_rows, K, N, E, blocks, dx_smem,
                     dw_smem, s);
}
