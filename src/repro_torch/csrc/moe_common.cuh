// The group scan that K4's kernels share (csrc/moe_gmm.cu, the forward;
// csrc/moe_gmm_bwd.cu, its backward): rows sorted by expert, group_sizes
// (E <= 256, int32) on the card, read by every block into shared memory
// and scanned there, so the host never learns them. Group sizes are
// clamped to [0, T] and every group's rows to [0, T): rows past T do not
// exist, as in ragged_dot.
#pragma once

#include <cuda_runtime.h>

namespace moe {

constexpr int BM = 64;      // rows per tile, both routes
constexpr int MAX_E = 256;  // experts whose offsets fit the block's scan

// Every block scans the group sizes into inclusive sums of rows and of row
// tiles of TILE rows, s_rows / s_tiles[0 .. MAX_E), with its NT threads
// (threads past MAX_E only join the barriers).
template <int NT, int TILE = BM>
__device__ inline void scan_groups(const int* __restrict__ group_sizes, int T_rows, int E,
                                   long long* s_rows, int* s_tiles) {
  constexpr int PER = (MAX_E + NT - 1) / NT;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * NT;
    if (i < MAX_E) {
      const int g = i < E ? min(max(group_sizes[i], 0), T_rows) : 0;
      s_rows[i] = g;
      s_tiles[i] = (g + TILE - 1) / TILE;
    }
  }
  __syncthreads();
  for (int off = 1; off < E; off <<= 1) {
    long long r[PER];
    int c[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      r[j] = i < MAX_E && i >= off ? s_rows[i - off] : 0;
      c[j] = i < MAX_E && i >= off ? s_tiles[i - off] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      if (i < MAX_E) {
        s_rows[i] += r[j];
        s_tiles[i] += c[j];
      }
    }
    __syncthreads();
  }
}

// Row tile mtile of the scanned groups: its expert, first row and number
// of rows (<= 0: nothing to compute); for a tile past the last group,
// e = -1 and row0 is the first of the BM rows it zeroes.
struct RowTile {
  int e;
  long long row0;
  int rows;
};

__device__ inline RowTile find_row_tile(const long long* s_rows, const int* s_tiles, int T_rows,
                                        int E, int mtile) {
  const int total_tiles = s_tiles[E - 1];
  if (mtile >= total_tiles)
    return {-1, min(s_rows[E - 1], (long long)T_rows) + (long long)(mtile - total_tiles) * BM,
            0};
  int lo = 0, hi = E - 1;  // the expert whose tiles hold mtile
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tiles[mid] > mtile) hi = mid;
    else lo = mid + 1;
  }
  const int tile0 = lo ? s_tiles[lo - 1] : 0;
  const long long row0 = (lo ? s_rows[lo - 1] : 0) + (long long)(mtile - tile0) * BM;
  return {lo, row0, (int)min((long long)BM, min(s_rows[lo], (long long)T_rows) - row0)};
}

// Tile u of the persistent wgmma bodies' static order (csrc/moe_gmm.cu's
// forward, csrc/moe_gmm_bwd.cu's dX): tiles of ROWS rows of one expert x
// one of n_ct column tiles, experts slowest, then column tiles, then the
// expert's row tiles, so the row tiles that read one slab of w[e] run side
// by side and the slab comes from HBM once; s_tiles scanned in tiles of
// ROWS rows. rows <= 0: nothing to compute.
struct ExpertTile {
  int e, c, rows;
  long long row0;
};
template <int ROWS>
__device__ __forceinline__ ExpertTile expert_tile(const long long* s_rows, const int* s_tiles,
                                                  int T_rows, int E, int n_ct, int u) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tiles[mid] * n_ct > u) hi = mid;
    else lo = mid + 1;
  }
  const int t0 = lo ? s_tiles[lo - 1] : 0, rt = s_tiles[lo] - t0, local = u - t0 * n_ct;
  const long long row0 = (lo ? s_rows[lo - 1] : 0) + (long long)(local % rt) * ROWS;
  const long long end = min(s_rows[lo], (long long)T_rows);
  return {lo, local / rt, (int)max(min((long long)ROWS, end - row0), -1LL), row0};
}

}  // namespace moe
