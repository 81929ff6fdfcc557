// The pieces K2's warp-specialised wgmma bodies share (sm_90a, CUDA C++):
// the forward (flash_attention.cu, flash_attention_wgmma_kernel) and the
// backward's dQ and dK/dV passes (flash_attention_bwd.cu).
//
// The mask (causal, sliding-window, same-chunk or none; queries are the
// last Sq of Skv positions) per pair and per tile, the walk of a block
// that owns one head's consecutive query positions over its live key
// tiles, and the tensor maps that cut q, k and v into TMA boxes.
#pragma once

#include "hopper_common.cuh"

namespace wa {

// 384 threads: warpgroup 0 produces (TMA), warpgroups 1 and 2 consume
// (wgmma); the ring's empty barriers count the consumers' 8 warps
constexpr int WS_THREADS = 384;
constexpr int WS_CONSUMER_WARPS = 8;

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

// whether every pair of keys [k_lo, k_hi] (all < kv_len) and query
// positions [q_lo, q_hi] is visible: the tile needs no mask
__device__ __forceinline__ bool tiles_full(int k_lo, int k_hi, int q_lo, int q_hi, int kv_len,
                                           int causal, int window, int chunk) {
  bool ok = k_hi < kv_len;
  if (causal) ok = ok && k_hi <= q_lo;
  if (window) ok = ok && k_lo > q_hi - window;
  if (chunk) ok = ok && k_lo / chunk == q_hi / chunk && k_hi / chunk == q_lo / chunk;
  return ok;
}

// The tile of a block that owns QR consecutive positions of one head
// (query blocks slowest; under a causal mask the last, heaviest, first)
// and its live key tiles of BK keys, one interval [kt0, kt0 + n_steps).
// kernels/flash_attention.py q_block / q_walk mirror it.
struct QWalk {
  int qb, h, b, kt0, n_steps;
};
template <int QR, int BK>
__device__ __forceinline__ QWalk q_walk(int B, int Sq, int Skv, int H, int causal, int window,
                                        int chunk) {
  const int n_qb = (Sq + QR - 1) / QR, rank = blockIdx.x / (H * B);
  const int h = blockIdx.x % H, b = blockIdx.x / H % B, qb = causal ? n_qb - 1 - rank : rank;
  const int qbase = Skv - Sq, q_lo = qbase + qb * QR, q_hi = qbase + min(qb * QR + QR, Sq) - 1;
  auto live = [&](int kt) {
    return tiles_meet(kt * BK, kt * BK + BK - 1, q_lo, q_hi, causal, window, chunk);
  };
  int kt1 = (Skv + BK - 1) / BK - 1;
  if (causal) kt1 = min(kt1, q_hi / BK);
  while (kt1 >= 0 && !live(kt1)) --kt1;
  int kt0 = 0;
  while (kt0 <= kt1 && !live(kt0)) ++kt0;
  return {qb, h, b, kt0, kt1 - kt0 + 1};
}

// host: a (B, S, heads, HD) bf16 tensor as (HD, heads, S, B), boxes of
// 64 x 1 x rows x 1 in the 128-byte swizzle: one head's consecutive
// positions, so G need not divide a tile and positions past S load as
// zeros
template <int HD>
int head_map(CUtensorMap* m, const void* p, int B, int S, int heads, int rows) {
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)HD * 2, (uint64_t)heads * HD * 2,
                               (uint64_t)S * heads * HD * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hop::make_tmap(m, p, 4, dims, strides, box);
}

}  // namespace wa
