// Shared pieces of the port's attention kernels (sm_90a, CUDA C++).
//
// DenseCache and PagedCache map (sequence, kv head, key) to a K/V row for
// every attention body: contiguous (B, S, KV, hd) for flash prefill and
// the dense decode cache, a block-table page lookup for the paged pool.
//
// tiled_attention() is the float32 online-softmax body of K2 (flash
// prefill) and K1's chunks (paged chunked prefill): one block of 256
// threads owns a tile of BQ = 64 query rows of one (sequence, kv head); a
// row is a (query position, head of the kv head's group) pair, so the G
// query heads that share a kv head read each K/V tile once. The block walks
// key tiles of BK = 64 and skips tiles the mask leaves empty. bf16 prefill
// runs the tensor-core body of prefill_common.cuh instead, and decode the
// split body of decode_common.cuh.
//
// Numerics follow the Pallas bodies: float32 scores, running max, sum and
// accumulator (FMA on CUDA cores, no TF32 anywhere), NEG_INF = -1e30 rather
// than -inf, l clamped at 1e-30 and the accumulator divided once at the end.
// Given an lse pointer (K2 under autograd), a block also stores each row's
// log-sum-exp m + log(l) of the scaled scores, float32 (B, H, n_pos), for
// the backward; a null pointer (serving, K1's chunks) stores nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block: 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row index (element offset / hd) of key kp of (sequence b, kv head kvh).
struct DenseCache {              // (B, S, KV, hd)
  int S, KV;
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ long long row(int b, int kvh, int kp) const {
    return ((long long)b * S + kp) * KV + kvh;
  }
};
struct PagedCache {              // pool (num_pages, page, KV, hd), tables (B, P)
  const int* tables;
  int P, page, KV;
  __device__ __forceinline__ int capacity() const { return P * page; }
  __device__ __forceinline__ long long row(int b, int kvh, int kp) const {
    const long long phys = tables[(long long)b * P + kp / page];
    return (phys * page + kp % page) * KV + kvh;
  }
};

template <int HD>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) +
         sizeof(long long) * BK + sizeof(int) * BQ;
}

// One block's tile of query rows of sequence b. q and out are (.., n_pos, H,
// HD) with the sequence's first element at q_seq0; row r is query position
// r / G of head kvh * G + r % G, at absolute position qbase + r / G. Keys
// [0, kv_len) are valid; causal / window / chunk masks follow
// flash_attention.py:64-71. lse, where not null, is (B, H, n_pos).
template <typename T, int HD, class Cache>
__device__ void tiled_attention(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                long long q_seq0, int b, int H, int kvh, int G, int n_pos,
                                int qbase, int kv_len, int causal, int window,
                                int chunk, float scale, const Cache& cache,
                                float* __restrict__ lse = nullptr) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = HD + 1;   // padded row stride: conflict-free column reads
  constexpr int PS = BK + 1;
  constexpr int E = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * HD;
  long long* koff = reinterpret_cast<long long*>(Ps + BQ * PS);
  int* rpos = reinterpret_cast<int*>(koff + BK);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rows = n_pos * G;
  const int r0 = blockIdx.x * BQ;
  if (r0 >= rows) return;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int lr = idx / HD, d = idx % HD, r = r0 + lr;
    float val = 0.f;
    if (r < rows) {
      const long long o = q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD + d;
      val = to_f32(q[o]) * scale;
    }
    Qs[lr * QS + d] = val;
  }
  if (tid < BQ) rpos[tid] = qbase + min(r0 + tid, rows - 1) / G;
  const int q_lo = qbase + r0 / G;
  const int q_hi = qbase + (min(r0 + BQ, rows) - 1) / G;

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_kt = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    bool live = true;   // the reachability test of flash_attention.py:42-53
    if (causal) live = live && k_lo <= q_hi;
    if (window) live = live && k_hi > q_lo - window;
    if (chunk) live = live && (k_hi / chunk >= q_lo / chunk) && (k_lo / chunk <= q_hi / chunk);
    if (!live) continue;   // uniform across the block

    __syncthreads();       // the previous tile's readers are done
    if (tid < BK) {
      const int kp = k_lo + tid;
      koff[tid] = kp < kv_len ? cache.row(b, kvh, kp) * HD : -1;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int c = idx / HD, d = idx % HD;
      const long long o = koff[c];
      Ks[c * QS + d] = o >= 0 ? to_f32(k[o + d]) : 0.f;
      Vs[c * HD + d] = o >= 0 ? to_f32(v[o + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = rpos[ty * 4 + i];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_lo + tx + 16 * j;
        bool ok = kp < kv_len;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        if (chunk) ok = ok && (kp / chunk) == (qp / chunk);
        if (!ok) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = group16_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
      rs = group16_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vv = Vs[c * HD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + kvh * G + r % G) * n_pos + r / G] = m[i] + logf(lc);
    const long long o = q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) out[o + tx + 16 * e] = from_f32<T>(acc[i][e] / lc);
  }
}

}  // namespace rt
