// K1: paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _paged_kernel / _paged_attention
// (src/repro/kernels/decode_attention.py:135, :182), the serving engine's
// decode step (paged_decode_attention, C == 1) and chunked-prefill step
// (paged_prefill_attention): online-softmax GQA attention of query rows
// (chunk position x head of the kv head's group) against a K/V pool
// (num_pages, page, KV, hd) read page by page through per-sequence block
// tables, masked by kp < kv_len and kp <= q_offset + row / G.
//
// What bounds it on the H100: decode does ~4*hd*G operations per 2*hd
// bytes of K/V it reads (G = 4 at granite's width: ~4 operations a byte),
// so it is bound by memory bandwidth; a 256-token chunk does ~C times more
// per byte and leans toward arithmetic. Each block reads the physical page
// id from block_tables[b, j] itself and stops at kv_len, so it never walks
// the dead pages past kv_len that the Pallas grid visits, and it never
// gathers the pages into a contiguous copy in device memory.
//
// Two schedules of the same arithmetic:
// * few rows (C * G <= 8, i.e. decode): one block of 8 warps per
//   (sequence, kv head); the warps split the keys, lane = key for the
//   scores, lane = head dim for p @ v, each warp with its own running
//   max/sum/accumulator in registers, merged through shared memory at the
//   end. All 256 threads stream K/V even though a decode block has only
//   G query rows.
// * many rows (chunks): the tiled body of attention_common.cuh, one block
//   per 64 query rows of one (sequence, kv head), K/V tiles of 64 keys
//   staged in shared memory through the block table.
// Both compute in float32 with FMA on CUDA cores (no TF32) and end with
// acc / max(l, 1e-30). Split-KV across blocks and tensor-core products are
// later work.
//
// Inactive engine rows carry an all-zeros table and kv_len = 1, so they read
// row 0 of the reserved scratch page 0: harmless.
#include "attention_common.cuh"

namespace {

constexpr int RMAX = 8;   // most query rows the few-rows schedule takes
constexpr int NW = 8;     // warps per few-rows block

template <int HD>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (size_t)(RMAX * HD + 2 * NW * RMAX + NW * RMAX * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NW * 32)
paged_rows_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                  const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                  T* __restrict__ out, int C, int H, int KV, int P, int page, float scale) {
  constexpr int E = HD / 32;           // head dims per lane in p @ v
  constexpr int VN = rt::Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // RMAX x HD, pre-scaled
  float* Ms = Qs + RMAX * HD;                        // NW x RMAX
  float* Ls = Ms + NW * RMAX;                        // NW x RMAX
  float* As = Ls + NW * RMAX;                        // NW x RMAX x HD

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, rows = C * G;
  const int kvl = min(kv_len[b], P * page);
  const int qoff = q_offset[b];
  const int* table = block_tables + (long long)b * P;
  const long long q_seq0 = (long long)b * C * H * HD;

  for (int idx = tid; idx < RMAX * HD; idx += NW * 32) {
    const int r = idx / HD, d = idx % HD;
    float val = 0.f;
    if (r < rows)
      val = rt::to_f32(q[q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD + d]) * scale;
    Qs[idx] = val;
  }
  __syncthreads();

  float m[RMAX], l[RMAX], acc[RMAX][E];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = rt::NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int t = warp; t * 32 < kvl; t += NW) {
    const int kp = t * 32 + lane;
    const bool valid = kp < kvl;
    long long off = 0;
    float s[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) s[r] = 0.f;
    if (valid) {
      off = (((long long)table[kp / page] * page + kp % page) * KV + kvh) * HD;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += VN) {
        float kf[VN];
        rt::Vec<T>::load(k_pool + off + d0, kf);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < rows) {
#pragma unroll
            for (int u = 0; u < VN; ++u) s[r] = fmaf(Qs[r * HD + d0 + u], kf[u], s[r]);
          }
        }
      }
    }
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rows) { p[r] = 0.f; continue; }
      const bool ok = valid && kp <= qoff + r / G;
      const float sv = ok ? s[r] : rt::NEG_INF;
      float mt = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(sv - m_new);
      float ps = p[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
    const int n_valid = min(32, kvl - t * 32);
    for (int j = 0; j < n_valid; ++j) {
      const long long offj = __shfl_sync(0xffffffffu, off, j);
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = rt::to_f32(v_pool[offj + lane + 32 * e]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < rows) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (lane == 0) { Ms[warp * RMAX + r] = m[r]; Ls[warp * RMAX + r] = l[r]; }
#pragma unroll
    for (int e = 0; e < E; ++e) As[(warp * RMAX + r) * HD + lane + 32 * e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * HD; idx += NW * 32) {
    const int r = idx / HD, d = idx % HD;
    float M = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Ms[w * RMAX + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(Ms[w * RMAX + r] - M);
      L += wt * Ls[w * RMAX + r];
      A += wt * As[(w * RMAX + r) * HD + d];
    }
    out[q_seq0 + ((long long)(r / G) * H + kvh * G + r % G) * HD + d] =
        rt::from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(rt::NT)
paged_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                   const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                   T* __restrict__ out, int C, int H, int KV, int P, int page, float scale) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const rt::PagedKeys keys{block_tables + (long long)b * P, page, KV, kvh, HD};
  const int kvl = min(kv_len[b], P * page);
  rt::tiled_attention<T, HD>(q, k_pool, v_pool, out, (long long)b * C * H * HD, H, kvh, H / KV,
                             C, q_offset[b], kvl, /*causal=*/1, 0, 0, scale, keys);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* bt,
           const void* kv_len, const void* q_offset, void* out, int B, int C, int H, int KV,
           int P, int page, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int* btp = static_cast<const int*>(bt);
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_offset);
  T* op = static_cast<T*>(out);
  cudaError_t err;
  if (C * G <= RMAX) {
    constexpr size_t smem = rows_smem_bytes<HD>();
    err = cudaFuncSetAttribute(paged_rows_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(1, (unsigned)KV, (unsigned)B);
    paged_rows_kernel<T, HD><<<grid, NW * 32, smem, stream>>>(qp, kp, vp, btp, kl, qo, op, C, H,
                                                              KV, P, page, scale);
  } else {
    constexpr size_t smem = rt::tile_smem_bytes<HD>();
    err = cudaFuncSetAttribute(paged_tiled_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((C * G + rt::BQ - 1) / rt::BQ), (unsigned)KV, (unsigned)B);
    paged_tiled_kernel<T, HD><<<grid, rt::NT, smem, stream>>>(qp, kp, vp, btp, kl, qo, op, C, H,
                                                              KV, P, page, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* bt,
                const void* kl, const void* qo, void* out, int B, int C, int H, int KV, int P,
                int page, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, bt, kl, qo, out, B, C, H, KV, P, page, scale, s);
    case 128: return launch<T, 128>(q, k, v, bt, kl, qo, out, B, C, H, KV, P, page, scale, s);
    case 256: return launch<T, 256>(q, k, v, bt, kl, qo, out, B, C, H, KV, P, page, scale, s);
    default: return -1;
  }
}

}  // namespace

// q: (B, C, H, hd); k_pool, v_pool: (num_pages, page, KV, hd); block_tables:
// (B, P) int32; kv_len, q_offset: (B,) int32; out: (B, C, H, hd). All
// contiguous and 16-byte aligned. dtype 0 = float32, 1 = bfloat16.
// Returns 0, a cudaError_t code, or -1 for an unsupported hd / dtype.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* kv_len,
                                      const void* q_offset, void* out, int B, int C, int H,
                                      int KV, int hd, int P, int page, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, block_tables, kv_len, q_offset, out, B, C,
                              H, KV, P, page, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, block_tables, kv_len, q_offset, out,
                                      B, C, H, KV, P, page, scale, s);
  return -1;
}
