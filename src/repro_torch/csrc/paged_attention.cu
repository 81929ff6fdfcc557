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
// * decode (C == 1): the split-KV flash-decode of decode_common.cuh over
//   block-table keys (rt::PagedCache): keys split across blocks by a plan
//   fixed from shapes, each key row's page looked up as its cp.async copy
//   is issued, bf16 queries on mma.sync (over a bf16 or an int8 pool),
//   float32 on CUDA-core FMA, partials merged by a second kernel. A null q_offset means decode: the
//   causal limit is kv_len itself, so the wrapper builds no q_offset.
// * chunks (C > 1): one block per 64 query rows of one (sequence, kv
//   head), K/V tiles of 64 keys staged in shared memory through the block
//   table (rt::PagedCache), the query rows at positions q_offset[b] + [0,
//   C) and the keys [0, min(kv_len[b], P * page)) read on the device, so
//   the grid (ceil(C * G / 64), KV, B) depends on shapes only. bf16:
//   paged_prefill_mma_kernel, the tensor-core body of prefill_common.cuh
//   that K2 runs (mma.sync fed by ldmatrix from a 2-stage cp.async ring,
//   each key row's page looked up as its copy is issued). float32:
//   paged_tiled_kernel, the tiled body of attention_common.cuh, float32
//   FMA on CUDA cores (no TF32), exact as the Pallas body's float32 dots.
//
// An int8 pool (kv_dtype="int8") is read as its integer values, unit
// scales, as the Pallas body upcasts it (:157-158), with bf16 or float32
// queries; each schedule has an instance for it, keeping its structure:
// bf16 decode takes the split body's tensor-core instance over int8 keys
// (int8 tiles through the cp.async ring, half the bytes, each thread's B
// fragments widened exactly to bf16 in registers), float32 decode its
// CUDA-core FMA instance (rt::Vec<int8_t> widens 16 values a 16-byte
// read); bf16 chunks the tensor-core body staging int8 tiles through
// cp.async and widening them to bf16 in shared memory before ldmatrix;
// float32 chunks the tiled body with an int8 load.
//
// Inactive engine rows carry an all-zeros table and kv_len = 1, so they read
// row 0 of the reserved scratch page 0: harmless.
#include "decode_common.cuh"
#include "prefill_common.cuh"

namespace {

template <typename T, typename TKV, int HD>
__global__ void __launch_bounds__(rt::NT)
paged_tiled_kernel(const T* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
                   const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                   T* __restrict__ out, int C, int H, int KV, int P, int page, float scale) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const rt::PagedCache cache{block_tables, P, page, KV};
  rt::tiled_attention<T, TKV, HD>(q, k_pool, v_pool, out, (long long)b * C * H * HD, b, H, kvh,
                                  H / KV, C, q_offset[b], min(kv_len[b], cache.capacity()),
                                  /*causal=*/1, 0, 0, scale, cache);
}

template <int HD, typename TKV>
__global__ void __launch_bounds__(pf::MT)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k_pool,
                         const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
                         const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                         __nv_bfloat16* __restrict__ out, int C, int H, int KV, int P, int page,
                         float scale_log2) {
  const int b = blockIdx.z;
  const rt::PagedCache cache{block_tables, P, page, KV};
  pf::prefill_mma<HD, rt::PagedCache, TKV>(q, k_pool, v_pool, out, C, H, KV, q_offset[b],
                                           min(kv_len[b], cache.capacity()), /*causal=*/1, 0,
                                           0, scale_log2, cache);
}

template <typename T, typename TKV, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* bt,
           const void* kv_len, const void* q_offset, void* out, void* ws, int B, int C, int H,
           int KV, int P, int page, int n_split, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const TKV* kp = static_cast<const TKV*>(k_pool);
  const TKV* vp = static_cast<const TKV*>(v_pool);
  const int* btp = static_cast<const int*>(bt);
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_offset);
  T* op = static_cast<T*>(out);
  if (C == 1) {
    const dec::Params<T, TKV, rt::PagedCache> p{
        qp, kp, vp, kl, qo, nullptr, nullptr, op, static_cast<float*>(ws),
        rt::PagedCache{btp, P, page, KV}, H, KV, n_split, scale * 1.4426950408889634f,
        nullptr};
    return dec::launch<HD>(p, B, stream);
  }
  if (!qo) return -1;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return pf::launch<HD, TKV>(paged_prefill_mma_kernel<HD, TKV>, B, C, H, KV, stream, qp, kp,
                               vp, btp, kl, qo, op, C, H, KV, P, page,
                               scale * 1.4426950408889634f);
  } else {
    constexpr size_t smem = rt::tile_smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        paged_tiled_kernel<T, TKV, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int G = H / KV;
    const dim3 grid((unsigned)((C * G + rt::BQ - 1) / rt::BQ), (unsigned)KV, (unsigned)B);
    paged_tiled_kernel<T, TKV, HD><<<grid, rt::NT, smem, stream>>>(qp, kp, vp, btp, kl, qo, op,
                                                                   C, H, KV, P, page, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, typename TKV>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* bt,
                const void* kl, const void* qo, void* out, void* ws, int B, int C, int H,
                int KV, int P, int page, int n_split, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, TKV, 64>(q, k, v, bt, kl, qo, out, ws, B, C, H, KV, P, page, n_split,
                                scale, s);
    case 128:
      return launch<T, TKV, 128>(q, k, v, bt, kl, qo, out, ws, B, C, H, KV, P, page, n_split,
                                 scale, s);
    case 256:
      return launch<T, TKV, 256>(q, k, v, bt, kl, qo, out, ws, B, C, H, KV, P, page, n_split,
                                 scale, s);
    default: return -1;
  }
}

template <typename T>
int dispatch_kv(int kv_int8, int hd, const void* q, const void* k, const void* v,
                const void* bt, const void* kl, const void* qo, void* out, void* ws, int B,
                int C, int H, int KV, int P, int page, int n_split, float scale,
                cudaStream_t s) {
  if (kv_int8)
    return dispatch_hd<T, int8_t>(hd, q, k, v, bt, kl, qo, out, ws, B, C, H, KV, P, page,
                                  n_split, scale, s);
  return dispatch_hd<T, T>(hd, q, k, v, bt, kl, qo, out, ws, B, C, H, KV, P, page, n_split,
                           scale, s);
}

}  // namespace

// q: (B, C, H, hd); k_pool, v_pool: (num_pages, page, KV, hd) in q's dtype,
// or int8 when kv_int8; block_tables: (B, P) int32; kv_len: (B,) int32;
// q_offset: (B,) int32, or null for decode (C == 1: the causal limit is
// kv_len); out: (B, C, H, hd); ws: float32 workspace of n_split * B * H *
// (hd + 2) elements when C == 1 and n_split > 1, else null (n_split is 1
// for chunks). All contiguous and 16-byte aligned. dtype 0 = float32, 1 =
// bfloat16. Returns 0, a cudaError_t code, or -1 for an unsupported hd /
// dtype / shape.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* kv_len,
                                      const void* q_offset, void* out, void* ws, int B, int C,
                                      int H, int KV, int hd, int P, int page, int n_split,
                                      float scale, int dtype, int kv_int8, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (KV <= 0 || H % KV || n_split < 1 || (n_split > 1 && (C != 1 || !ws))) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_kv<float>(kv_int8, hd, q, k_pool, v_pool, block_tables, kv_len, q_offset,
                              out, ws, B, C, H, KV, P, page, n_split, scale, s);
  if (dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_int8, hd, q, k_pool, v_pool, block_tables, kv_len,
                                      q_offset, out, ws, B, C, H, KV, P, page, n_split, scale,
                                      s);
  return -1;
}
