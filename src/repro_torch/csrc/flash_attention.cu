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
// bfloat16: flash_attention_mma_kernel, the tensor-core prefill body of
// prefill_common.cuh (mma.sync fed by ldmatrix from a cp.async ring) over
// contiguous keys (rt::DenseCache), the queries at positions Skv - Sq +
// [0, Sq). K1's chunks run the same body over block-table keys.
//
// float32: flash_attention_kernel, rt::tiled_attention of
// attention_common.cuh, float32 FMA on CUDA cores register-tiled 4x4:
// exact for float32 inputs (no TF32), as the Pallas body's float32 dots.
//
// Under autograd the wrapper passes lse, (B, H, Sq) float32: each query
// row's log-sum-exp of its scaled scores, stored by the same bodies for the
// backward (flash_attention_bwd.cu); null stores nothing.
//
// Grid: (ceil(sq * G / 64), KV, B). bf16: 128 threads, pf::MmaTile<hd>::SMEM
// bytes of dynamic shared memory; float32: 256 threads,
// rt::tile_smem_bytes<HD>() (67 KB at hd 64).
#include "prefill_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T, int HD>
__global__ void __launch_bounds__(rt::NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int Sq, int Skv, int H, int KV, int causal, int window, int chunk,
                       float scale) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  rt::tiled_attention<T, HD>(q, k, v, out, (long long)b * Sq * H * HD, b, H, kvh, H / KV, Sq,
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
                cudaStream_t stream) {
  return pf::launch<HD>(flash_attention_mma_kernel<HD>, B, Sq, H, KV, stream,
                        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv, H, KV,
                        causal, window, chunk, scale * 1.4426950408889634f);
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int Sq, int Skv, int H, int KV, int causal, int window, int chunk, float scale,
           cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, window, chunk, scale,
                           s);
  return -1;
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); out: (B, Sq, H, hd); all
// contiguous and 16-byte aligned. lse: (B, H, Sq) float32, or null for
// none. dtype 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t code, or
// -1 for an unsupported hd / dtype.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                                      int causal, int window, int chunk, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk, scale,
                        s);
    case 128:
      return launch<128>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk,
                         scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, l, B, Sq, Skv, H, KV, causal, window, chunk,
                         scale, s);
  }
  return -1;
}
