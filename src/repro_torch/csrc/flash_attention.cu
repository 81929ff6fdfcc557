// K2: flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _attn_kernel / flash_attention
// (src/repro/kernels/flash_attention.py:27, :88): online-softmax GQA
// attention whose queries are the last sq of skv positions, with causal,
// sliding-window, same-chunk or no mask, skipping key tiles the mask
// leaves empty.
//
// What bounds it on the H100: at prefill lengths (hundreds to thousands of
// tokens) attention does ~4*hd operations per (query, key) pair on inputs
// read once, far above the ~295 operations per byte where the tensor cores
// and not the 3.35 TB/s memory become the limit, so it is bound by
// arithmetic. This first version keeps every intermediate out of device
// memory (scores, probabilities and the running max/sum/accumulator live in
// shared memory and registers; each K/V tile is read once per kv head and
// shared by the G query heads of its group) but computes with float32 FMA on
// CUDA cores, register-tiled 4x4 per thread: exact for float32 inputs (no
// TF32), and a long way below the bf16 tensor-core peak. wgmma, TMA and warp
// specialisation are later work.
//
// Grid: (ceil(sq * G / 64), KV, B); 256 threads; dynamic shared memory
// rt::tile_smem_bytes<HD>() (67 KB at hd 64).
#include "attention_common.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(rt::NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                       int H, int KV, int causal, int window, int chunk, float scale) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const rt::ContiguousKeys keys{(long long)b * Skv, KV, kvh, HD};
  rt::tiled_attention<T, HD>(q, k, v, out, (long long)b * Sq * H * HD, H, kvh, H / KV, Sq,
                             Skv - Sq, Skv, causal, window, chunk, scale, keys);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int KV, int causal, int window, int chunk, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = rt::tile_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const dim3 grid((unsigned)((Sq * G + rt::BQ - 1) / rt::BQ), (unsigned)KV, (unsigned)B);
  flash_attention_kernel<T, HD><<<grid, rt::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int KV, int causal, int window, int chunk,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
    default: return -1;
  }
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); out: (B, Sq, H, hd); all
// contiguous and 16-byte aligned. dtype 0 = float32, 1 = bfloat16.
// Returns 0, a cudaError_t code, or -1 for an unsupported hd / dtype.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int H, int KV, int hd,
                                      int causal, int window, int chunk, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window, chunk, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window, chunk,
                                      scale, s);
  return -1;
}
