// K5: RG-LRU linear-recurrence scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _rglru_kernel / rglru_scan
// (src/repro/kernels/rglru_scan.py:26, :49): the diagonal recurrence
// h_t = a_t * h_{t-1} + b_t over (B, S, D), from h0 (or zeros), float32
// out. RecurrentGemma runs it in every RG-LRU prefill and prefill chunk.
//
// What bounds it on the H100: 2 operations per element against 12 bytes
// (a, b read and h written in float32), so memory bandwidth; but the time
// recurrence is a dependent chain, so what this first version really waits
// on is latency. One thread owns one (b, d) channel and walks time in
// order, so the carried state never leaves a register and nothing crosses
// threads. Neighbouring threads own neighbouring d, so every load and
// store of a time step is coalesced along D. The time loop is unrolled by
// UNROLL with all of a block's a_t and b_t loaded before the chain runs,
// so UNROLL loads are in flight per thread while the previous block's
// chain computes.
//
// Multiplies and adds are __fmul_rn / __fadd_rn: never contracted into an
// FMA, so the float32 kernel equals the sequential plain version
// (kernels/ref.py rglru_scan: one rounded multiply, one rounded add per
// step) bit for bit.
//
// Known limit: at B = 1 and D = 2560 (recurrentgemma-2b) there are 2560
// threads, 20 blocks of 128 on 132 SMs. A chunked two-pass scan over time
// (local scans, then a carry pass) is the next step.
//
// Grid: (ceil(D / 128), B); 128 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  float h = h0 ? h0[(long long)blockIdx.y * D + d] : 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = base + (long long)(t + u) * D;
      av[u] = to_f32(a[o]);
      bv[u] = to_f32(b[o]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      out[base + (long long)(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    const long long o = base + (long long)t * D;
    h = __fadd_rn(__fmul_rn(to_f32(a[o]), h), to_f32(b[o]));
    out[o] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, int B, int S, int D,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((D + NT - 1) / NT), (unsigned)B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<float*>(out), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (B, S, D) contiguous, dtype 0 = float32, 1 = bfloat16; h0: (B, D)
// float32 or null (zeros); out: (B, S, D) float32.
// Returns 0, a cudaError_t code, or -1 for an unsupported dtype.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* out,
                                 int B, int S, int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, B, S, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, out, B, S, D, s);
  return -1;
}
