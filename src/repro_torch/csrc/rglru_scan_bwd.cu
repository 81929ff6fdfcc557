// K5 backward: the reverse RG-LRU scan for Hopper (sm_90a), CUDA C++.
//
// Stands for the backward of the XLA path of ops.rglru_scan (the
// associative scan of src/repro/kernels/ref.py rglru_scan under jax.grad):
// the Pallas TPU kernel _rglru_kernel / rglru_scan (src/repro/kernels/
// rglru_scan.py:26, :49) has no VJP. For h_t = a_t * h_{t-1} + b_t and the
// gradient dh of its output:
//   g_t = dh_t + a_{t+1} * g_{t+1}   (a_S * g_S taken as 0 * 0),
//   db_t = g_t, da_t = g_t * h_{t-1} (h_{-1} = h0, or zeros),
//   dh0 = a_0 * g_0.
// kernels/ref.py rglru_scan_bwd is the same walk in plain PyTorch, and this
// kernel equals it bit for bit: one lane a channel runs the chain with
// __fmul_rn / __fadd_rn (never contracted into an FMA), in the same order.
//
// What bounds it on the H100: 3 operations an element against 20 bytes
// (a, h and dh read, da and db written, float32), so memory: B = 1,
// S = 3072, D = 2560 is 157 MB, 0.047 ms at 3.35 TB/s. What the design does
// about it: the forward's streaming layout (rglru_scan.cu) with time
// running backwards. A block owns CH channels of one sequence (the
// forward's plan: kernels/rglru_scan.py scan_plan, CH and the copy width
// VEC); the chain lanes (threads 0..CH-1) only compute; the other warps
// (the producers) keep a ring of STAGES tiles of T time steps of a, dh and
// h (h read one step behind, so h_{t-1} sits beside a_t) in flight with
// cp.async, from the last tile to the first, and flush the chain's
// double-buffered da and db tiles a tile later with 16-byte stores. The
// chain reads a whole tile from shared memory into registers at its start
// (independent loads), then walks it from its last step to its first.
// Steps past S and channels past D are zero-filled (g stays 0 there) and
// never flushed. 6 stages: at CH = 64 three input rings of 8 stages and the
// output tiles would pass the 227 KB a block may hold.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int NT = 128;     // threads per block
constexpr int T = 32;       // time steps per ring stage
constexpr int STAGES = 6;   // ring stages

// VEC bytes global -> shared by cp.async; ok false zero-fills
template <int VEC>
__device__ __forceinline__ void copy(void* dst, const void* src, bool ok) {
  if constexpr (VEC == 16) {
    mma::cp_async16(dst, src, ok ? 16 : 0);
  } else {
    static_assert(VEC == 8 || VEC == 4, "copy width");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(mma::smem_addr(dst)),
                 "l"(src), "n"(VEC), "r"(ok ? VEC : 0));
  }
}

template <int CH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * STAGES * T * CH + 2 * 2 * T * CH);
}

template <int CH, int VEC>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, const float* __restrict__ h0,
                      float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                      int S, int D) {
  constexpr int EV = VEC / 4;          // elements a copy
  constexpr int CPR = CH / EV;         // copies per row of one array
  constexpr int TILE = T * CH;         // elements of one array in a stage
  constexpr int CPT = T * CPR;         // copies per tile of one array
  constexpr int CW = (CH + 31) / 32;   // chain warps
  constexpr int NP = NT - 32 * CW;     // producer threads
  static_assert(CH % EV == 0 && CH % 16 == 0 && NP >= 32, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // [STAGES][T][CH] a_t
  float* Hs = As + STAGES * TILE;                   // [STAGES][T][CH] h_{t-1}
  float* Gs = Hs + STAGES * TILE;                   // [STAGES][T][CH] dh_t
  float* Oa = Gs + STAGES * TILE;                   // [2][T][CH] da
  float* Ob = Oa + 2 * TILE;                        // [2][T][CH] db

  const int tid = threadIdx.x, d0 = blockIdx.x * CH, d = d0 + tid;
  const int pid = tid - 32 * CW;   // producer index, >= 0 for producers
  const long long seq0 = (long long)blockIdx.y * S * D;
  const int n_tiles = (S + T - 1) / T;

  // producers: ring tile j (time tile n_tiles - 1 - j) into stage j % STAGES
  auto load = [&](int j) {
    const int it = n_tiles - 1 - j;
    float* as = As + (j % STAGES) * TILE;
    float* hs = Hs + (j % STAGES) * TILE;
    float* gs = Gs + (j % STAGES) * TILE;
#pragma unroll
    for (int q = 0; q < (CPT + NP - 1) / NP; ++q) {
      const int c = pid + q * NP;
      if (CPT % NP == 0 || c < CPT) {
        const int r = c / CPR, e = (c % CPR) * EV, ts = it * T + r;
        const bool ok = ts < S && d0 + e < D;   // D % EV == 0: a copy is in or out whole
        const long long o = ok ? seq0 + (long long)ts * D + d0 + e : 0;
        copy<VEC>(as + r * CH + e, a + o, ok);
        copy<VEC>(gs + r * CH + e, dh + o, ok);
        // h_{t-1}: the row before, or h0 (zeros without one) at t = 0
        const bool hok = ok && (ts > 0 || h0 != nullptr);
        const float* hsrc = !hok ? h : ts > 0 ? h + o - D : h0 + (long long)blockIdx.y * D + d0 + e;
        copy<VEC>(hs + r * CH + e, hsrc, hok);
      }
    }
  };
  // producers: the da and db tiles of ring tile j, 16 bytes a copy where rows allow
  auto flush = [&](int j) {
    const int it = n_tiles - 1 - j;
    const float* oa = Oa + (j & 1) * TILE;
    const float* ob = Ob + (j & 1) * TILE;
    if (D % 4 == 0) {
#pragma unroll
      for (int q = 0; q < (TILE / 4 + NP - 1) / NP; ++q) {
        const int c = pid + q * NP;
        if ((TILE / 4) % NP == 0 || c < TILE / 4) {
          const int r = c / (CH / 4), e = (c % (CH / 4)) * 4, ts = it * T + r;
          if (ts < S && d0 + e < D) {
            const long long o = seq0 + (long long)ts * D + d0 + e;
            *reinterpret_cast<float4*>(da + o) = *reinterpret_cast<const float4*>(oa + r * CH + e);
            *reinterpret_cast<float4*>(db + o) = *reinterpret_cast<const float4*>(ob + r * CH + e);
          }
        }
      }
    } else {
      for (int c = pid; c < TILE; c += NP) {
        const int r = c / CH, e = c % CH, ts = it * T + r;
        if (ts < S && d0 + e < D) {
          const long long o = seq0 + (long long)ts * D + d0 + e;
          da[o] = oa[r * CH + e];
          db[o] = ob[r * CH + e];
        }
      }
    }
  };

  if (pid >= 0) {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < n_tiles) load(j);
      mma::cp_async_commit();
    }
  }
  const bool chain = tid < CH;
  float g = 0.f, an = 0.f;   // g_{t+1} and a_{t+1} (0 past the last step)

  for (int j = 0; j < n_tiles; ++j) {
    if (pid >= 0) mma::cp_async_wait<STAGES - 2>();   // tile j has landed ...
    // ... for every thread; the chain is done with tile j - 1's stage and
    // output buffer, and tile j - 2's output is flushed
    __syncthreads();
    if (pid >= 0) {
      if (j + STAGES - 1 < n_tiles) load(j + STAGES - 1);
      mma::cp_async_commit();
      if (j > 0) flush(j - 1);
      continue;
    }
    if (!chain) continue;
    const int st = (j % STAGES) * TILE + tid;
    float av[T], hv[T], gv[T];
#pragma unroll
    for (int r = 0; r < T; ++r) {
      av[r] = As[st + r * CH];
      hv[r] = Hs[st + r * CH];
      gv[r] = Gs[st + r * CH];
    }
    float* oa = Oa + (j & 1) * TILE + tid;
    float* ob = Ob + (j & 1) * TILE + tid;
#pragma unroll
    for (int r = T - 1; r >= 0; --r) {
      g = __fadd_rn(gv[r], __fmul_rn(an, g));
      an = av[r];
      ob[r * CH] = g;
      oa[r * CH] = __fmul_rn(g, hv[r]);
    }
  }
  __syncthreads();
  if (pid >= 0) flush(n_tiles - 1);
  if (chain && dh0 != nullptr && d < D) dh0[(long long)blockIdx.y * D + d] = __fmul_rn(an, g);
}

template <int CH, int VEC>
int launch(const void* a, const void* h, const void* dh, const void* h0, void* da, void* db,
           void* dh0, int B, int S, int D, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CH>();
  auto kernel = rglru_scan_bwd_kernel<CH, VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<const float*>(h0), static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dh0), S, D);
  return (int)cudaGetLastError();
}

template <int CH>
int dispatch(int vec, const void* a, const void* h, const void* dh, const void* h0, void* da,
             void* db, void* dh0, int B, int S, int D, cudaStream_t s) {
  switch (vec) {
    case 16: return launch<CH, 16>(a, h, dh, h0, da, db, dh0, B, S, D, s);
    case 8: return launch<CH, 8>(a, h, dh, h0, da, db, dh0, B, S, D, s);
    case 4: return launch<CH, 4>(a, h, dh, h0, da, db, dh0, B, S, D, s);
  }
  return -1;
}

}  // namespace

// a, h, dh, da, db: (B, S, D) float32 contiguous; h0, dh0: (B, D) float32,
// or both null (no initial state). The plan: ch channels a block (16, 32,
// 64) and vec bytes a copy (16, 8, 4; every pointer and D * 4 must be
// vec-aligned). Returns 0, a cudaError_t code, or -1 for an unsupported
// plan.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                                     const void* h0, void* da, void* db, void* dh0, int B, int S,
                                     int D, int ch, int vec, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 16: return dispatch<16>(vec, a, h, dh, h0, da, db, dh0, B, S, D, s);
    case 32: return dispatch<32>(vec, a, h, dh, h0, da, db, dh0, B, S, D, s);
    case 64: return dispatch<64>(vec, a, h, dh, h0, da, db, dh0, B, S, D, s);
  }
  return -1;
}
