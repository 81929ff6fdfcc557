// K5: RG-LRU linear-recurrence scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _rglru_kernel / rglru_scan
// (src/repro/kernels/rglru_scan.py:26, :49): the diagonal recurrence
// h_t = a_t * h_{t-1} + b_t over (B, S, D), from h0 (or zeros), float32
// out. RecurrentGemma runs it in every RG-LRU prefill and prefill chunk.
//
// What bounds it on the H100: 2 operations per element against 12 bytes
// (a, b read and h written in float32; 8 with bf16 a and b), so memory:
// B = 1, S = 3000, D = 2560 is 92 MB, 0.0275 ms at 3.35 TB/s. The time
// recurrence is a dependent chain, but a short one: one rounded multiply
// and one rounded add, ~8 cycles a step, ~13 us for 3000 steps, under the
// bound. What the card needs is enough bytes in flight: at ~1 us of memory
// latency, 3.35 TB/s wants ~3 MB in flight, i.e. ~160 time steps of all
// 2560 channels ahead of the chain.
//
// Design: an exact streaming scan.
// * Chain. One lane per channel walks time in order with __fmul_rn /
//   __fadd_rn (never contracted into an FMA), so the output equals the
//   sequential plain version (kernels/ref.py rglru_scan) bit for bit, and
//   nothing is reassociated.
// * Grid. A block owns CH channels (16, 32 or 64) of one sequence: grid
//   (ceil(D / CH), B), 128 threads. Warp specialised: the chain lanes are
//   threads 0..CH-1 (half of warp 0, warp 0, or warps 0-1) and do nothing
//   else; the remaining warps (the producers) issue every copy and store.
// * Ring. a and b arrive through a ring of STAGES = 8 stages in shared
//   memory, each T = 32 time steps x CH channels of both, filled by
//   the producers with cp.async: up to STAGES - 1 tiles are in flight
//   while the chain runs one tile from registers and reads the next from shared
//   memory into registers in the issue slots its dependent arithmetic
//   leaves idle, so the chain never waits on a load. One barrier a tile
//   hands stages over. Copies are VEC bytes wide: 16 where every row of a
//   and b is 16-byte aligned, else 8 or 4, else (a bf16 row of odd
//   length) plain 2-byte loads and stores, so every shape is taken. Rows
//   past D and steps past S are zero-filled (src-size 0) and never
//   flushed.
// * Output. The chain writes h into a double-buffered tile in shared
//   memory, and the producers flush it a tile later with 16-byte stores
//   (4-byte ones where D % 4 != 0). Stored from the chain lane itself, a
//   row of h a step, the chain took 3x as long: its global stores held up
//   the next tile's shared-memory reads.
// CH is chosen by the wrapper's plan (kernels/rglru_scan.py scan_plan),
// from timing every choice in one run; 8 stages beat 4 at every CH but 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int NT = 128;     // threads per block
constexpr int T = 32;       // time steps per ring stage
constexpr int STAGES = 8;   // ring stages

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC bytes global -> shared; ok false zero-fills. 16 / 8 / 4 bytes by
// cp.async, 2 bytes by a plain load and store (complete at once).
template <int VEC>
__device__ __forceinline__ void copy(void* dst, const void* src, bool ok) {
  if constexpr (VEC == 16) {
    mma::cp_async16(dst, src, ok ? 16 : 0);
  } else if constexpr (VEC == 8 || VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(mma::smem_addr(dst)),
                 "l"(src), "n"(VEC), "r"(ok ? VEC : 0));
  } else {
    static_assert(VEC == 2, "copy width");
    *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

template <typename Tin, int CH>
constexpr size_t smem_bytes() {
  return sizeof(Tin) * 2 * STAGES * T * CH + sizeof(float) * 2 * T * CH;
}

template <typename Tin, int CH, int VEC>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  constexpr int EV = VEC / sizeof(Tin) > 0 ? VEC / sizeof(Tin) : 1;   // elements a copy
  constexpr int CPR = CH / EV;         // copies per row of one array
  constexpr int TILE = T * CH;         // elements of one array in a stage
  constexpr int CPT = T * CPR;         // copies per tile of one array
  constexpr int CW = (CH + 31) / 32;   // chain warps
  constexpr int NP = NT - 32 * CW;     // producer threads
  static_assert(CH % EV == 0 && CH % 16 == 0 && NP >= 32, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* As = reinterpret_cast<Tin*>(smem_raw);   // [STAGES][T][CH]
  Tin* Bs = As + STAGES * TILE;                 // [STAGES][T][CH]
  float* Os = reinterpret_cast<float*>(Bs + STAGES * TILE);   // [2][T][CH]

  const int tid = threadIdx.x, d0 = blockIdx.x * CH, d = d0 + tid;
  const int pid = tid - 32 * CW;       // producer index, >= 0 for producers
  const long long seq0 = (long long)blockIdx.y * S * D;
  const int n_tiles = (S + T - 1) / T;

  // producers: tile i of a and b (time steps i*T ..) into ring stage i % STAGES
  auto load = [&](int i) {
    Tin* as = As + (i % STAGES) * TILE;
    Tin* bs = Bs + (i % STAGES) * TILE;
#pragma unroll
    for (int j = 0; j < (CPT + NP - 1) / NP; ++j) {
      const int c = pid + j * NP;
      if (CPT % NP == 0 || c < CPT) {
        const int r = c / CPR, e = (c % CPR) * EV, ts = i * T + r;
        const bool ok = ts < S && d0 + e < D;   // D % EV == 0: a copy is in or out whole
        const long long o = ok ? seq0 + (long long)ts * D + d0 + e : 0;
        copy<VEC>(as + r * CH + e, a + o, ok);
        copy<VEC>(bs + r * CH + e, b + o, ok);
      }
    }
  };
  // producers: out tile i to h, 16 bytes a copy where rows allow
  auto flush = [&](int i) {
    const float* os = Os + (i & 1) * TILE;
    if (D % 4 == 0) {
#pragma unroll
      for (int j = 0; j < (TILE / 4 + NP - 1) / NP; ++j) {
        const int c = pid + j * NP;
        if ((TILE / 4) % NP == 0 || c < TILE / 4) {
          const int r = c / (CH / 4), e = (c % (CH / 4)) * 4, ts = i * T + r;
          if (ts < S && d0 + e < D)
            *reinterpret_cast<float4*>(out + seq0 + (long long)ts * D + d0 + e) =
                *reinterpret_cast<const float4*>(os + r * CH + e);
        }
      }
    } else {
      for (int c = pid; c < TILE; c += NP) {
        const int r = c / CH, e = c % CH, ts = i * T + r;
        if (ts < S && d0 + e < D) out[seq0 + (long long)ts * D + d0 + e] = os[r * CH + e];
      }
    }
  };

  if (pid >= 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      if (i < n_tiles) load(i);
      mma::cp_async_commit();
    }
    mma::cp_async_wait<STAGES - 1>();   // tile 0 has landed
  }
  __syncthreads();
  const bool chain = tid < CH;
  float h = (chain && d < D && h0) ? h0[(long long)blockIdx.y * D + d] : 0.f;
  float av[T], bv[T];   // the chain's current tile, in registers
  if (chain) {
#pragma unroll
    for (int r = 0; r < T; ++r) {
      av[r] = to_f32(As[r * CH + tid]);
      bv[r] = to_f32(Bs[r * CH + tid]);
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (pid >= 0) mma::cp_async_wait<STAGES - 2>();   // tiles <= i + 1 have landed ...
    // ... for every thread; the chain has read stage i % STAGES (tile i)
    // and written out tile i - 1
    __syncthreads();
    if (pid >= 0) {
      if (i + STAGES < n_tiles) load(i + STAGES);
      mma::cp_async_commit();
      if (i > 0) flush(i - 1);
      continue;
    }
    if (!chain) continue;
    // the chain over tile i, from registers; tile i + 1's values are read
    // from shared memory in the issue slots the dependent chain leaves
    // idle, so the chain never waits on a load
    const Tin* an_s = As + ((i + 1) % STAGES) * TILE + tid;
    const Tin* bn_s = Bs + ((i + 1) % STAGES) * TILE + tid;
    const bool next = i + 1 < n_tiles;
    float* os = Os + (i & 1) * TILE + tid;   // steps past S are not flushed
    float an[T], bn[T];
#pragma unroll
    for (int r = 0; r < T; ++r) {
      h = __fadd_rn(__fmul_rn(av[r], h), bv[r]);
      os[r * CH] = h;
      if (next) {
        an[r] = to_f32(an_s[r * CH]);
        bn[r] = to_f32(bn_s[r * CH]);
      }
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
      av[r] = an[r];
      bv[r] = bn[r];
    }
  }
  __syncthreads();
  if (pid >= 0) flush(n_tiles - 1);
}

template <typename Tin, int CH, int VEC>
int launch(const void* a, const void* b, const void* h0, void* out, int B, int S, int D,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Tin, CH>();
  auto kernel = rglru_scan_kernel<Tin, CH, VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const Tin*>(a), static_cast<const Tin*>(b),
                                     static_cast<const float*>(h0), static_cast<float*>(out),
                                     S, D);
  return (int)cudaGetLastError();
}

// Every copy width of one (dtype, CH).
template <typename Tin, int CH>
int dispatch(int vec, const void* a, const void* b, const void* h0, void* out, int B, int S,
             int D, cudaStream_t s) {
  switch (vec) {
    case 16: return launch<Tin, CH, 16>(a, b, h0, out, B, S, D, s);
    case 8: return launch<Tin, CH, 8>(a, b, h0, out, B, S, D, s);
    case 4: return launch<Tin, CH, 4>(a, b, h0, out, B, S, D, s);
  }
  if constexpr (sizeof(Tin) == 2) {
    if (vec == 2) return launch<Tin, CH, 2>(a, b, h0, out, B, S, D, s);
  }
  return -1;
}

template <typename Tin>
int dispatch_ch(int ch, int vec, const void* a, const void* b, const void* h0, void* out,
                int B, int S, int D, cudaStream_t s) {
  switch (ch) {
    case 16: return dispatch<Tin, 16>(vec, a, b, h0, out, B, S, D, s);
    case 32: return dispatch<Tin, 32>(vec, a, b, h0, out, B, S, D, s);
    case 64: return dispatch<Tin, 64>(vec, a, b, h0, out, B, S, D, s);
  }
  return -1;
}

}  // namespace

// a, b: (B, S, D) contiguous, dtype 0 = float32, 1 = bfloat16; h0: (B, D)
// float32 or null (zeros); out: (B, S, D) float32, 16-byte aligned. The
// plan: ch channels a block (16, 32, 64) and vec bytes a copy (16, 8, 4,
// or 2 for bfloat16; a, b and D * itemsize must be vec-aligned). Returns
// 0, a cudaError_t code, or -1 for an unsupported dtype or plan.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* out,
                                 int B, int S, int D, int dtype, int ch, int vec,
                                 void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec >= 4) return dispatch_ch<float>(ch, vec, a, b, h0, out, B, S, D, s);
  if (dtype == 1) return dispatch_ch<__nv_bfloat16>(ch, vec, a, b, h0, out, B, S, D, s);
  return -1;
}
