// K4: grouped (expert) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _gmm_kernel / moe_gmm
// (src/repro/kernels/moe_gmm.py:26, :47): jax.lax.ragged_dot semantics.
// Rows of x (T, K) are sorted by expert; the group_sizes[e] rows of expert
// e multiply w[e] (K, N); products accumulate in float32 and the output
// (T, N) is x's dtype. Rows past the last group are written as zeros. The
// MoE feed-forward runs it three times per layer (gate, up, down).
//
// What bounds it on the H100: at decode (8 rows over up to 8 experts) and
// at prefill (1024 tokens over 16 experts of 5120 x 8192), the expert
// weights dominate the bytes and the work per weight byte is below the
// ~295 operations per byte where the bf16 tensor cores, not the 3.35 TB/s
// memory, set the limit: the bound is reading each used expert's weights
// once. This first version computes with float32 FMA on CUDA cores (exact
// for float32 inputs, no TF32), so at prefill its arithmetic, not its
// bytes, is what it waits on.
//
// The design, against the TPU kernel: the Pallas wrapper scatters x into a
// copy padded so that each row tile holds one expert, and gathers the
// output back. Here nothing is copied: every block loads the group sizes
// (E <= 256) into shared memory, scans them into row and tile offsets,
// and finds its expert and row range itself; the ragged edge of each
// group is masked. The host never learns the group sizes. The grid is the
// static worst case, ceil(T / 64) + E row tiles by ceil(N / 64) column
// tiles (the Pallas bound Mp / bm); a tile past the last group zeroes its
// share of the rows no group covers, or returns. A block reads its
// (K, 64) slab of w[e] once for all its rows, so at decode each active
// expert's weights stream once. Warps whose 8 rows are all past the
// group's edge skip the arithmetic. The K loop stages a (64, 32) x tile
// (transposed) and a (32, 64) w tile through shared memory, with the next
// stage's 16-byte global loads in registers while the current one
// computes; each thread accumulates a 4 x 4 patch in float32. Weights are
// indexed with 64-bit offsets (grok-1's w per layer holds 1.6e9 elements).
//
// Next: tensor cores (mma.sync, then wgmma with TMA-fed shared memory
// stages), and a persistent schedule that walks tiles ordered by expert so
// a slab of w[e] stays in L2 for all of its row tiles.
//
// Grid: (ceil(T / 64) + E, ceil(N / 64)); 256 threads; 17 KB of static
// shared memory plus 3 KB for the group offsets.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // 16 x 16 threads, each owning a 4 x 4 output patch
constexpr int BM = 64;      // rows per tile
constexpr int BN = 64;      // columns per tile
constexpr int BK = 32;      // depth per shared-memory stage
constexpr int MAX_E = 256;  // experts whose offsets fit the block's scan

// 16 bytes of T, widened to float
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& raw, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* f) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ group_sizes, T* __restrict__ out, int T_rows, int K,
               int N, int E) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LV = BM * BK / (VEC * NT);  // 16-byte vectors per thread per tile
  static_assert(BM * BK == BK * BN, "x and w tiles hold as many elements");
  __shared__ long long s_rows[MAX_E];  // inclusive scan of (clamped) group sizes
  __shared__ int s_tiles[MAX_E];       // inclusive scan of row tiles per group
  __shared__ __align__(16) float As[BK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;

  // ---- group offsets: every block scans the group sizes itself ----
  {
    int g = 0;
    if (tid < E) g = min(max(group_sizes[tid], 0), T_rows);
    s_rows[tid] = g;
    s_tiles[tid] = (g + BM - 1) / BM;
    __syncthreads();
    for (int off = 1; off < E; off <<= 1) {
      const long long r = tid >= off ? s_rows[tid - off] : 0;
      const int c = tid >= off ? s_tiles[tid - off] : 0;
      __syncthreads();
      s_rows[tid] += r;
      s_tiles[tid] += c;
      __syncthreads();
    }
  }
  const int mtile = blockIdx.x;
  const int total_tiles = s_tiles[E - 1];
  if (mtile >= total_tiles) {
    // rows no group covers are zero, as ragged_dot leaves them
    const long long r0 = min(s_rows[E - 1], (long long)T_rows) +
                         (long long)(mtile - total_tiles) * BM;
    for (int i = tid; i < BM * (BN / 4); i += NT) {
      const long long r = r0 + i / (BN / 4);
      const int c = n0 + (i % (BN / 4)) * 4;
      if (r < T_rows && c < N) {
        const float z[4] = {0.f, 0.f, 0.f, 0.f};
        Vec<T>::store4(out + r * N + c, z);
      }
    }
    return;
  }
  int lo = 0, hi = E - 1;  // the expert whose tiles hold mtile
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tiles[mid] > mtile) hi = mid;
    else lo = mid + 1;
  }
  const int e = lo;
  const int tile0 = e ? s_tiles[e - 1] : 0;
  const long long row0 = (e ? s_rows[e - 1] : 0) + (long long)(mtile - tile0) * BM;
  const int rows = (int)min((long long)BM, min(s_rows[e], (long long)T_rows) - row0);
  if (rows <= 0) return;

  const T* we = w + (long long)e * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  const bool live = (ty & ~1) * 4 < rows;  // uniform per warp: rows 8w..8w+7

  uint4 xr[LV], wr[LV];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      const int r = v % BM, kx = (v / BM) * VEC;  // lanes walk rows
      xr[i] = (r < rows && k0 + kx < K)
                  ? *reinterpret_cast<const uint4*>(x + (row0 + r) * K + k0 + kx)
                  : make_uint4(0, 0, 0, 0);
      const int kr = v / (BN / VEC), nv = (v % (BN / VEC)) * VEC;
      wr[i] = (k0 + kr < K && n0 + nv < N)
                  ? *reinterpret_cast<const uint4*>(we + (long long)(k0 + kr) * N + n0 + nv)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LV; ++i) {
      const int v = tid + i * NT;
      float f[VEC];
      Vec<T>::widen(xr[i], f);
      const int r = v % BM, kx = (v / BM) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) As[kx + j][r] = f[j];
      Vec<T>::widen(wr[i], f);
      const int kr = v / (BN / VEC), nv = (v % (BN / VEC)) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(&Bs[kr][nv + j]) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while this stage computes
    if (live) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int c = n0 + tx * 4;
  if (c >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) Vec<T>::store4(out + (row0 + r) * N + c, acc[i]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* gs, void* out, int T_rows, int K, int N,
           int E, cudaStream_t stream) {
  const dim3 grid((unsigned)((T_rows + BM - 1) / BM + E), (unsigned)((N + BN - 1) / BN));
  moe_gmm_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                             static_cast<const T*>(w),
                                             static_cast<const int*>(gs), static_cast<T*>(out),
                                             T_rows, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, K); w: (E, K, N); out: (T, N); all contiguous, 16-byte aligned,
// dtype 0 = float32, 1 = bfloat16; group_sizes: (E,) int32 on the device.
// K and N multiples of 8, 1 <= E <= 256, ceil(N / 64) <= 65535.
// Returns 0, a cudaError_t code, or -1 for unsupported arguments.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* group_sizes, void* out,
                              int T_rows, int K, int N, int E, int dtype, void* stream) {
  if (E < 1 || E > MAX_E || K % 8 || N % 8) return -1;
  if (T_rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, group_sizes, out, T_rows, K, N, E, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, group_sizes, out, T_rows, K, N, E, s);
  return -1;
}
