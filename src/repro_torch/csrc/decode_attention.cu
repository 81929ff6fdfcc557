// K3: decode attention over a dense per-slot KV cache for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel _decode_kernel / decode_attention
// (src/repro/kernels/decode_attention.py:31, :70): one query token per
// sequence, GQA, against a contiguous cache k, v (B, S, KV, hd) of which the
// first kv_len[b] slots are valid (a ring cache passes min(pos + 1, L), so
// slot order never matters to the softmax). The cache may be int8 with
// per-(sequence, kv head) float32 scales, dequantized on load as the Pallas
// body does (:46-50). The serving paths that run it: recurrentgemma's
// sliding-window decode against its ring cache (G = 10, KV = 1, hd = 256),
// and the dense per-slot layout (page_size = 0) of any global-attention
// model (granite: G = 4, KV = 8, hd = 64).
//
// What bounds it on the H100: ~4 * hd * G operations per 2 * hd elements of
// K/V read, i.e. a few operations per byte, so memory bandwidth. Each block
// reads only the kv_len[b] valid rows of its (sequence, kv head) and nothing
// past them, once, with 16-byte vector loads.
//
// Schedule: the few-rows decode schedule of K1 (csrc/paged_attention.cu)
// over contiguous keys. One block of 8 warps per (kv head, sequence). The
// G query rows of the kv head split into row groups of RPG = 8 rows, one
// group per 8 / NG warps (NG = 1, 2, 4 or 8 groups; G <= 64), so a warp
// never carries more than 8 rows of state: G = 10 takes two groups of four
// warps. Within a group the warps split the keys 32 at a time: lane = key
// for the scores, lane = head dim for p @ v, each warp with its own running
// max, sum and accumulator in registers, merged through shared memory at
// the end. Keys of one chunk are read by every group (from L2 after the
// first). float32 FMA on CUDA cores (no TF32), NEG_INF = -1e30, the sum
// clamped at 1e-30 and the accumulator divided once at the end.
//
// Known limit: recurrentgemma has KV = 1, so B = 8 decode rows are 8 blocks
// on 132 SMs. Splitting the keys across blocks (flash-decode, with a merge
// pass) is the next step.
//
// Grid: (KV, B); 256 threads; dynamic shared memory smem_bytes<HD>(NG).
#include <stdint.h>

#include "attention_common.cuh"

namespace rt {
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// 16-byte vector loads of int8 cache rows, widened to float.
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* f) {
    const int4 u = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)c[i];
  }
};
}  // namespace rt

namespace {

constexpr int RPG = 8;    // query rows per row group (a warp's rows)
constexpr int NW = 8;     // warps per block
constexpr int GMAX = NW * RPG;   // most query heads per kv head

template <int HD>
size_t smem_bytes(int n_groups) {
  return sizeof(float) * (size_t)(n_groups * RPG * HD + 2 * NW * RPG + NW * RPG * HD);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ kv_len,
                        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                        TQ* __restrict__ out, int S, int H, int KV, int NG, float scale) {
  constexpr int E = HD / 32;           // head dims per lane in p @ v
  constexpr int VN = rt::Vec<TKV>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // NG * RPG x HD, pre-scaled
  float* Ms = Qs + NG * RPG * HD;                    // NW x RPG
  float* Ls = Ms + NW * RPG;                         // NW x RPG
  float* As = Ls + NW * RPG;                         // NW x RPG x HD

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV;
  const int WG = NW / NG;              // warps per row group
  const int r0 = (warp / WG) * RPG;    // this warp's first row
  const int nr = min(RPG, G - r0);     // its live rows (<= 0: none)
  const int kvl = min(kv_len[b], S);
  const float ks = k_scale ? k_scale[b * KV + kvh] : 1.f;
  const float vs = v_scale ? v_scale[b * KV + kvh] : 1.f;
  const long long q0 = ((long long)b * H + kvh * G) * HD;   // q, out: (B, 1, H, HD)

  for (int idx = tid; idx < NG * RPG * HD; idx += NW * 32) {
    const int r = idx / HD;
    Qs[idx] = r < G ? rt::to_f32(q[q0 + idx]) * scale : 0.f;
  }
  __syncthreads();

  float m[RPG], l[RPG], acc[RPG][E];
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
    m[r] = rt::NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  if (nr > 0) {                        // uniform across the warp
    for (int t = warp % WG; t * 32 < kvl; t += WG) {
      const int kp = t * 32 + lane;
      const bool valid = kp < kvl;
      long long off = 0;
      float s[RPG];
#pragma unroll
      for (int r = 0; r < RPG; ++r) s[r] = 0.f;
      if (valid) {
        off = (((long long)b * S + kp) * KV + kvh) * HD;
#pragma unroll 4
        for (int d0 = 0; d0 < HD; d0 += VN) {
          float kf[VN];
          rt::Vec<TKV>::load(k + off + d0, kf);
#pragma unroll
          for (int u = 0; u < VN; ++u) kf[u] *= ks;
#pragma unroll
          for (int r = 0; r < RPG; ++r) {
            if (r < nr) {
#pragma unroll
              for (int u = 0; u < VN; ++u)
                s[r] = fmaf(Qs[(r0 + r) * HD + d0 + u], kf[u], s[r]);
            }
          }
        }
      }
      float p[RPG];
#pragma unroll
      for (int r = 0; r < RPG; ++r) {
        if (r >= nr) { p[r] = 0.f; continue; }
        const float sv = valid ? s[r] : rt::NEG_INF;
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
        for (int e = 0; e < E; ++e) vv[e] = rt::to_f32(v[offj + lane + 32 * e]) * vs;
#pragma unroll
        for (int r = 0; r < RPG; ++r) {
          if (r < nr) {
            const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
          }
        }
      }
    }
  }

  // merge the partial softmax states of each row group's warps
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
    if (lane == 0) { Ms[warp * RPG + r] = m[r]; Ls[warp * RPG + r] = l[r]; }
#pragma unroll
    for (int e = 0; e < E; ++e) As[(warp * RPG + r) * HD + lane + 32 * e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NW * 32) {
    const int r = idx / HD, d = idx % HD;
    const int w0 = (r / RPG) * WG, rr = r % RPG;
    float M = rt::NEG_INF;
    for (int w = w0; w < w0 + WG; ++w) M = fmaxf(M, Ms[w * RPG + rr]);
    float L = 0.f, A = 0.f;
    for (int w = w0; w < w0 + WG; ++w) {
      const float wt = expf(Ms[w * RPG + rr] - M);
      L += wt * Ls[w * RPG + rr];
      A += wt * As[(w * RPG + rr) * HD + d];
    }
    out[q0 + idx] = rt::from_f32<TQ>(A / fmaxf(L, 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           const void* k_scale, const void* v_scale, void* out, int B, int S, int H, int KV,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  int NG = 1;
  while (NG * RPG < G) NG *= 2;        // 1, 2, 4 or 8 row groups
  const size_t smem = smem_bytes<HD>(NG);
  const cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<TQ, TKV, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)KV, (unsigned)B);
  decode_attention_kernel<TQ, TKV, HD><<<grid, NW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(kv_len), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<TQ*>(out), S, H, KV, NG, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kl,
                const void* ks, const void* vs, void* out, int B, int S, int H, int KV,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<TQ, TKV, 64>(q, k, v, kl, ks, vs, out, B, S, H, KV, scale, s);
    case 128: return launch<TQ, TKV, 128>(q, k, v, kl, ks, vs, out, B, S, H, KV, scale, s);
    case 256: return launch<TQ, TKV, 256>(q, k, v, kl, ks, vs, out, B, S, H, KV, scale, s);
    default: return -1;
  }
}

template <typename TQ>
int dispatch_kv(int kv_int8, int hd, const void* q, const void* k, const void* v,
                const void* kl, const void* ks, const void* vs, void* out, int B, int S,
                int H, int KV, float scale, cudaStream_t s) {
  if (kv_int8) return dispatch_hd<TQ, int8_t>(hd, q, k, v, kl, ks, vs, out, B, S, H, KV, scale, s);
  return dispatch_hd<TQ, TQ>(hd, q, k, v, kl, ks, vs, out, B, S, H, KV, scale, s);
}

}  // namespace

// q: (B, 1, H, hd); k, v: (B, S, KV, hd) in q's dtype, or int8 when
// kv_int8; kv_len: (B,) int32, each in [1, S] (larger is clamped to S);
// k_scale, v_scale: (B, KV) float32 or null (1.0); out: (B, 1, H, hd). All
// contiguous, q, k, v and out 16-byte aligned; H / KV <= 64. dtype 0 =
// float32, 1 = bfloat16. Returns 0, a cudaError_t code, or -1 for an
// unsupported hd / dtype / group size.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, const void* k_scale,
                                       const void* v_scale, void* out, int B, int S, int H,
                                       int KV, int hd, float scale, int dtype, int kv_int8,
                                       void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || H / KV > GMAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_kv<float>(kv_int8, hd, q, k, v, kv_len, k_scale, v_scale, out, B, S, H, KV,
                              scale, s);
  if (dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_int8, hd, q, k, v, kv_len, k_scale, v_scale, out, B,
                                      S, H, KV, scale, s);
  return -1;
}
