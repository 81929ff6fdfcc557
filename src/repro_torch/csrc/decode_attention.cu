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
// llama4-scout's chunked-attention rings (G = 5, KV = 8, hd = 128) and the
// dense per-slot layout (page_size = 0) of any global-attention model
// (granite: G = 4, KV = 8, hd = 64).
//
// What bounds it on the H100: the bytes of K/V (a few operations per
// byte). The body is the split-KV flash-decode of decode_common.cuh over
// contiguous keys (rt::DenseCache): keys split across blocks by a plan
// fixed from shapes, staged by a cp.async ring, bf16 queries on mma.sync
// (over a bf16 cache, or an int8 one widened exactly in registers), float32
// queries on CUDA-core FMA, partials merged by a second kernel.
//
// Under a mesh a rank holds one range of a cache's slots (the cache split
// over its sequence): each rank runs K3 on its range with a local kv_len
// that may be 0, and the ranks merge their outputs with the optional lse
// output, (B, H) float32 in natural log. A row with kv_len 0 reads no key and
// writes an output of 0 and an lse of -inf.
#include "decode_common.cuh"

namespace {

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           const void* k_scale, const void* v_scale, void* out, void* ws, void* lse, int B,
           int S, int H, int KV, int n_split, float scale, cudaStream_t stream) {
  const dec::Params<TQ, TKV, rt::DenseCache> p{
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(kv_len), nullptr, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<TQ*>(out), static_cast<float*>(ws),
      rt::DenseCache{S, KV}, H, KV, n_split, scale * 1.4426950408889634f,
      static_cast<float*>(lse)};
  return dec::launch<HD>(p, B, stream);
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kl,
                const void* ks, const void* vs, void* out, void* ws, void* lse, int B, int S,
                int H, int KV, int n_split, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, kl, ks, vs, out, ws, lse, B, S, H, KV, n_split,
                                 scale, s);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, kl, ks, vs, out, ws, lse, B, S, H, KV, n_split,
                                  scale, s);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, kl, ks, vs, out, ws, lse, B, S, H, KV, n_split,
                                  scale, s);
    default: return -1;
  }
}

template <typename TQ>
int dispatch_kv(int kv_int8, int hd, const void* q, const void* k, const void* v,
                const void* kl, const void* ks, const void* vs, void* out, void* ws, void* lse,
                int B, int S, int H, int KV, int n_split, float scale, cudaStream_t s) {
  if (kv_int8)
    return dispatch_hd<TQ, int8_t>(hd, q, k, v, kl, ks, vs, out, ws, lse, B, S, H, KV, n_split,
                                   scale, s);
  return dispatch_hd<TQ, TQ>(hd, q, k, v, kl, ks, vs, out, ws, lse, B, S, H, KV, n_split,
                             scale, s);
}

}  // namespace

// q: (B, 1, H, hd); k, v: (B, S, KV, hd) in q's dtype, or int8 when
// kv_int8; kv_len: (B,) int32 in [0, S] (larger than S is clamped to S; 0
// reads no key); k_scale, v_scale: (B, KV) float32 or null (1.0); out: (B, 1,
// H, hd); ws: float32 workspace of n_split * B * H * (hd + 2) elements, or
// null when n_split is 1; lse: (B, H) float32 or null (not written). All
// contiguous, q, k, v and out 16-byte aligned. dtype 0 = float32, 1 =
// bfloat16. Returns 0, a cudaError_t code, or -1 for an unsupported hd /
// dtype / shape.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, const void* k_scale,
                                       const void* v_scale, void* out, void* ws, void* lse,
                                       int B, int S, int H, int KV, int hd, int n_split,
                                       float scale, int dtype, int kv_int8, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || n_split < 1 || (n_split > 1 && !ws)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_kv<float>(kv_int8, hd, q, k, v, kv_len, k_scale, v_scale, out, ws, lse, B,
                              S, H, KV, n_split, scale, s);
  if (dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_int8, hd, q, k, v, kv_len, k_scale, v_scale, out, ws,
                                      lse, B, S, H, KV, n_split, scale, s);
  return -1;
}
