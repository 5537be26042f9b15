// GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention
// (pallas_call at :95): one new token per sequence attends over its KV
// cache, sequence tiles past lengths[b] are skipped, and the G query
// heads that share a kv head are carried together.
//
// What bounds it: bytes. Each step reads the live part of the cache,
// 2 * sum_b lengths[b] * K * D elements, once, and does ~4*G flops per
// element read, far below the ~295 flop/byte at which the H100's bf16
// tensor cores, not its 3.35 TB/s, would be the limit.
// Design: the TPU grid carried the softmax state across sequence
// tiles; here one block owns (batch, kv head), and its four warps
// split the live tiles of 32 keys among themselves (split-K inside the
// block), each with its own online-softmax state in registers, merged
// through shared memory at the end. In a tile each lane scores one key
// for all G heads (the key row read with 16-byte loads), and for the
// P V product each lane owns D/32 head dims, so a warp reads a value
// row as one contiguous 256-byte line. Tiles at or past lengths[b] are
// never read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BS = 32;           // keys per sequence tile (one per lane)
constexpr int WARPS = 4;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float& o, float x) { o = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& o, float x) {
  o = __float2bfloat16(x);
}
// One 16-byte load, widened to fp32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int K, float scale) {
  constexpr int DPL = D / 32;
  __shared__ float qs[G][D];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];
  __shared__ float red_o[WARPS][G][D];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int H = K * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);

  for (int j = tid; j < G * D; j += WARPS * 32) {
    const int g = j / D, c = j % D;
    qs[g][c] = to_f(q[((size_t)b * H + kh * G + g) * D + c]) * scale;
  }
  __syncthreads();

  float m[G], l[G], o[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)K * D;        // between positions
  const T* kbase = kc + ((size_t)b * S * K + kh) * D;
  const T* vbase = vc + ((size_t)b * S * K + kh) * D;
  for (int s0 = warp * BS; s0 < len; s0 += WARPS * BS) {
    const int pos = s0 + lane;
    const bool ok = pos < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (ok) {
      constexpr int V = 16 / sizeof(T);         // elements per load
      const T* krow = kbase + pos * row_stride;
      for (int c0 = 0; c0 < D; c0 += V) {
        float kv[V];
        load16(krow + c0, kv);
#pragma unroll
        for (int u = 0; u < V; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] = fmaf(qs[g][c0 + u], kv[u], s[g]);
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sv = ok ? s[g] : NEG;
      float mt = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - m_new);
      p[g] = ok ? expf(sv - m_new) : 0.f;
      float ps = p[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[g][e] *= alpha;
    }
    const int n = min(BS, len - s0);
    for (int j = 0; j < n; ++j) {
      const T* vrow = vbase + (s0 + j) * row_stride + lane * DPL;
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = to_f(vrow[e]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[g][e] = fmaf(pj, vv[e], o[g][e]);
      }
    }
  }

  // merge the four warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) red_o[warp][g][lane * DPL + e] = o[g][e];
  }
  __syncthreads();
  for (int j = tid; j < G * D; j += WARPS * 32) {
    const int g = j / D, c = j % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = red_l[w][g] > 0.f ? expf(red_m[w][g] - mx) : 0.f;
      lsum += red_l[w][g] * f;
      osum += red_o[w][g][c] * f;
    }
    from_f(out[((size_t)b * H + kh * G + g) * D + c],
           lsum > 0.f ? osum / lsum : 0.f);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, int B, int S, int K,
                   float scale, cudaStream_t stream) {
  dim3 grid(K, B);
  decode_kernel<T, D, G><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), S, K,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* kc, const void* vc,
                     const int* lengths, void* out, int B, int S, int K,
                     float scale, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, kc, vc, lengths, out, B, S, K, scale,
                                   stream);
    case 2: return launch<T, D, 2>(q, kc, vc, lengths, out, B, S, K, scale,
                                   stream);
    case 4: return launch<T, D, 4>(q, kc, vc, lengths, out, B, S, K, scale,
                                   stream);
    case 8: return launch<T, D, 8>(q, kc, vc, lengths, out, B, S, K, scale,
                                   stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), k_cache/v_cache (B, S, K, D), out (B, H, D), one dtype
// (bf16 when is_bf16, else fp32); lengths (B,) int32 valid positions.
// D in {64, 128}; G = H / K in {1, 2, 4, 8}.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache,
                                    const void* lengths, void* out, int B,
                                    int S, int H, int K, int D, float scale,
                                    int is_bf16, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  auto s = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  cudaError_t err;
  if (is_bf16)
    err = D == 128 ? launch_g<__nv_bfloat16, 128>(G, q, k_cache, v_cache,
                                                  len, out, B, S, K, scale,
                                                  s)
                   : launch_g<__nv_bfloat16, 64>(G, q, k_cache, v_cache,
                                                 len, out, B, S, K, scale,
                                                 s);
  else
    err = D == 128 ? launch_g<float, 128>(G, q, k_cache, v_cache, len, out,
                                          B, S, K, scale, s)
                   : launch_g<float, 64>(G, q, k_cache, v_cache, len, out, B,
                                         S, K, scale, s);
  return (int)err;
}
