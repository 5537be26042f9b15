// Causal GQA prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention
// (pallas_call at :84): online softmax over kv tiles, fp32 statistics
// and accumulation, kv tiles past the causal frontier skipped, kv head
// = q head / G.
//
// What bounds it: the serving prefill is short (S ~ 40-64 tokens,
// H = 16, D = 128, bf16), so the inputs are a few hundred KB and a
// call is bound by launch latency and the serial tile loop rather
// than by bytes (3.35 TB/s) or bf16 tensor-core operations. At long S
// the 4*B*H*S^2*D/2 operations dominate; this first version runs them
// on CUDA cores in fp32 (no wgmma yet), which a later PR replaces.
// Design: the TPU grid carried (m, l, acc) from one kv step to the
// next; here one block owns (batch, q head, 16-row q tile) and loops
// over the kv tiles up to the causal frontier itself. K and V tiles of
// 32 keys are staged in shared memory as fp32; each warp carries four
// query rows, each lane one key for the scores and four head dims for
// the output. Any S is taken: the ragged last q and kv tiles are
// masked, which the TPU kernel's S % bq == 0 assert did not allow.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 16;           // query rows per block
constexpr int BK = 32;           // keys per kv tile
constexpr int ROWS = 4;          // query rows per warp
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float& o, float x) { o = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& o, float x) {
  o = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int K, float scale) {
  constexpr int DPL = D / 32;                 // head dims per lane
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];             // +1: conflict-free columns
  __shared__ __align__(16) float vs[BK][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / K, kh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < BQ * D; j += THREADS) {
    const int r = j / D, c = j % D, s = q0 + r;
    qs[r][c] = s < S ? to_f(q[(((size_t)b * S + s) * H + h) * D + c]) *
                           scale
                     : 0.f;
  }

  float m[ROWS], l[ROWS], o[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;     // causal frontier
  for (int k0 = 0; k0 <= q_last; k0 += BK) {
    __syncthreads();                          // previous tile consumed
    for (int j = tid; j < BK * D; j += THREADS) {
      const int r = j / D, c = j % D, s = k0 + r;
      const size_t off = (((size_t)b * S + s) * K + kh) * D + c;
      ks[r][c] = s < S ? to_f(k[off]) : 0.f;
      vs[r][c] = s < S ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    // scores: lane = key of the tile, four query rows per warp
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kv = ks[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        s[r] = fmaf(qs[warp * ROWS + r][c], kv, s[r]);
    }
    const int kpos = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
      const bool ok = kpos <= qpos && kpos < S;
      float sv = ok ? s[r] : NEG;
      float mt = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sv - m_new) : 0.f;
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] *= alpha;
    }
    // o += P V: lane owns head dims [lane*DPL, lane*DPL + DPL)
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = vs[j][lane * DPL + e];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] = fmaf(pj, vv[e], o[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + warp * ROWS + r;
    if (s >= S) continue;
    const float inv = 1.f / l[r];
    T* dst = out + (((size_t)b * S + s) * H + h) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) from_f(dst[e], o[r][e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int K, float scale,
                   cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, K, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k/v (B, S, K, D), out (B, S, H, D), all contiguous in
// one dtype: bf16 when is_bf16, else fp32. D in {64, 128}, H % K == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int K, int D, float scale,
                                   int is_bf16, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(D == 128
                     ? launch<__nv_bfloat16, 128>(q, k, v, out, B, S, H, K,
                                                  scale, s)
                     : launch<__nv_bfloat16, 64>(q, k, v, out, B, S, H, K,
                                                 scale, s));
  return (int)(D == 128
                   ? launch<float, 128>(q, k, v, out, B, S, H, K, scale, s)
                   : launch<float, 64>(q, k, v, out, B, S, H, K, scale, s));
}
